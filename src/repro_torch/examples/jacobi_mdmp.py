"""The paper's running example on the port: a 2-D Jacobi sweep with
MDMP-managed halo exchange (port of ``examples/jacobi_mdmp.py``).

    PYTHONPATH=src python -m repro_torch.examples.jacobi_mdmp
    PYTHONPATH=src python -m repro_torch.examples.jacobi_mdmp --device cpu \\
        --ranks 8

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--ranks N`` starts
N processes joined by a process group (gloo: on the CPU, or ranks that
share one card, whose halo messages then pass through host buffers), the
rows of the global grid split over them.  With ``--device cpu --ranks
8`` it is the reference example: a 1024 x 514 grid, 48 sweeps.

  1. declare the communication (``CommRegion`` directives) and let the
     region instrument the per-shard stencil — the kernel, run once on
     meta specs, so the walk allocates and launches nothing — and plan
     each message, including the AGGREGATION knob: how many sweeps one
     k-row halo slab should carry (``managed.resolve_halo_aggregation``,
     whose DecisionRecord lands in the trail);
  2. run all three schedules — bulk (paper Fig 2), intermingled (Fig 3)
     and aggregated (k sweeps per exchange) — and check they agree, and
     that they equal one rank's solve of the whole grid;
  3. run the stencil kernels on a single shard (on the CPU, their plain
     versions).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import halo, instrument, managed, transport
from repro_torch.core.region import CommRegion
from repro_torch.device import resolve_device
from repro_torch.kernels import stencil

MODES = ("bulk", "interleaved", "aggregated")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(rank: int, ranks: int, args: argparse.Namespace,
        init: str | None = None) -> dict[str, np.ndarray] | None:
    """One rank of the example.  Returns the global results on rank 0."""
    dev = resolve_device(args.device)
    group = None
    if ranks > 1:
        torch.set_num_threads(1)
        # gloo: NCCL refuses two ranks on one card
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=ranks)
        group = dist.group.WORLD
    try:
        return _run(rank, ranks, args, dev, group)
    finally:
        if ranks > 1:
            dist.destroy_process_group()


def shard_compute(u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """The per-shard stencil the halos must overlap with: one
    ``jacobi_step`` kernel launch."""
    return stencil.jacobi_step(u, f)


def plan_region(ranks: int, rows: int, n: int):
    """Declare the halo exchange and plan it (the paper's ``#pragma
    commregion`` block): (region, plan)."""
    region = CommRegion("jacobi", axis_sizes={"x": ranks})
    region.send("halo_up", axis="x", shape=(n,), dtype=torch.float32)
    region.send("halo_down", axis="x", shape=(n,), dtype=torch.float32)
    region.halo("halo_agg", axis="x", rows_local=rows, cols=n,
                dtype=torch.float32)
    local = instrument.Spec((rows, n), torch.float32)
    plan = region.plan(
        shard_compute, local, local,
        compute_time_s=5.0 * rows * n / managed.get_config().hw.peak_flops)
    return region, plan


def _run(rank, ranks, args, dev, group):
    m, n, iters = args.m, args.n, args.iters
    rng = np.random.default_rng(args.seed)
    u0 = rng.normal(size=(m, n)).astype(np.float32)
    f = rng.normal(size=(m, n)).astype(np.float32)
    rows = m // ranks
    u_loc = torch.from_numpy(u0[rank * rows:(rank + 1) * rows]).to(dev)
    f_loc = torch.from_numpy(f[rank * rows:(rank + 1) * rows]).to(dev)
    say = print if rank == 0 else (lambda *a, **k: None)

    # 1. declare + plan
    _, plan = plan_region(ranks, rows, n)
    say(f"{m} x {n} grid, rows split over {ranks} rank(s) on {dev}, "
        f"{iters} sweeps")
    say(plan.summary())
    k = plan.k_for("halo_agg")
    agg = plan.entries["halo_agg"]
    say(f"cost model ({managed.get_config().hw.name}) chose k={k}: one "
        f"{k}-row halo slab per {k} sweeps (messages / sweep drop 2 -> "
        f"{2.0 / k:.3f}); predicted {agg.predicted_bulk_s * 1e6:.2f} us "
        f"per sweep bulk, {agg.predicted_interleaved_s * 1e6:.2f} us "
        f"aggregated")
    say("decision trail:", managed.decision_log()[-1])

    # 2. the three schedules
    outs = {}
    for mode in MODES:
        kk = k if mode == "aggregated" else 1
        halo.jacobi_solve(u_loc, f_loc, group, iters, mode, k=kk)
        _sync(dev)
        t0 = time.perf_counter()
        out = halo.jacobi_solve(u_loc, f_loc, group, iters, mode, k=kk)
        _sync(dev)
        dt = time.perf_counter() - t0
        name = f"aggregated_k{kk}" if mode == "aggregated" else mode
        say(f"{name:16s} {iters} sweeps in {dt:.3f}s")
        outs[name] = torch.cat(transport.all_gather(out, group)
                               if ranks > 1 else [out]).cpu().numpy()
    if rank != 0:
        return None
    for name, out in outs.items():
        np.testing.assert_allclose(outs["bulk"], out, rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    say("bulk (Fig 2) == intermingled (Fig 3) == aggregated: max diff",
        max(float(np.abs(outs["bulk"] - o).max()) for o in outs.values()))
    if ranks > 1:
        one = halo.jacobi_solve(torch.from_numpy(u0).to(dev),
                                torch.from_numpy(f).to(dev), None, iters,
                                "bulk").cpu().numpy()
        np.testing.assert_allclose(outs["bulk"], one, rtol=1e-5, atol=1e-5)
        say(f"{ranks} ranks == one rank over the whole grid: max diff "
            f"{float(np.abs(outs['bulk'] - one).max())}; bytes copied "
            f"between the card and host memory by this rank (gloo): "
            f"{transport.staged_bytes()}")

    # 3. the stencil kernels on a single shard (+2 Dirichlet rows)
    u_sh = torch.from_numpy(u0[:rows + 2]).to(dev)
    f_sh = torch.from_numpy(f[:rows + 2]).to(dev)
    one = stencil.jacobi_step(u_sh, f_sh)
    multi = stencil.jacobi_multistep(u_sh, f_sh, k=k)
    want = u_sh
    for _ in range(k):
        want = stencil.jacobi_step(want, f_sh)
    torch.testing.assert_close(multi, want, rtol=1e-6, atol=1e-6)
    say(f"stencil kernel ok: {tuple(one.shape)}; {k}-sweep "
        f"temporally-blocked kernel == {k} unit sweeps: "
        f"{tuple(multi.shape)}")
    return outs


def _worker(rank: int, ranks: int, args: argparse.Namespace,
            init: str) -> None:
    run(rank, ranks, args, init)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, one rank) or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo processes on the CPU")
    ap.add_argument("--m", type=int, default=1024, help="global rows")
    ap.add_argument("--n", type=int, default=514, help="columns")
    ap.add_argument("--iters", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.ranks < 1 or args.m % args.ranks:
        ap.error(f"--ranks {args.ranks} must divide --m {args.m}")
    if args.ranks == 1:
        run(0, 1, args)
        return
    tmp = tempfile.mkdtemp(prefix="jacobi_mdmp_")
    try:
        torch.multiprocessing.spawn(
            _worker, args=(args.ranks, args,
                           "file://" + os.path.join(tmp, "init")),
            nprocs=args.ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
