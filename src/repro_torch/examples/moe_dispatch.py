"""Managed expert dispatch end to end (port of ``examples/moe_dispatch.py``).

    PYTHONPATH=src python -m repro_torch.examples.moe_dispatch
    PYTHONPATH=src python -m repro_torch.examples.moe_dispatch --device cpu \\
        --ranks 8

Runs on ``cuda`` unless ``--device cpu`` is given.  ``--ranks N`` starts
N processes joined by a gloo process group (on the CPU, or ranks that
share one card), the experts sharded by id over them (the ``model``
axis) and the sequence split between them.  With ``--device cpu --ranks
8`` it is the reference example.

Shows the MDMP workflow applied to the most data-dependent
communication, MoE token routing:
  1. declare the dispatch (``CommRegion.moe``) and let the region plan it
     from the alpha-beta model;
  2. run all three schedules — bulk all-to-all (the unmanaged baseline),
     chunked stream (capacity chunks passed around the EP ring under the
     expert FFN), dense fallback (no dispatch at all) — and check they
     agree; the capacity paths run the grouped-expert kernel on a card,
     and its launches are counted;
  3. instrument the routing (the paper's runtime read/write counters:
     token->expert histogram, drop rate, occupancy) and let the managed
     runtime re-pick the capacity factor from the measured imbalance —
     the iteration-(k)->(k+1) adaptation.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import cost_model, instrument, managed, transport
from repro_torch.core.region import CommRegion
from repro_torch.device import resolve_device
from repro_torch.kernels import grouped_matmul
from repro_torch.models import moe
from repro_torch.parallel.sharding import MeshCtx

E, K, D, F = 8, 2, 64, 128
B, S = 2, 256
SCHEDULES = (("bulk", 1), ("stream", 2), ("dense", 1))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _inputs(seed: int) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """The reference example's input and weights, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    params = {
        "w_router": rng.normal(size=(D, E)).astype(np.float32) * 0.5,
        "w1": rng.normal(size=(E, D, F)).astype(np.float32) * 0.1,
        "w1_gate": rng.normal(size=(E, D, F)).astype(np.float32) * 0.1,
        "w2": rng.normal(size=(E, F, D)).astype(np.float32) * 0.1,
    }
    return x, params


def base_config() -> ModelConfig:
    return ModelConfig(name="moe-demo", family="moe", n_layers=1,
                       d_model=D, n_heads=2, n_kv_heads=2, d_ff=0,
                       vocab_size=64, tp_multiple=1, dtype="float32",
                       moe=MoEConfig(n_experts=E, top_k=K, d_ff_expert=F,
                                     capacity_factor=2.0, impl="ep_a2a"))


def plan_region(tp: int):
    """Declare the dispatch and plan it: (region, plan)."""
    base = base_config()
    region = CommRegion("moe", axis_sizes={"model": tp})
    region.moe("dispatch", axis="model", tokens_local=B * S // tp,
               d_model=D, n_experts=E, top_k=K, d_ff_expert=F,
               dtype=torch.float32,
               capacity_factor=base.moe.capacity_factor)
    plan = region.plan(lambda a: a * 2, np.zeros(4, np.float32))
    return region, plan


def run(rank: int, ranks: int, args: argparse.Namespace,
        init: str | None = None) -> dict | None:
    """One rank of the example.  Returns the gathered outputs, the
    routing record and the grouped launches on rank 0."""
    dev = resolve_device(args.device)
    group = None
    if ranks > 1:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=ranks)
        group = dist.group.WORLD
    try:
        return _run(rank, ranks, args, dev, group)
    finally:
        if ranks > 1:
            dist.destroy_process_group()


def _run(rank, ranks, args, dev, group):
    tp = ranks
    say = print if rank == 0 else (lambda *a, **k: None)
    ctx = MeshCtx({"data": 1, "model": tp}, mdmp_mode="bulk",
                  coords={"model": rank},
                  groups={"model": group} if tp > 1 else {})
    base = base_config()
    x, params = _inputs(args.seed)
    s_loc, e_loc = S // tp, E // tp
    x_loc = torch.from_numpy(
        x[:, rank * s_loc:(rank + 1) * s_loc].copy()).to(dev)
    p_loc = {k: torch.from_numpy(
        v if k == "w_router" else
        v[rank * e_loc:(rank + 1) * e_loc].copy()).to(dev)
        for k, v in params.items()}
    t_loc = B * S // tp

    # 1. declare + plan (the paper's Figure-4 workflow)
    _, plan = plan_region(tp)
    say(plan.summary())

    # 2. the three schedules agree
    outs, launches = {}, {}
    for disp, g in SCHEDULES:
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, dispatch=disp, dispatch_g=g))
        with torch.no_grad():
            moe.moe_block_ep(x_loc, p_loc, cfg, ctx)
            _sync(dev)
            n0 = grouped_matmul.GROUPED_LAUNCHES
            t0 = time.perf_counter()
            out = moe.moe_block_ep(x_loc, p_loc, cfg, ctx)[0]
            _sync(dev)
            dt = time.perf_counter() - t0
        launches[disp] = grouped_matmul.GROUPED_LAUNCHES - n0
        full = (torch.cat(transport.all_gather(out.contiguous(), group), 1)
                if tp > 1 else out)
        outs[disp] = full.cpu().numpy()
        say(f"  {disp:8s} {dt * 1e3:7.2f}ms  grouped-kernel launches "
            f"{launches[disp]}")
    if rank == 0:
        for disp in ("stream", "dense"):
            np.testing.assert_allclose(outs[disp], outs["bulk"], rtol=2e-4,
                                       atol=2e-5, err_msg=disp)
    say("  all three dispatch schedules allclose")

    # 3. instrument the routing, adapt the capacity factor
    logits = x.reshape(-1, D) @ params["w_router"]
    top_idx = np.argsort(-logits, axis=1)[:, :K]
    rec = instrument.capture_routing(
        "demo", top_idx, E,
        cost_model.moe_capacity(B * S, K, E, base.moe.capacity_factor))
    managed.clear_decision_log()
    d = managed.resolve_moe_dispatch(
        "model", tp, t_loc, D, E, K, F, dtype_bytes=4,
        capacity_factor=base.moe.capacity_factor,
        measured_imbalance=rec.imbalance, measured_drop_rate=rec.drop_rate)
    trail = managed.decision_log()[-1]
    say(f"routing instrumented: imbalance={rec.imbalance:.2f} "
        f"drop={rec.drop_rate:.2f} occupancy={rec.occupancy:.2f}")
    say(f"re-resolved: cf {base.moe.capacity_factor:g} -> "
        f"{d.capacity_factor:g}, schedule={d.schedule} g={d.g} "
        f"(trail: {trail.op}({trail.mode} g={trail.chunks}))")
    if rank != 0:
        return None
    return {"outs": outs, "routing": rec, "launches": launches,
            "decision": d}


def _worker(rank: int, ranks: int, args: argparse.Namespace,
            init: str) -> None:
    run(rank, ranks, args, init)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="gloo processes (the model axis)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.ranks < 1 or E % args.ranks or S % args.ranks:
        ap.error(f"--ranks {args.ranks} must divide {E} experts and "
                 f"{S} positions")
    if args.ranks == 1:
        run(0, 1, args)
        return
    tmp = tempfile.mkdtemp(prefix="moe_dispatch_")
    try:
        torch.multiprocessing.spawn(
            _worker, args=(args.ranks, args,
                           "file://" + os.path.join(tmp, "init")),
            nprocs=args.ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
