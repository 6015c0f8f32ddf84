"""The port's halo exchange and Jacobi solve (core/halo.py) over gloo
process groups on the CPU, held against the reference's.

For 1, 2 and 4 ranks one set of processes (file:// init) runs every case
and writes its row block of each result; the tests assemble the global
arrays and compare:

  * the deep-halo exchange at h in {1, 2, 3}, periodic and not, against
    the ``np.roll`` and zero-slab oracles of
    tests/dist_suite/test_halo.py (exact);
  * ``jacobi_solve`` in every mode (bulk, interleaved, aggregated at k in
    {1, 2, 4}), periodic and not, 7 and 8 sweeps (remainder sweeps at
    k=2 and 4), against the reference's ``jacobi_solve`` under
    ``shard_map`` on a one-device mesh over the global grid, within
    rtol = atol = 1e-5 (as tests/dist_suite/test_halo.py).  A single-rank
    solve of the global grid is the row-decomposed solve (zero slabs at a
    non-periodic edge, the wrapped rows on a ring).

Two ranks on a ring get both halos from the same peer, where message
matching is most likely to go wrong.  The same cases also run in this
process with ``group=None``."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core import halo as ref_halo
from repro.parallel.sharding import smap
from repro_torch.core import halo

ROOT = pathlib.Path(__file__).resolve().parents[1]
EX_SHAPE = (24, 6)          # exchange grid: 6 rows per rank at 4 ranks
SOLVE_SHAPE = (32, 34)      # solve grid: 8 rows per rank at 4 ranks
SCHEDULES = [("bulk", 1), ("interleaved", 1), ("aggregated", 1),
             ("aggregated", 2), ("aggregated", 4)]
RANKS = [1, 2, 4]


def _grids():
    ex = np.random.default_rng(42).normal(size=EX_SHAPE).astype(np.float32)
    rng = np.random.default_rng(3)
    u = rng.normal(size=SOLVE_SHAPE).astype(np.float32)
    f = rng.normal(size=SOLVE_SHAPE).astype(np.float32)
    return ex, u, f


def _run_cases(rank, ranks, group):
    """Every case on this rank's row blocks: name -> local result."""
    ex, u, f = _grids()
    out = {}
    rows = EX_SHAPE[0] // ranks
    x = torch.from_numpy(ex[rank * rows:(rank + 1) * rows])
    for h in (1, 2, 3):
        for per in (False, True):
            lo, hi = halo.halo_exchange(x, group, halo=h, periodic=per)
            out[f"ex_h{h}_p{int(per)}"] = torch.cat([lo, hi]).numpy()
    rows = SOLVE_SHAPE[0] // ranks
    ul = torch.from_numpy(u[rank * rows:(rank + 1) * rows])
    fl = torch.from_numpy(f[rank * rows:(rank + 1) * rows])
    for mode, k in SCHEDULES:
        for per in (False, True):
            for iters in (7, 8):
                got = halo.jacobi_solve(ul, fl, group, iters, mode, k=k,
                                        periodic=per)
                out[f"{mode}_k{k}_p{int(per)}_i{iters}"] = got.numpy()
    return out


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
from test_torch_halo import _run_cases

rank, ranks, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=ranks)
np.savez(f"{{out}}/rank{{rank}}.npz",
         **_run_cases(rank, ranks, dist.group.WORLD))
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(ranks, tmp):
    """Run every case on ``ranks`` gloo processes; name -> the per-rank
    results in rank order."""
    script = tmp / "worker.py"
    script.write_text(WORKER.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    init = "file://" + str(tmp / "init")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(ranks), init, str(tmp)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in range(ranks)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    parts = [np.load(tmp / f"rank{r}.npz") for r in range(ranks)]
    return {name: [p[name] for p in parts] for name in parts[0].files}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """ranks -> case -> per-rank results; ``0`` is this process with
    ``group=None``."""
    out = {0: {k: [v] for k, v in _run_cases(0, 1, None).items()}}
    for ranks in RANKS:
        out[ranks] = _spawn(ranks, tmp_path_factory.mktemp(f"r{ranks}"))
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's solve of the global grid on a one-device mesh,
    computed once per case."""
    mesh = jax.make_mesh((1,), ("x",))
    _, u, f = _grids()
    cache = {}

    def solve(mode, k, periodic, iters):
        key = (mode, k, periodic, iters)
        if key not in cache:
            fn = jax.jit(smap(
                lambda a, b: ref_halo.jacobi_solve(a, b, "x", iters, mode,
                                                   k=k, periodic=periodic),
                mesh, in_specs=(P("x"), P("x")), out_specs=P("x")))
            cache[key] = np.asarray(fn(u, f))
        return cache[key]

    return solve


@pytest.mark.parametrize("ranks", [0] + RANKS,
                         ids=lambda r: "group_none" if r == 0 else
                         f"{r}_ranks")
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("h", [1, 2, 3])
def test_halo_exchange_matches_oracles(results, ranks, periodic, h):
    """periodic: rank i's lo halo is the previous rank's last h rows of the
    ring (np.roll), its hi halo the next rank's first h rows; not
    periodic: true neighbour rows inside, zero slabs at the edges."""
    got = results[ranks][f"ex_h{h}_p{int(periodic)}"]
    n = max(ranks, 1)
    grid = _grids()[0]
    local = EX_SHAPE[0] // n
    down, up = np.roll(grid, h, axis=0), np.roll(grid, -h, axis=0)
    for i, slab in enumerate(got):
        lo, hi = slab[:h], slab[h:]
        if periodic:
            want_lo = down[i * local:i * local + h]
            want_hi = up[(i + 1) * local - h:(i + 1) * local]
        else:
            want_lo = (np.zeros((h, EX_SHAPE[1]), np.float32) if i == 0
                       else grid[i * local - h:i * local])
            want_hi = (np.zeros((h, EX_SHAPE[1]), np.float32) if i == n - 1
                       else grid[(i + 1) * local:(i + 1) * local + h])
        np.testing.assert_array_equal(lo, want_lo, err_msg=f"rank {i} lo")
        np.testing.assert_array_equal(hi, want_hi, err_msg=f"rank {i} hi")


@pytest.mark.parametrize("ranks", [0] + RANKS,
                         ids=lambda r: "group_none" if r == 0 else
                         f"{r}_ranks")
@pytest.mark.parametrize("iters", [7, 8])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("mode,k", SCHEDULES,
                         ids=lambda v: str(v))
def test_jacobi_solve_matches_reference(results, reference, ranks, mode, k,
                                        periodic, iters):
    got = np.concatenate(results[ranks][f"{mode}_k{k}_p{int(periodic)}"
                                        f"_i{iters}"])
    want = reference(mode, k, periodic, iters)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_aggregation_factor_above_the_block_raises():
    u = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="exceeds the local block"):
        halo.jacobi_solve(u, u, None, 8, "aggregated", k=8)
    with pytest.raises(ValueError, match="schedule"):
        halo.jacobi_solve(u, u, None, 8, "pipelined")
    assert halo.jacobi_solve(u, u, None, 0, "bulk") is u


def test_example_runs_on_the_cpu_over_gloo():
    """The paper's example at a small size on 4 gloo ranks: the decision is
    logged and the three schedules agree."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.jacobi_mdmp", "--device",
         "cpu", "--ranks", "4", "--m", "64", "--n", "34", "--iters", "9"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "op='halo_aggregation'" in out.stdout
    assert "bulk (Fig 2) == intermingled (Fig 3) == aggregated" in \
        out.stdout
    assert "temporally-blocked kernel ==" in out.stdout
