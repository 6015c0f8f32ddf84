"""The port's managed collectives (core/managed.py) held against the
reference's, over 2 and 4 ranks on the CPU.

Every collective of the reference's table — all-gather, reduce-scatter,
all-reduce (a leading axis the ranks do not divide, and the 0-d bulk
fallback), all-to-all ((split, concat) = (0, 0), (0, 1), (1, 0)),
all-gather-matmul, its multi-weight form and matmul-reduce-scatter — runs
in bulk mode and as the ring with 1 and 2 chunks, with its gradients.
Each rank's loss is ``sum(out * cot)`` of its own output and its own
seeded cotangent; its gradients are that rank's (per-rank autodiff, as
inside the reference's ``shard_map``).

The port runs over gloo processes (file:// init, one spawn per rank
count, both at once); the reference runs in one subprocess with four
forced host devices, each case inside ``smap``.  Outputs and gradients
must agree at f32 rtol 1e-5 (atol 1e-6), and the DecisionRecords' (op,
mode, chunks, nbytes) must be equal (the port prices with the
reference's ``TPU_V5E`` here, so that its auto chunking is the
reference's).  The overlap helpers (``fsdp_gather`` along axis 1 and its
fp8 payload, ``bucketed_all_reduce`` of a mixed-dtype tree,
``reduce_replicated_grads``, ``fsdp_gather_tree``) ride in the same
processes; ``OverlapAccount`` and ``grad_accumulate`` are held to the
reference's in this one.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = [2, 4]
MODES = [("bulk", 1), ("interleaved", 1), ("interleaved", 2)]
A2A = [(0, 0), (0, 1), (1, 0)]


def _case_list():
    """(name, op, mode, chunks, extra) of every case."""
    out = []
    for op in ("all_gather", "reduce_scatter", "all_reduce",
               "all_gather_matmul", "all_gather_matmul_multi",
               "matmul_reduce_scatter"):
        for mode, chunks in MODES:
            out.append((f"{op}_{mode}_{chunks}", op, mode, chunks, None))
    out.append(("all_reduce_scalar", "all_reduce_scalar", "interleaved",
                None, None))
    for mode in ("bulk", "interleaved"):
        for split, concat in A2A:
            out.append((f"all_to_all_{mode}_{split}{concat}", "all_to_all",
                        mode, None, (split, concat)))
    return out


CASES = _case_list()


def _inputs(op, n, seed):
    """Stacked per-rank inputs {name: [n, *local]} and the stacked
    cotangent of the output(s)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=(n,) + shape).astype(np.float32)

    if op == "all_gather":
        return {"x": r(4, 6)}, [r(4 * n, 6)]
    if op == "reduce_scatter":
        return {"x": r(16, 6)}, [r(16 // n, 6)]
    if op == "all_reduce":
        return {"x": r(5, 3)}, [r(5, 3)]
    if op == "all_reduce_scalar":
        return {"x": r(2, 3)}, [r()]
    if op == "all_to_all":
        return {"x": r(8, 8, 3)}, None          # shape set by the case
    if op == "all_gather_matmul":
        return {"x": r(4, 6), "w": r(6, 5)}, [r(4 * n, 5)]
    if op == "all_gather_matmul_multi":
        return ({"x": r(4, 6), "w": r(6, 5), "w2": r(6, 3)},
                [r(4 * n, 5), r(4 * n, 3)])
    if op == "matmul_reduce_scatter":
        return {"x": r(16, 8 // n), "w": r(8 // n, 5)}, [r(16 // n, 5)]
    raise ValueError(op)


def _a2a_cot(n, split, concat, seed):
    shape = [8, 8, 3]
    shape[split] //= n
    shape[concat] *= n
    rng = np.random.default_rng(seed + 1000)
    return [rng.normal(size=(n,) + tuple(shape)).astype(np.float32)]


def case_data(n):
    """name -> (op, mode, chunks, extra, inputs, cots)."""
    out = {}
    for i, (name, op, mode, chunks, extra) in enumerate(CASES):
        ins, cots = _inputs(op, n, 100 * n + i)
        if op == "all_to_all":
            cots = _a2a_cot(n, *extra, 100 * n + i)
        out[name] = (op, mode, chunks, extra, ins, cots)
    return out


def _records(recs):
    return np.array([f"{r.op}:{r.mode}:{r.chunks}:{r.nbytes}"
                     for r in recs])


# ---------------------------------------------------------------------------
# the port, per rank
# ---------------------------------------------------------------------------


def _port_apply(managed, op, ins, ctx, mode, chunks, extra):
    if op == "all_gather":
        return [managed.managed_all_gather(ins["x"], "x", ctx, mode=mode,
                                           chunks=chunks)]
    if op == "reduce_scatter":
        return [managed.managed_reduce_scatter(ins["x"], "x", ctx,
                                               mode=mode, chunks=chunks)]
    if op == "all_reduce":
        return [managed.managed_all_reduce(ins["x"], "x", ctx, mode=mode,
                                           chunks=chunks)]
    if op == "all_reduce_scalar":
        return [managed.managed_all_reduce(ins["x"].sum(), "x", ctx,
                                           mode=mode)]
    if op == "all_to_all":
        return [managed.managed_all_to_all(ins["x"], "x", ctx,
                                           split_axis=extra[0],
                                           concat_axis=extra[1], mode=mode)]
    if op == "all_gather_matmul":
        return [managed.all_gather_matmul(ins["x"], ins["w"], "x", ctx,
                                          mode=mode, chunks=chunks)]
    if op == "all_gather_matmul_multi":
        return managed.all_gather_matmul_multi(
            ins["x"], [ins["w"], ins["w2"]], "x", ctx, mode=mode,
            chunks=chunks)
    return [managed.matmul_reduce_scatter(ins["x"], ins["w"], "x", ctx,
                                          mode=mode, chunks=chunks)]


def port_results(rank, ranks, group):
    """Every case on this rank: name_out{i}, name_d{input} and
    name_records, plus the overlap helpers' results."""
    import torch
    from repro_torch.core import cost_model, managed, overlap
    from repro_torch.parallel.sharding import MeshCtx

    ctx = MeshCtx({"x": ranks}, coords={"x": rank}, groups={"x": group})
    res = {}
    with managed.use_config(managed.MDMPConfig(hw=cost_model.TPU_V5E)):
        for name, (op, mode, chunks, extra, ins, cots) in \
                case_data(ranks).items():
            leaves = {k: torch.from_numpy(v[rank]).requires_grad_()
                      for k, v in ins.items()}
            with managed.capture_decisions() as cap:
                outs = _port_apply(managed, op, leaves, ctx, mode, chunks,
                                   extra)
                loss = sum((o * torch.as_tensor(c[rank])).sum()
                           for o, c in zip(outs, cots))
                grads = torch.autograd.grad(loss, list(leaves.values()))
            for i, o in enumerate(outs):
                res[f"{name}_out{i}"] = o.detach().numpy()
            for k, g in zip(leaves, grads):
                res[f"{name}_d{k}"] = g.numpy()
            res[f"{name}_records"] = _records(cap.records)
        res.update(_port_overlap(torch, managed, overlap, ctx, rank,
                                 ranks))
    return res


def _port_overlap(torch, managed, overlap, ctx, rank, ranks):
    rng = np.random.default_rng(7)
    w = rng.normal(size=(ranks, 6, 12 * ranks)).astype(np.float32)
    cot = rng.normal(size=(ranks, 6, 12 * ranks * ranks)).astype(np.float32)
    res = {}
    for mode in ("bulk", "interleaved"):
        leaf = torch.from_numpy(w[rank]).requires_grad_()
        full = overlap.fsdp_gather(leaf, "x", ctx, axis=1, mode=mode)
        (g,) = torch.autograd.grad((full * torch.from_numpy(cot[rank]))
                                   .sum(), [leaf])
        res[f"fsdp_{mode}_out"] = full.detach().numpy()
        res[f"fsdp_{mode}_grad"] = g.numpy()
    big = torch.from_numpy(rng.normal(size=(ranks, 256, 512))
                           .astype(np.float32)[rank])
    with managed.use_config(managed.MDMPConfig(
            fsdp_gather_dtype="float8_e4m3fn")):
        res["fsdp_fp8_out"] = overlap.fsdp_gather(big, "x", ctx).numpy()
    # values a bf16 cast destroys: buckets must keep each leaf's type
    f32 = (1.0 + np.arange(24, dtype=np.float32) / 1024.0).reshape(4, 6)
    tree = {"a_bf16": torch.arange(8, dtype=torch.float32).bfloat16(),
            "b_f32": torch.from_numpy(f32)}
    out = overlap.bucketed_all_reduce(tree, "x", ctx, bucket_bytes=16)
    res["bucket_bf16"] = out["a_bf16"].float().numpy()
    res["bucket_f32"] = out["b_f32"].numpy()
    res["bucket_dtypes"] = np.array([str(out["a_bf16"].dtype),
                                     str(out["b_f32"].dtype)])
    red = overlap.reduce_replicated_grads(
        {"g": torch.full((3,), float(rank + 1))}, ("x",), ctx)
    res["replicated_mean"] = red["g"].numpy()
    tree = overlap.fsdp_gather_tree(
        {"big": torch.full((4, 300), float(rank)), "small": torch.ones(3)},
        "x", ctx)
    res["tree_big"] = tree["big"].numpy()
    res["tree_small"] = tree["small"].numpy()
    return res


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
from test_torch_collectives import port_results

rank, ranks, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=ranks)
np.savez(f"{{out}}/rank{{rank}}.npz",
         **port_results(rank, ranks, dist.group.WORLD))
dist.barrier()
dist.destroy_process_group()
"""


# ---------------------------------------------------------------------------
# the reference, in one subprocess with four host devices
# ---------------------------------------------------------------------------


def _ref_apply(managed, op, ins, mode, chunks, extra):
    if op == "all_gather":
        return [managed.managed_all_gather(ins["x"], "x", mode, chunks)]
    if op == "reduce_scatter":
        return [managed.managed_reduce_scatter(ins["x"], "x", mode, chunks)]
    if op == "all_reduce":
        return [managed.managed_all_reduce(ins["x"], "x", mode=mode,
                                           chunks=chunks)]
    if op == "all_reduce_scalar":
        return [managed.managed_all_reduce(ins["x"].sum(), "x", mode=mode)]
    if op == "all_to_all":
        return [managed.managed_all_to_all(ins["x"], "x", extra[0],
                                           extra[1], mode)]
    if op == "all_gather_matmul":
        return [managed.all_gather_matmul(ins["x"], ins["w"], "x", mode,
                                          chunks)]
    if op == "all_gather_matmul_multi":
        return managed.all_gather_matmul_multi(
            ins["x"], [ins["w"], ins["w2"]], "x", mode, chunks)
    return [managed.matmul_reduce_scatter(ins["x"], ins["w"], "x", mode,
                                          chunks)]


def reference_results(out_dir):
    """Every case at 2 and 4 devices through the reference; saves
    ref{n}.npz with the same names as the port's (outputs and gradients
    stacked by rank)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import managed
    from repro.parallel.sharding import smap

    for n in RANKS:
        mesh = jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])
        res = {}
        for name, (op, mode, chunks, extra, ins, cots) in \
                case_data(n).items():
            keys = list(ins)

            def body(*args, op=op, mode=mode, chunks=chunks, extra=extra,
                     keys=keys):
                local = [a[0] for a in args[:len(keys)]]
                cot = [c[0] for c in args[len(keys):]]

                def loss(*xs):
                    outs = _ref_apply(managed, op, dict(zip(keys, xs)),
                                      mode, chunks, extra)
                    return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), \
                        outs
                grads, outs = jax.grad(loss, argnums=tuple(
                    range(len(keys))), has_aux=True)(*local)
                return [o[None] for o in outs], [g[None] for g in grads]

            nargs = len(keys) + len(cots)
            managed.clear_decision_log()
            outs, grads = jax.jit(smap(
                body, mesh, in_specs=(P("x"),) * nargs,
                out_specs=([P("x")] * len(cots), [P("x")] * len(keys))))(
                *[jnp.asarray(v) for v in ins.values()],
                *[jnp.asarray(c) for c in cots])
            for i, o in enumerate(outs):
                res[f"{name}_out{i}"] = np.asarray(o)
            for k, g in zip(keys, grads):
                res[f"{name}_d{k}"] = np.asarray(g)
            res[f"{name}_records"] = _records(managed.decision_log())
        np.savez(f"{out_dir}/ref{n}.npz", **res)


REF_SCRIPT = """
import sys
sys.path.insert(0, {tests!r})
from test_torch_collectives import reference_results
reference_results(sys.argv[1])
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The reference subprocess and both rank counts' gloo processes run
    at once.  Returns (reference by n, port by n: name -> per-rank)."""
    tmp = tmp_path_factory.mktemp("collectives")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    (tmp / "ref.py").write_text(REF_SCRIPT.format(tests=str(ROOT / "tests")))
    ref_proc = subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stderr=subprocess.PIPE, text=True)
    procs = {}
    for n in RANKS:
        d = tmp / f"r{n}"
        d.mkdir()
        (d / "worker.py").write_text(WORKER.format(tests=str(ROOT / "tests")))
        procs[n] = [subprocess.Popen(
            [sys.executable, str(d / "worker.py"), str(r), str(n),
             "file://" + str(d / "init"), str(d)], env=env,
            stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        everyone = [ref_proc] + [p for ps in procs.values() for p in ps]
        errs = [p.communicate(timeout=240)[1] for p in everyone]
    finally:
        for p in [ref_proc] + [p for ps in procs.values() for p in ps]:
            p.kill()
    for p, err in zip(everyone, errs):
        assert p.returncode == 0, err[-4000:]
    ref = {n: dict(np.load(tmp / f"ref{n}.npz")) for n in RANKS}
    port = {}
    for n in RANKS:
        parts = [np.load(tmp / f"r{n}" / f"rank{r}.npz") for r in range(n)]
        port[n] = {k: [p[k] for p in parts] for k in parts[0].files}
    return ref, port


@pytest.mark.parametrize("name", [c[0] for c in CASES])
@pytest.mark.parametrize("ranks", RANKS)
def test_collective_matches_reference(results, ranks, name):
    """Outputs and gradients per rank at f32 rtol 1e-5; every rank logs
    the reference's DecisionRecords (op, mode, chunks, nbytes)."""
    ref, port = results[0][ranks], results[1][ranks]
    keys = [k for k in ref if k.startswith(name + "_")
            and not k.endswith("_records")
            and k[len(name) + 1:].startswith(("out", "d"))]
    assert keys
    for k in keys:
        got = np.stack(port[k])
        np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want = list(ref[f"{name}_records"])
    assert want
    for recs in port[f"{name}_records"]:
        assert list(recs) == want


def test_forced_ring_all_reduce_logs_its_schedule(results):
    """A leading axis the ranks do not divide keeps the forced ring
    (zero-padded), and a 0-d operand is logged as the bulk fallback."""
    for n in RANKS:
        port = results[1][n]
        recs = list(port["all_reduce_interleaved_1_records"][0])
        assert recs[0].startswith("all_reduce:interleaved:")
        assert any(r.startswith("reduce_scatter:interleaved:")
                   for r in recs)
        assert list(port["all_reduce_scalar_records"][0])[0].startswith(
            "all_reduce:bulk:")


@pytest.mark.parametrize("ranks", RANKS)
def test_overlap_helpers(results, ranks):
    """fsdp_gather along axis 1 equals the concatenated shards in both
    modes and its gradient is this rank's block of the summed cotangents;
    the fp8 payload is within its quantisation step; bucketed_all_reduce
    keeps each leaf's type (f32 exactly n times); the replicated mean."""
    port = results[1][ranks]
    rng = np.random.default_rng(7)
    w = rng.normal(size=(ranks, 6, 12 * ranks)).astype(np.float32)
    cot = rng.normal(size=(ranks, 6, 12 * ranks * ranks)).astype(np.float32)
    big = rng.normal(size=(ranks, 256, 512)).astype(np.float32)
    full = np.concatenate(list(w), axis=1)
    cols = 12 * ranks
    for mode in ("bulk", "interleaved"):
        for r in range(ranks):
            np.testing.assert_array_equal(port[f"fsdp_{mode}_out"][r], full)
            want = cot.sum(0)[:, r * cols:(r + 1) * cols]
            np.testing.assert_allclose(port[f"fsdp_{mode}_grad"][r], want,
                                       rtol=1e-5, atol=1e-5)
    scale = np.abs(big).max(axis=(1, 2)).max() / 448.0
    np.testing.assert_allclose(port["fsdp_fp8_out"][0],
                               np.concatenate(list(big)),
                               atol=16 * scale)
    f32 = (1.0 + np.arange(24, dtype=np.float32) / 1024.0).reshape(4, 6)
    for r in range(ranks):
        assert list(port["bucket_dtypes"][r]) == ["torch.bfloat16",
                                                  "torch.float32"]
        np.testing.assert_array_equal(port["bucket_f32"][r], f32 * ranks)
        np.testing.assert_allclose(port["bucket_bf16"][r],
                                   np.arange(8) * ranks, rtol=1e-2)
        np.testing.assert_allclose(port["replicated_mean"][r],
                                   (ranks + 1) / 2)
        # fsdp_gather_tree: the large leaf gathered on axis 0, the small
        # one (under min_size) passed through as replicated
        np.testing.assert_array_equal(
            port["tree_big"][r],
            np.repeat(np.arange(ranks, dtype=np.float32), 4)[:, None]
            * np.ones((1, 300), np.float32))
        np.testing.assert_array_equal(port["tree_small"][r], np.ones(3))


def test_overlap_account_matches_reference():
    """The pooled overlap budget hides wire time once: the same draws
    leave the same exposed remainders as the reference's."""
    from repro.core import overlap as ref_overlap
    from repro_torch.core import overlap

    ref, port = ref_overlap.OverlapAccount(1.5), overlap.OverlapAccount(1.5)
    for wire in (0.4, 0.0, 0.9, -0.2, 0.5, 2.0):
        assert port.draw(wire) == ref.draw(wire)
        assert port.remaining_s == ref.remaining_s


@pytest.mark.parametrize("mean", [True, False])
def test_grad_accumulate_matches_reference(mean):
    """Four stacked microbatches of a least-squares step: the mean loss
    and the mean (or summed) gradients equal the reference's scan."""
    import jax.numpy as jnp
    import torch

    from repro.core import overlap as ref_overlap
    from repro_torch.core import overlap

    rng = np.random.default_rng(5)
    xs = rng.normal(size=(4, 6, 3)).astype(np.float32)
    w = rng.normal(size=(3, 2)).astype(np.float32)

    def ref_step(mb):
        y = mb @ jnp.asarray(w)
        return jnp.sum(y * y), {"w": 2.0 * mb.T @ y}

    def port_step(mb):
        y = mb @ torch.from_numpy(w)
        return (y * y).sum(), {"w": 2.0 * mb.T @ y}

    want_l, want_g = ref_overlap.grad_accumulate(ref_step, 4, mean=mean)(
        jnp.asarray(xs))
    got_l, got_g = overlap.grad_accumulate(port_step, 4, mean=mean)(
        torch.from_numpy(xs))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    np.testing.assert_allclose(got_g["w"].numpy(), np.asarray(want_g["w"]),
                               rtol=1e-5, atol=1e-6)
