"""The port's MoE across ranks, held against the reference on the CPU.

The counterpart of tests/dist_suite/test_moe.py (which passes when run
alone) over gloo processes (file:// init): a group of 4 ranks and one of
8 start at once.

  * every dispatch schedule (bulk in bulk and in interleaved mode, stream
    with g = 2 and 4, dense) of ``moe_block_ep`` and
    ``moe_block_expert_tp`` over 4 ranks, uniform and skewed routing:
    loss within rtol 3e-5 and gradients (gathered to their global shapes)
    within rtol 5e-4 / atol 2e-5 of the reference's single-rank oracle,
    as the reference's test;
  * the eight-way expert-parallel stream (one expert per rank);
  * stream equal to bulk when a starved capacity factor drops tokens
    (loss rtol 1e-6, gradients rtol 1e-5 / atol 1e-7);
  * ``dispatch="auto"`` logs one moe_dispatch decision per layer call;
  * a reduced moonshot-v1-16b-a3b train step on the 2x2 mesh with the
    stream and the dense dispatch against the reference's 1x1 bulk step
    (loss rtol 1e-3, updated parameters rtol 2e-3 / atol 3e-4);
  * ``managed_expert_stream`` (g = 1, 2) and
    ``managed_psum_scatter_gather`` (bulk, interleaved) over 4 ranks
    against the reference run in a subprocess with four host devices:
    outputs and gradients at f32 rtol 1e-5, DecisionRecords equal.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import moe as ref_moe
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import smap

ROOT = pathlib.Path(__file__).resolve().parents[1]
E_EP, E_TP, K, D, F = 8, 6, 2, 16, 32
#: (dispatch, g, mode) of every schedule the oracle test runs
VARIANTS = [("bulk", 0, "bulk"), ("bulk", 0, "interleaved"),
            ("stream", 2, "bulk"), ("stream", 4, "bulk"),
            ("dense", 0, "bulk")]
#: (impl, n_experts, skew) of the oracle test
ORACLE = [(impl, n, skew) for impl, n in (("ep_a2a", E_EP),
                                          ("expert_tp", E_TP))
          for skew in (0.0, 3.0)]
TRAIN_DISPATCH = ("stream", "dense")
LR = 1e-2
N_AUTO = 3


def _cfg_kwargs(n_experts, impl, disp, g, cf):
    return dict(name="t", family="moe", n_layers=1, d_model=D, n_heads=2,
                n_kv_heads=2, d_ff=0, vocab_size=64, tp_multiple=1,
                dtype="float32"), dict(n_experts=n_experts, top_k=K,
                                       d_ff_expert=F, capacity_factor=cf,
                                       impl=impl, dispatch=disp,
                                       dispatch_g=g)


def _params(n_experts, skew=0.0, seed=0):
    rng = np.random.default_rng(seed)
    p = {
        "w_router": rng.normal(size=(D, n_experts)).astype(np.float32),
        "w1": rng.normal(size=(n_experts, D, F)).astype(np.float32) * 0.1,
        "w1_gate": (rng.normal(size=(n_experts, D, F)).astype(np.float32)
                    * 0.1),
        "w2": rng.normal(size=(n_experts, F, D)).astype(np.float32) * 0.1,
    }
    if skew:
        p["w_router"][:, 0] += skew
    return p


def _x_global():
    rng = np.random.default_rng(1)
    return rng.normal(size=(2, 32, D)).astype(np.float32)


def _block_cases():
    """name -> (impl, n_experts, skew, dispatch, g, cf, mode) of every
    block run on the 4-rank group."""
    out = {}
    for impl, n, skew in ORACLE:
        cf = 16.0 if skew else 8.0
        for disp, g, mode in VARIANTS:
            out[f"{impl}_{skew}_{disp}{g}_{mode}"] = (impl, n, skew, disp,
                                                      g, cf, mode)
    out["drop_bulk"] = ("ep_a2a", E_EP, 4.0, "bulk", 0, 1.0, "bulk")
    for g in (2, 4):
        out[f"drop_stream{g}"] = ("ep_a2a", E_EP, 4.0, "stream", g, 1.0,
                                  "bulk")
    for i in range(N_AUTO):
        out[f"auto{i}"] = ("ep_a2a", E_EP, 0.0, "auto", 0, 8.0, "auto")
    return out


# ---------------------------------------------------------------------------
# the reference's single-rank oracle (in this process)
# ---------------------------------------------------------------------------


def _ref_loss_and_grads(impl, n_experts, skew, cf):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ctx = RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk")
    kw, mkw = _cfg_kwargs(n_experts, impl, "bulk", 0, cf)
    cfg = RefModelConfig(**kw, moe=RefMoEConfig(**mkw))
    block = (ref_moe.moe_block_ep if impl == "ep_a2a"
             else ref_moe.moe_block_expert_tp)

    def body(pp, xx):
        def local_loss(pp):
            y, _ = block(xx, pp, cfg, ctx)
            return jnp.sum(y * y)
        return jax.value_and_grad(local_loss)(pp)

    spec = {k: P() for k in ("w_router", "w1", "w1_gate", "w2")}
    fn = jax.jit(smap(body, mesh, in_specs=(spec, P()),
                      out_specs=(P(), spec)))
    params = {k: jnp.asarray(v) for k, v in
              _params(n_experts, skew).items()}
    loss, grads = fn(params, jnp.asarray(_x_global()))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


# ---------------------------------------------------------------------------
# the port, per rank
# ---------------------------------------------------------------------------


def _shard(name, arr, impl, r, n):
    """Rank r's block of a global MoE weight (the reference's pspecs)."""
    if name == "w_router":
        return arr
    if impl == "ep_a2a":                  # experts sharded by id
        e = arr.shape[0] // n
        return arr[r * e:(r + 1) * e]
    f = F // n                            # every expert ff-sharded
    return (arr[:, :, r * f:(r + 1) * f] if name in ("w1", "w1_gate")
            else arr[:, r * f:(r + 1) * f])


def _unshard(name, parts, impl):
    if name == "w_router":
        return parts[0]
    if impl == "ep_a2a":
        return np.concatenate(parts, axis=0)
    return np.concatenate(parts, axis=2 if name in ("w1", "w1_gate")
                          else 1)


def port_block(case, rank, n, group):
    """One block case on this rank: (summed loss, gathered gradients,
    the decisions' ops)."""
    import torch

    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.core import managed, transport
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import MeshCtx

    impl, n_experts, skew, disp, g, cf, mode = case
    ctx = MeshCtx({"data": 1, "model": n}, mdmp_mode=mode,
                  coords={"model": rank}, groups={"model": group})
    kw, mkw = _cfg_kwargs(n_experts, impl, disp, g, cf)
    cfg = ModelConfig(**kw, moe=MoEConfig(**mkw))
    full = _params(n_experts, skew)
    leaves = {k: torch.from_numpy(
        np.ascontiguousarray(_shard(k, v, impl, rank, n))).requires_grad_()
        for k, v in full.items()}
    x = _x_global()
    s_loc = x.shape[1] // n
    x_loc = torch.from_numpy(x[:, rank * s_loc:(rank + 1) * s_loc].copy())
    block = moe.moe_block_ep if impl == "ep_a2a" else moe.moe_block_expert_tp
    with managed.capture_decisions() as cap:
        y, _ = block(x_loc, leaves, cfg, ctx)
        loss = (y * y).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    total = float(transport.all_reduce(loss.detach(), group))
    out = {}
    for k, gr in zip(leaves, grads):
        if k == "w_router":
            gr = transport.all_reduce(gr, group)
        out[k] = _unshard(k, [p.numpy() for p in
                              transport.all_gather(gr.contiguous(), group)],
                          impl)
    return total, out, [r.op for r in cap.records]


def port_train(rank, world, inputs):
    """The reduced moonshot train step on the 2x2 mesh, per dispatch:
    (loss, gathered updated parameters)."""
    import torch

    from repro_torch import bridge, configs
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import MeshCtx
    from repro_torch.train.train_loop import build_train_step

    mesh = launch_mesh.make_mesh((2, 2), ("data", "model"), "cpu")
    data = np.load(inputs, allow_pickle=True)
    params = data["params"].item()
    batch = {k: torch.from_numpy(v) for k, v in data["batch"].item().items()}
    res = {}
    for disp in TRAIN_DISPATCH:
        base = dataclasses.replace(configs.get_reduced("moonshot-v1-16b-a3b"),
                                   dtype="float32")
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=16.0, dispatch=disp))
        model = bridge.params_from_numpy(
            params, Model(cfg, MeshCtx.from_mesh(mesh, "auto"),
                          device="cpu"))
        step = build_train_step(model, AdamWConfig(lr=LR))
        _, metrics = step(adamw_init(model.params(), AdamWConfig()), batch)
        res[f"{disp}_loss"] = float(metrics["loss"])
        for k, v in flatten_specs(bridge.params_to_numpy_full(model)).items():
            res[f"{disp}/{k}"] = v
    return res


# -- the managed collectives, per rank (and in the reference) ---------------

STREAM_E, STREAM_C, STREAM_D = 8, 4, 3
COLLECTIVES = [("expert_stream_g1", "expert_stream", 1),
               ("expert_stream_g2", "expert_stream", 2),
               ("psum_sg_bulk", "psum_scatter_gather", "bulk"),
               ("psum_sg_interleaved", "psum_scatter_gather", "interleaved")]


def collective_inputs(n):
    """Stacked per-rank inputs of the collective cases."""
    rng = np.random.default_rng(11)
    return {
        "buffers": rng.normal(size=(n, STREAM_E, STREAM_C, STREAM_D))
        .astype(np.float32),
        "counts": rng.integers(0, STREAM_C + 1, size=(n, STREAM_E))
        .astype(np.int32),
        "w": rng.normal(size=(n, STREAM_E // n, STREAM_D, STREAM_D))
        .astype(np.float32),
        "cot": rng.normal(size=(n, STREAM_E, STREAM_C, STREAM_D))
        .astype(np.float32),
        "x": rng.normal(size=(n, 8, 3)).astype(np.float32),
        "xcot": rng.normal(size=(n, 8, 3)).astype(np.float32),
    }


def _records(recs):
    return np.array([f"{r.op}:{r.mode}:{r.chunks}:{r.nbytes}"
                     for r in recs])


def port_collectives(rank, n, group):
    import torch

    from repro_torch.core import cost_model, managed
    from repro_torch.parallel.sharding import MeshCtx

    ctx = MeshCtx({"x": n}, coords={"x": rank}, groups={"x": group})
    ins = {k: torch.from_numpy(v[rank].copy())
           for k, v in collective_inputs(n).items()}
    res = {}
    with managed.use_config(managed.MDMPConfig(hw=cost_model.TPU_V5E)):
        for name, op, arg in COLLECTIVES:
            with managed.capture_decisions() as cap:
                if op == "expert_stream":
                    buf = ins["buffers"].clone().requires_grad_()
                    w = ins["w"].clone().requires_grad_()

                    def expert_fn(blk, valid, w=w):
                        rows = torch.arange(blk.shape[1])[None, :, None]
                        return (torch.einsum("ecd,edf->ecf", blk, w)
                                * (rows < valid[:, None, None]))
                    out = managed.managed_expert_stream(
                        buf, ins["counts"], "x", ctx, expert_fn, g=arg)
                    leaves = [buf, w]
                    cot = ins["cot"]
                else:
                    x = ins["x"].clone().requires_grad_()
                    out = managed.managed_psum_scatter_gather(x, "x", ctx,
                                                              mode=arg)
                    leaves = [x]
                    cot = ins["xcot"]
                grads = torch.autograd.grad((out * cot).sum(), leaves)
            res[f"{name}_out"] = out.detach().numpy()
            for i, gr in enumerate(grads):
                res[f"{name}_d{i}"] = gr.numpy()
            res[f"{name}_records"] = _records(cap.records)
    return res


def reference_collectives(out_dir, n=4):
    from repro.core import managed

    mesh = jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])
    ins = collective_inputs(n)
    res = {}
    for name, op, arg in COLLECTIVES:
        if op == "expert_stream":
            def body(buf, cnt, w, cot, arg=arg):
                def loss(buf, w):
                    def expert_fn(blk, valid):
                        rows = jnp.arange(blk.shape[1])[None, :, None]
                        return (jnp.einsum("ecd,edf->ecf", blk, w)
                                * (rows < valid[:, None, None]))
                    out = managed.managed_expert_stream(
                        buf, cnt, "x", expert_fn, g=arg)
                    return jnp.sum(out * cot), out
                (g_buf, g_w), out = jax.grad(loss, argnums=(0, 1),
                                             has_aux=True)(buf[0], w[0])
                return out[None], g_buf[None], g_w[None]
            args = [ins[k] for k in ("buffers", "counts", "w", "cot")]
        else:
            def body(x, cot, arg=arg):
                def loss(x):
                    out = managed.managed_psum_scatter_gather(x, "x",
                                                              mode=arg)
                    return jnp.sum(out * cot[0]), out
                g_x, out = jax.grad(loss, has_aux=True)(x[0])
                return out[None], g_x[None]
            args = [ins["x"], ins["xcot"]]
        managed.clear_decision_log()
        outs = jax.jit(smap(body, mesh, in_specs=(P("x"),) * len(args),
                            out_specs=(P("x"),) * (3 if op ==
                                                   "expert_stream" else 2)))(
            *[jnp.asarray(a) for a in args])
        res[f"{name}_out"] = np.asarray(outs[0])
        for i, gr in enumerate(outs[1:]):
            res[f"{name}_d{i}"] = np.asarray(gr)
        res[f"{name}_records"] = _records(managed.decision_log())
    np.savez(f"{out_dir}/ref_collectives.npz", **res)


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
import test_torch_moe_parallel as t

rank, world, init, out, inputs = int(sys.argv[1]), int(sys.argv[2]), \\
    sys.argv[3], sys.argv[4], sys.argv[5]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=world)
res = {{}}
if world == 8:
    loss, grads, _ = t.port_block(
        ("ep_a2a", t.E_EP, 0.0, "stream", 2, 8.0, "bulk"), rank, 8,
        dist.group.WORLD)
    res["eight_loss"] = loss
    res.update({{f"eight/{{k}}": v for k, v in grads.items()}})
else:
    for name, case in t._block_cases().items():
        loss, grads, ops = t.port_block(case, rank, world, dist.group.WORLD)
        res[f"{{name}}_loss"] = loss
        res[f"{{name}}_ops"] = np.array(ops)
        res.update({{f"{{name}}/{{k}}": v for k, v in grads.items()}})
    res.update(t.port_collectives(rank, world, dist.group.WORLD))
    res.update(t.port_train(rank, world, inputs))
if rank == 0:
    np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
"""

REF_SCRIPT = """
import sys
sys.path.insert(0, {tests!r})
import test_torch_moe_parallel as t
t.reference_collectives(sys.argv[1])
"""


def _ref_train(params0, batch):
    from repro import configs as ref_configs
    from repro.models.model import Model
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.train.train_loop import build_train_step
    cfg = dataclasses.replace(ref_configs.get_reduced("moonshot-v1-16b-a3b"),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0, dispatch="bulk"))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = Model(cfg, RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk"))
    step_fn, pshard, bshard = build_train_step(model, AdamWConfig(lr=LR),
                                               mesh, donate=False)
    params = jax.tree.map(lambda a, s: jax.device_put(np.asarray(a), s),
                          params0, pshard)
    b = {k: jax.device_put(v, bshard[k]) for k, v in batch.items()}
    p2, _, m = step_fn(params, adamw_init(params, AdamWConfig()), b)
    return float(m["loss"]), jax.tree.map(np.asarray, p2)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(tree[k])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the 4- and 8-rank groups and the reference subprocess, then
    compute the reference's single-rank oracles meanwhile."""
    from repro import configs as ref_configs
    from repro.data.pipeline import DataConfig, SyntheticLMData
    from repro.models.model import Model

    tmp = tmp_path_factory.mktemp("moe_parallel")
    cfg = dataclasses.replace(ref_configs.get_reduced("moonshot-v1-16b-a3b"),
                              dtype="float32")
    mesh1 = jax.make_mesh((1, 1), ("data", "model"))
    params0 = jax.tree.map(np.asarray, Model(
        cfg, RefMeshCtx.from_mesh(mesh1)).init(jax.random.key(0)))
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       global_batch=4)).global_batch_at(0)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, params=np.array(params0, dtype=object),
             batch=np.array(batch, dtype=object))
    (tmp / "worker.py").write_text(WORKER.format(tests=str(ROOT / "tests")))
    (tmp / "ref.py").write_text(REF_SCRIPT.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stderr=subprocess.PIPE, text=True)]
    for world in (4, 8):
        procs += [subprocess.Popen(
            [sys.executable, str(tmp / "worker.py"), str(r), str(world),
             "file://" + str(tmp / f"init{world}"),
             str(tmp / f"port{world}.npz"), str(inputs)], env=env,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        ref = {"train": _ref_train(params0, batch)}
        for impl, n, skew in ORACLE:
            ref[(impl, skew)] = _ref_loss_and_grads(impl, n, skew,
                                                    16.0 if skew else 8.0)
        ref[("ep_a2a", 0.0, 8.0)] = ref[("ep_a2a", 0.0)]
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    port = {w: dict(np.load(tmp / f"port{w}.npz")) for w in (4, 8)}
    port["ref_collectives"] = dict(np.load(tmp / "ref_collectives.npz"))
    return ref, port


def _grads(port, name):
    return {k: port[f"{name}/{k}"] for k in ("w_router", "w1", "w1_gate",
                                             "w2")}


@pytest.mark.parametrize("impl,n_experts,skew", ORACLE)
def test_schedules_match_single_rank_oracle(runs, impl, n_experts, skew):
    """4-way bulk (both modes) == stream (g 2, 4) == dense == the
    reference's single-rank oracle for loss and gradients, uniform and
    skewed routing (capacity ample: nothing drops)."""
    ref, port = runs[0], runs[1][4]
    l_ref, g_ref = ref[(impl, skew)]
    for disp, g, mode in VARIANTS:
        name = f"{impl}_{skew}_{disp}{g}_{mode}"
        np.testing.assert_allclose(port[f"{name}_loss"], l_ref, rtol=3e-5,
                                   err_msg=name)
        for k, got in _grads(port, name).items():
            np.testing.assert_allclose(got, g_ref[k], rtol=5e-4, atol=2e-5,
                                       err_msg=f"{name} {k}")


def test_ep_stream_eight_way(runs):
    """The full 8-rank EP ring (one expert per rank): the streamed
    dispatch reproduces the oracle through a whole ring cycle."""
    ref, port = runs[0], runs[1][8]
    l_ref, g_ref = ref[("ep_a2a", 0.0)]
    np.testing.assert_allclose(port["eight_loss"], l_ref, rtol=3e-5)
    for k, got in _grads(port, "eight").items():
        np.testing.assert_allclose(got, g_ref[k], rtol=5e-4, atol=2e-5,
                                   err_msg=k)


def test_stream_equals_bulk_under_capacity_drops(runs):
    """A starved capacity factor with skewed routing drops tokens; stream
    and bulk share the dispatch bookkeeping, so they agree (loss and
    gradients) though neither matches the drop-free oracle."""
    port = runs[1][4]
    for g in (2, 4):
        name = f"drop_stream{g}"
        np.testing.assert_allclose(port[f"{name}_loss"],
                                   port["drop_bulk_loss"], rtol=1e-6)
        for k, got in _grads(port, name).items():
            np.testing.assert_allclose(got, port[f"drop_bulk/{k}"],
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"g={g} {k}")
    # the starved capacity really drops assignments on some rank
    from repro.core import cost_model as ref_cm
    p = _params(E_EP, skew=4.0)
    x = _x_global()
    cap = ref_cm.moe_capacity(16, K, E_EP, 1.0)
    dropped = 0
    for r in range(4):
        logits = x[:, r * 8:(r + 1) * 8].reshape(-1, D) @ p["w_router"]
        top = np.argsort(-logits, axis=1)[:, :K].ravel()
        dropped += int(np.maximum(np.bincount(top, minlength=E_EP) - cap,
                                  0).sum())
    assert dropped > 0


def test_auto_logs_decision_per_layer(runs):
    """dispatch='auto' routes through resolve_moe_dispatch and logs one
    moe_dispatch decision per layer call."""
    port = runs[1][4]
    for i in range(N_AUTO):
        ops = list(port[f"auto{i}_ops"])
        assert ops.count("moe_dispatch") == 1, ops


@pytest.mark.parametrize("disp", TRAIN_DISPATCH)
def test_train_step_dispatch_equivalence(runs, disp):
    """Reduced moonshot on the 2x2 mesh: a streamed (and a dense) train
    step equals the single-rank bulk step, loss and updated parameters,
    through the whole stack (remat, FSDP gathers, the managed dispatch's
    backward, AdamW)."""
    ref, port = runs[0], runs[1][4]
    l_ref, p_ref = ref["train"]
    np.testing.assert_allclose(port[f"{disp}_loss"], l_ref, rtol=1e-3)
    for name, want in _flat(p_ref).items():
        np.testing.assert_allclose(port[f"{disp}/{name}"], want, rtol=2e-3,
                                   atol=3e-4, err_msg=f"{disp} {name}")


@pytest.mark.parametrize("name", [c[0] for c in COLLECTIVES])
def test_collective_matches_reference(runs, name):
    """managed_expert_stream and managed_psum_scatter_gather over 4
    ranks: rank 0's output and gradients at f32 rtol 1e-5 of the
    reference's, and its DecisionRecords (op, mode, chunks, nbytes)."""
    ref, port = runs[1]["ref_collectives"], runs[1][4]
    keys = [k for k in ref if k.startswith(name + "_")
            and not k.endswith("_records")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k][0], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want = list(ref[f"{name}_records"])
    assert want and list(port[f"{name}_records"]) == want
