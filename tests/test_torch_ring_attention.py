"""Ring attention (context parallelism) in the port, held against the
reference on the CPU.

  * the plain carry step ``flash_attention_step_torch`` against the
    reference's jnp engine ``ops._flash_step_jnp`` and its Pallas carry
    kernel in interpret mode, at offsets (64, 32), empty and carried
    state, causal or not, a window, GQA and ragged kv (2e-5);
  * the chained-carry property of tests/test_kernels.py: folding an
    arbitrary kv split in order, and merging independent partials in
    reverse, both equal dense attention (3e-5);
  * ``ops.flash_attention_bwd_block`` against the reference's (2e-5);
  * ``managed_ring_attention`` at one rank against the reference's inside
    ``smap`` on a one-device mesh: output (rtol 2e-4, atol 2e-5), the
    gradients of q, k and v (3e-4 / 3e-5) and the DecisionRecord;
  * the same over 2 and 4 gloo processes (file:// init, one spawn per
    rank count) in modes bulk, interleaved and auto, against one-rank
    attention over the whole sequence, the oracle of
    tests/dist_suite/test_ring_attention.py;
  * ``attention_sp_{ring,ulysses,auto}`` against the port's and the
    reference's ``attention_sp`` at tp = 1, the ``return_kv`` cache
    slice included.
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
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as RefModelConfig
from repro.core import cost_model as ref_cm
from repro.core import managed as ref_managed
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.kernels.flash_attention import flash_attention_carry_pallas
from repro.models import attention as ref_attention
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import smap
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.core import managed
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import attention
from repro_torch.parallel.sharding import MeshCtx

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = [2, 4]
MODES = ["bulk", "interleaved", "auto"]
MASKS = [(True, 0), (True, 70), (False, 0), (False, 70)]
#: the reference dist suite's ring shapes: B, S, H, KV, hd
RING_SHAPE = (2, 256, 4, 2, 32)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the carry step and its backward
# ---------------------------------------------------------------------------

#: (causal, window, carried, Skv): Skv 64 also runs the Pallas carry
#: kernel (blocks of 32); 50 and 77 are ragged
STEP_CASES = [(True, 0, False, 64), (False, 0, True, 64),
              (True, 40, True, 64), (False, 40, False, 64),
              (True, 0, True, 50), (False, 30, True, 77)]


def _step_inputs(seed, skv, carried, b=1, sq=64, h=4, kvh=2, hd=32):
    rng = np.random.default_rng(seed)
    q = _rand(rng, (b, sq, h, hd))
    k = _rand(rng, (b, skv, kvh, hd))
    v = _rand(rng, (b, skv, kvh, hd))
    carry = fa.init_partials(b, sq, h, hd, device="cpu")
    if carried:     # the state after an earlier, unmasked block
        carry = fa.flash_attention_step_torch(
            _t(q), _t(_rand(rng, (b, 48, kvh, hd))),
            _t(_rand(rng, (b, 48, kvh, hd))), *carry, causal=False)
    return q, k, v, [c.numpy() for c in carry]


@pytest.mark.parametrize("causal,window,carried,skv", STEP_CASES)
def test_plain_carry_step_matches_reference(causal, window, carried, skv,
                                            hd=32):
    q, k, v, (m, l, acc) = _step_inputs(7, skv, carried, hd=hd)
    got = fa.flash_attention_step_torch(
        _t(q), _t(k), _t(v), _t(m), _t(l), _t(acc), causal=causal,
        window=window, q_offset=64, k_offset=32)
    want = ref_ops._flash_step_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
        jnp.asarray(l), jnp.asarray(acc), causal, window, jnp.int32(64),
        jnp.int32(32), 512)
    for g, w, nm in zip(got, want, ("m", "l", "acc")):
        _close(g.numpy(), w, 2e-5, 2e-5, nm)
    if skv % 32 == 0:
        pallas = flash_attention_carry_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m),
            jnp.asarray(l), jnp.asarray(acc), causal=causal, window=window,
            q_offset=jnp.int32(64), k_offset=jnp.int32(32), blk_q=32,
            blk_kv=32, interpret=True)
        for g, w, nm in zip(got, pallas, ("m", "l", "acc")):
            _close(g.numpy(), w, 2e-5, 2e-5, f"pallas {nm}")
    # ops.flash_attention_step takes the plain step on a CPU tensor
    via_ops = ops.flash_attention_step(
        _t(q), _t(k), _t(v), (_t(m), _t(l), _t(acc)), causal=causal,
        window=window, q_offset=64, k_offset=32)
    for g, w in zip(via_ops, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", range(6))
def test_chained_carry_and_merged_partials_equal_dense(seed):
    """Merging flash partials over an arbitrary kv split (chained carry,
    and pairwise ``merge_partials`` in reversed order) equals dense
    attention over the whole sequence — causal, windowed and GQA (the
    property of tests/test_kernels.py::test_online_softmax_merge_property,
    on six seeds)."""
    rng = np.random.default_rng(seed)
    kvh, causal = 1 + seed % 3, bool(seed % 2)
    window = (0, 37)[seed // 3]
    b, sq, skv, hd = 1, 32, 96, 16
    h = 2 * kvh
    q, k, v = (_t(_rand(rng, s)) for s in ((b, sq, h, hd), (b, skv, kvh, hd),
                                            (b, skv, kvh, hd)))
    q_offset = skv - sq
    cuts = sorted(set(rng.integers(1, skv, size=2 + seed % 4).tolist()))
    bounds = [0, *cuts, skv]
    want = ref_kernels.flash_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), causal=causal, window=window,
        q_offset=q_offset)
    carry, partials = None, []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  k_offset=lo)
        carry = ops.flash_attention_step(q, k[:, lo:hi], v[:, lo:hi], carry,
                                         **kw)
        partials.append(ops.flash_attention_step(q, k[:, lo:hi],
                                                 v[:, lo:hi], **kw))
    merged = partials[-1]
    for p in reversed(partials[:-1]):
        merged = fa.merge_partials(merged, p)
    for parts in (carry, merged):
        out, _ = fa.finalize_partials(*parts)
        _close(out.numpy(), want, 3e-5, 3e-5)


@pytest.mark.parametrize("causal,window,skv,k_offset",
                         [(True, 0, 64, 32), (False, 0, 77, 0),
                          (True, 40, 50, 40), (False, 30, 64, 96)])
def test_bwd_block_matches_reference(causal, window, skv, k_offset):
    rng = np.random.default_rng(3)
    b, sq, h, kvh, hd = 2, 64, 4, 2, 32
    q, dout = _rand(rng, (b, sq, h, hd)), _rand(rng, (b, sq, h, hd))
    k, v = _rand(rng, (b, skv, kvh, hd)), _rand(rng, (b, skv, kvh, hd))
    lse = _rand(rng, (b, sq, h)) + 3.0
    dsum = _rand(rng, (b, sq, h))
    kw = dict(causal=causal, window=window, q_offset=64, k_offset=k_offset,
              blk_kv=32)
    got = ops.flash_attention_bwd_block(_t(q), _t(k), _t(v), _t(dout),
                                        _t(lse), _t(dsum), **kw)
    want = ref_ops.flash_attention_bwd_block(
        *(jnp.asarray(a) for a in (q, k, v, dout, lse, dsum)), **kw)
    for g, w, nm in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        _close(g.numpy(), w, 2e-5, 2e-5, nm)


@pytest.mark.parametrize("causal,window,carried,skv",
                         [(True, 0, True, 64), (False, 40, False, 50)])
def test_plain_carry_step_at_head_dim_192_matches_reference(causal, window,
                                                            carried, skv):
    """nemotron-4-340b's head_dim: the plain step against the jnp engine
    and (Skv 64) the Pallas carry kernel in interpret mode."""
    test_plain_carry_step_matches_reference(causal, window, carried, skv,
                                            hd=192)


def test_init_partials_needs_a_device():
    with pytest.raises(TypeError):
        fa.init_partials(1, 4, 2, 8)            # no default device
    m, l, acc = fa.init_partials(1, 4, 2, 8, device="cpu")
    assert (m == fa.NEG_INF).all() and not l.any() and not acc.any()


# ---------------------------------------------------------------------------
# managed_ring_attention at one rank, against the reference
# ---------------------------------------------------------------------------


def _ring_inputs(shape=RING_SHAPE):
    rng = np.random.default_rng(0)
    b, s, h, kvh, hd = shape
    q = _rand(rng, (b, s, h, hd))
    k = _rand(rng, (b, s, kvh, hd))
    v = _rand(rng, (b, s, kvh, hd))
    dout = _rand(np.random.default_rng(1), (b, s, h, hd))
    return q, k, v, dout


def _ref_ring(q, k, v, dout, causal, window, mode):
    """The reference's ring on a one-device mesh: (out, dq, dk, dv) and
    the DecisionRecords of tracing the forward."""
    mesh = jax.make_mesh((1,), ("x",))
    spec = P(None, "x")
    fwd = jax.jit(smap(
        lambda q_, k_, v_: ref_managed.managed_ring_attention(
            q_, k_, v_, "x", causal, window, mode),
        mesh, in_specs=(spec,) * 3, out_specs=spec))

    def loss(q_, k_, v_, d_):
        return jnp.sum(ref_managed.managed_ring_attention(
            q_, k_, v_, "x", causal, window, mode) * d_)

    grads = jax.jit(smap(jax.grad(loss, argnums=(0, 1, 2)), mesh,
                         in_specs=(spec,) * 4, out_specs=(spec,) * 3))
    args = [jnp.asarray(a) for a in (q, k, v)]
    with ref_managed.use_config(ref_managed.MDMPConfig(hw=ref_cm.TPU_V5E)):
        with ref_managed.capture_decisions() as cap:
            out = fwd(*args)
        recs = cap.records
    return out, grads(*args, jnp.asarray(dout)), recs


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("mode", MODES)
def test_one_rank_ring_matches_reference(causal, window, mode,
                                        shape=RING_SHAPE):
    q, k, v, dout = _ring_inputs(shape)
    want_out, want_grads, want_recs = _ref_ring(q, k, v, dout, causal,
                                                window, mode)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        with managed.capture_decisions() as cap:
            out = managed.managed_ring_attention(
                *leaves, "x", MeshCtx({"x": 1}), causal, window, mode)
    (out * _t(dout)).sum().backward()
    _close(out.detach().numpy(), want_out, 2e-4, 2e-5, "out")
    for g, w, nm in zip(leaves, want_grads, "qkv"):
        _close(g.grad.numpy(), w, 3e-4, 3e-5, f"d{nm}")
    assert [dataclasses.asdict(r) | {"t": None} for r in cap.records] == \
        [dataclasses.asdict(r) | {"t": None} for r in want_recs]


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 70)])
def test_one_rank_ring_at_head_dim_192_matches_reference(causal, window):
    """nemotron-4-340b's head_dim (6:1 heads): output and gradients, and
    the DecisionRecord, as at hd 32."""
    test_one_rank_ring_matches_reference(causal, window, "bulk",
                                         shape=(1, 128, 6, 1, 192))


def test_ring_over_several_ranks_needs_their_group():
    q, k, v, _ = (_t(a) for a in _ring_inputs())
    with pytest.raises(ValueError, match="process group"):
        managed.managed_ring_attention(q, k, v, "model",
                                       MeshCtx({"data": 1, "model": 2}))


# ---------------------------------------------------------------------------
# managed_ring_attention over 2 and 4 gloo processes
# ---------------------------------------------------------------------------


def _ring_cases(rank, ranks, group):
    """Every (mode, mask) case on this rank's sequence block: name_out,
    name_dq, name_dk, name_dv -> its block of each, and name_records ->
    the DecisionRecords it logged as "op:mode"."""
    q, k, v, dout = _ring_inputs()
    s_loc = q.shape[1] // ranks
    rows = slice(rank * s_loc, (rank + 1) * s_loc)
    ctx = MeshCtx({"data": 1, "model": ranks})
    res = {}
    for mode in MODES:
        for causal, window in MASKS:
            leaves = [_t(a[:, rows]).requires_grad_() for a in (q, k, v)]
            with managed.capture_decisions() as cap:
                out = managed.managed_ring_attention(
                    *leaves, "model", ctx, causal, window, mode, group=group)
            (out * _t(dout[:, rows])).sum().backward()
            name = f"{mode}_c{int(causal)}_w{window}"
            res[f"{name}_out"] = out.detach().numpy()
            for t, nm in zip(leaves, ("dq", "dk", "dv")):
                res[f"{name}_{nm}"] = t.grad.numpy()
            res[f"{name}_records"] = np.array(
                [f"{r.op}:{r.mode}" for r in cap.records])
    return res


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, {tests!r})
from test_torch_ring_attention import _ring_cases

rank, ranks, init, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, rank=rank,
                        world_size=ranks)
np.savez(f"{{out}}/rank{{rank}}.npz",
         **_ring_cases(rank, ranks, dist.group.WORLD))
dist.barrier()
dist.destroy_process_group()
"""


def _spawn(ranks, tmp):
    """Start every case on ``ranks`` gloo processes."""
    script = tmp / "worker.py"
    script.write_text(WORKER.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    init = "file://" + str(tmp / "init")
    return [subprocess.Popen([sys.executable, str(script), str(r),
                              str(ranks), init, str(tmp)], env=env,
                             stderr=subprocess.PIPE, text=True)
            for r in range(ranks)]


def _collect(procs, tmp):
    """Wait for the processes; name -> the per-rank results in rank
    order."""
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err
    parts = [np.load(tmp / f"rank{r}.npz") for r in range(len(procs))]
    return {name: [p[name] for p in parts] for name in parts[0].files}


@pytest.fixture(scope="module")
def ring_results(tmp_path_factory):
    """Both rank counts run at once, each in its own process group."""
    tmps = {n: tmp_path_factory.mktemp(f"ring{n}") for n in RANKS}
    procs = {n: _spawn(n, tmps[n]) for n in RANKS}
    return {n: _collect(procs[n], tmps[n]) for n in RANKS}


@pytest.fixture(scope="module")
def oracle():
    """Attention over the whole sequence on one rank (the dense reference)
    and its gradients: (causal, window) -> (out, dq, dk, dv)."""
    q, k, v, dout = (jnp.asarray(a) for a in _ring_inputs())
    res = {}
    for causal, window in MASKS:
        def loss(q_, k_, v_):
            o = ref_kernels.flash_attention_ref(q_, k_, v_, causal=causal,
                                                window=window)
            return jnp.sum(o * dout), o
        grads, out = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        res[(causal, window)] = (np.asarray(out),
                                 *(np.asarray(g) for g in grads))
    return res


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ranks", RANKS)
def test_ring_over_gloo_ranks_matches_one_rank(ring_results, oracle, ranks,
                                               mode, causal, window):
    name = f"{mode}_c{int(causal)}_w{window}"
    res = ring_results[ranks]
    want = oracle[(causal, window)]
    for i, nm in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate(res[f"{name}_{nm}"], axis=1)   # the sequence
        tol = (2e-4, 2e-5) if nm == "out" else (3e-4, 3e-5)
        _close(got, want[i], *tol, nm)
    for recs in ring_results[ranks][f"{name}_records"]:
        assert len(recs) == 1 and recs[0].startswith("ring_attention:")
        if mode != "auto":
            assert recs[0] == f"ring_attention:{mode}"


# ---------------------------------------------------------------------------
# the SP schedules at tp = 1
# ---------------------------------------------------------------------------

CFG_KW = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=8,
              n_kv_heads=2, d_ff=128, vocab_size=128, d_head=16,
              tp_multiple=8)


def _attn_params():
    cfg = ModelConfig(**CFG_KW)
    rng = np.random.default_rng(2)
    b, s, d = 2, 128, cfg.d_model
    hp, hd = cfg.padded_heads, cfg.head_dim
    kvh = attention.padded_kv_heads(cfg)
    x = _rand(rng, (b, s, d), 0.1)
    params = {"w_q": _rand(rng, (d, hp * hd), 0.1),
              "w_kv": _rand(rng, (d, 2 * kvh * hd), 0.1),
              "w_o": _rand(rng, (hp * hd, d), 0.1)}
    return cfg, x, params


def _ref_attention_sp(x, params, causal, window):
    cfg = RefModelConfig(**CFG_KW)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ctx = RefMeshCtx.from_mesh(mesh, "bulk")

    def body(x_, wq, wkv, wo):
        y, (k, v) = ref_attention.attention_sp(
            x_, {"w_q": wq, "w_kv": wkv, "w_o": wo}, cfg, ctx,
            causal=causal, window=window, return_kv=True)
        return y, k, v

    fn = jax.jit(smap(body, mesh,
                      in_specs=(P(None, "model"), P(None, None),
                                P(None, None), P(None, None)),
                      out_specs=(P(None, "model"),) * 3))
    return [np.asarray(a) for a in fn(x, params["w_q"], params["w_kv"],
                                      params["w_o"])]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
@pytest.mark.parametrize("impl", ["ring", "ulysses", "auto"])
@pytest.mark.parametrize("mdmp_mode", ["bulk", "interleaved"])
def test_sp_schedules_match_attention_sp_and_reference(impl, mdmp_mode,
                                                       causal, window):
    cfg, x, params = _attn_params()
    want = _ref_attention_sp(x, params, causal, window)
    tparams = {k: _t(v) for k, v in params.items()}
    ctx = MeshCtx(mdmp_mode=mdmp_mode)
    fn = {"ring": attention.attention_sp_ring,
          "ulysses": attention.attention_sp_ulysses,
          "auto": attention.attention_sp_auto}[impl]
    with managed.capture_decisions() as cap:
        y, (k, v) = fn(_t(x), tparams, cfg, ctx, causal=causal,
                       window=window, return_kv=True)
    base, (k0, v0) = attention.attention_sp(
        _t(x), tparams, cfg, MeshCtx(mdmp_mode="bulk"), causal=causal,
        window=window, return_kv=True)
    for got, port, ref, nm in ((y, base, want[0], "y"), (k, k0, want[1], "k"),
                               (v, v0, want[2], "v")):
        _close(got.numpy(), port.numpy(), 3e-4, 3e-5, f"{nm} vs port")
        _close(got.numpy(), ref, 3e-4, 3e-5, f"{nm} vs reference")
    ops_logged = [r.op for r in cap.records]
    if impl == "auto":
        # interleaved pins the ring schedule, bulk the bulk schedule
        want_sched = "ring" if mdmp_mode == "interleaved" else "bulk"
        assert cap.records[0].mode == want_sched
        assert ops_logged == ["attention_schedule"] + (
            ["ring_attention"] if want_sched == "ring" else [])
    else:
        assert ops_logged == (["ring_attention"] if impl == "ring" else [])


def test_sp_plan_is_run_as_resolved():
    """A plan resolved once (as Model resolves it) runs its schedule and
    the ring's mode without logging again."""
    cfg, x, params = _attn_params()
    tparams = {k: _t(v) for k, v in params.items()}
    ctx = MeshCtx(mdmp_mode="interleaved")
    with managed.capture_decisions() as cap:
        plan = attention.resolve_sp_plan(cfg, ctx, 2, 128, impl="auto")
    assert plan == attention.SPPlan("ring", "interleaved")
    assert [r.op for r in cap.records] == ["attention_schedule",
                                           "ring_attention"]
    with managed.capture_decisions() as cap:
        y = attention.attention_sp_auto(_t(x), tparams, cfg, ctx, plan=plan)
    assert cap.records == []
    want = attention.attention_sp(_t(x), tparams, cfg, ctx)
    _close(y.numpy(), want.numpy(), 3e-4, 3e-5)
