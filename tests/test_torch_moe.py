"""The port's MoE held against the reference's, on the CPU.

  * dispatch bookkeeping (``repro_torch.moe.dispatch``): the reference's
    cases and its hypothesis property over arbitrary (t, E, top_k,
    capacity) with repeated expert ids and overflow past capacity —
    every index array equal to the reference's, and the gather/combine
    round trip equal to the numpy oracle;
  * the grouped-expert FFN's plain version and its autograd Function
    against ``grouped_expert_ffn_jnp`` and the Pallas kernel in interpret
    mode, on the reference's three shapes with garbage in the padded rows
    (f32, rtol = atol = 1e-5), padded rows exactly zero, and gradients
    against the reference's custom VJP (rtol = atol = 2e-5, the
    reference test's tolerance);
  * ``moe_block_ep`` / ``moe_block_expert_tp`` x {bulk, stream, dense,
    auto} and ``moe_block_decode`` against the reference at tp=1 (f32,
    1e-5), the dense schedule being capacity-free;
  * ``decide_moe_dispatch`` / ``resolve_moe_dispatch`` equal to the
    reference's under ``TPU_V5E``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.base import ModelConfig as RefModelConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.core import cost_model as ref_cm
from repro.core import managed as ref_managed
from repro.kernels import grouped_matmul as ref_gm
from repro.models import moe as ref_moe
from repro.moe import dispatch as ref_dispatch
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import smap
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import cost_model as cm
from repro_torch.core import managed
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.models import moe
from repro_torch.moe import dispatch
from repro_torch.parallel.sharding import MeshCtx

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# Dispatch bookkeeping
# ---------------------------------------------------------------------------


def _roundtrip_oracle(x, gates, top_idx, n_experts, capacity):
    """Independent numpy oracle of the GShard capacity semantics (the
    reference test's): entry (t, k) is kept iff fewer than C earlier
    entries (stable expert-major order) routed to its expert."""
    t, k = top_idx.shape
    flat_e = top_idx.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    fill = np.zeros(n_experts, np.int64)
    y = np.zeros_like(x)
    for pos in order:
        e = flat_e[pos]
        if fill[e] < capacity:
            fill[e] += 1
            y[pos // k] += gates.reshape(-1)[pos] * x[pos // k]
    return y


def _check_dispatch(x, gates, top_idx, n_experts, capacity):
    got = dispatch.dispatch_indices(_t(top_idx), n_experts, capacity)
    want = ref_dispatch.dispatch_indices(jnp.asarray(top_idx), n_experts,
                                         capacity)
    for name, a, b in zip(("dest", "tok", "keep", "order"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    dest, tok, keep, order = got
    np.testing.assert_array_equal(
        dispatch.expert_counts(_t(top_idx), n_experts, capacity).numpy(),
        np.asarray(ref_dispatch.expert_counts(jnp.asarray(top_idx),
                                              n_experts, capacity)))
    buf = dispatch.gather_to_buffers(_t(x), dest, tok, keep, n_experts,
                                     capacity)
    want_buf = ref_dispatch.gather_to_buffers(
        jnp.asarray(x), *map(jnp.asarray, (w.numpy() for w in got[:3])),
        n_experts, capacity)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))
    y = dispatch.combine_from_buffers(buf, dest, tok, keep, _t(gates),
                                      order, x.shape[0])
    np.testing.assert_allclose(
        y.numpy(), _roundtrip_oracle(x, gates, top_idx, n_experts,
                                     capacity), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,t,e,k,cap", [
    (0, 16, 4, 2, 3),      # overflow everywhere
    (1, 8, 8, 1, 1),       # tight capacity
    (2, 32, 4, 4, 40),     # capacity exceeds load: nothing drops
    (3, 5, 3, 2, 2),
])
def test_dispatch_matches_reference_cases(seed, t, e, k, cap):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, 6)).astype(np.float32)
    gates = rng.uniform(0.1, 1.0, size=(t, k)).astype(np.float32)
    top_idx = rng.integers(0, e, size=(t, k)).astype(np.int32)
    _check_dispatch(x, gates, top_idx, e, cap)


def test_dispatch_matches_reference_property():
    """Hypothesis property over arbitrary (t, E, top_k, capacity), with
    repeated expert ids within a token and overflow past capacity."""
    hyp = pytest.importorskip("hypothesis")
    hnp = pytest.importorskip("hypothesis.extra.numpy")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(deadline=None, max_examples=30)
    @hyp.given(st.data(), st.integers(1, 24), st.integers(1, 8),
               st.integers(1, 4), st.integers(1, 9))
    def run(data, t, e, k, cap):
        k = min(k, e)
        x = data.draw(hnp.arrays(np.float32, (t, 4),
                                 elements=st.floats(-4, 4, width=32,
                                                   allow_subnormal=False)))
        gates = data.draw(hnp.arrays(np.float32, (t, k),
                                     elements=st.floats(0, 1, width=32,
                                                       allow_subnormal=False)))
        top_idx = data.draw(hnp.arrays(np.int32, (t, k),
                                       elements=st.integers(0, e - 1)))
        _check_dispatch(x, gates, top_idx, e, cap)

    run()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_adds_in_the_reference_order(dtype):
    """The gather-and-add combine equals the reference's scatter-add bit
    for bit, in bf16 too: each token's K rows are added in expert-sorted
    order, starting from zero."""
    rng = np.random.default_rng(7)
    t, e, k, cap, d = 64, 8, 4, 40, 16
    top_idx = np.stack([rng.permutation(e)[:k] for _ in range(t)]) \
        .astype(np.int32)
    out = rng.normal(size=(e, cap, d)).astype(np.float32)
    gates = rng.uniform(0.1, 1.0, size=(t, k)).astype(np.float32)
    dest, tok, keep, order = dispatch.dispatch_indices(_t(top_idx), e, cap)
    tdt = getattr(torch, dtype)
    got = dispatch.combine_from_buffers(_t(out).to(tdt), dest, tok, keep,
                                        _t(gates), order, t)
    want = ref_dispatch.combine_from_buffers(
        jnp.asarray(out).astype(getattr(jnp, dtype)),
        *[jnp.asarray(a.numpy()) for a in (dest, tok, keep)],
        jnp.asarray(gates), jnp.asarray(order.numpy()), t)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_capacity_for_rounds_up():
    e_cfg = MoEConfig(n_experts=4, top_k=1, d_ff_expert=8,
                      capacity_factor=1.0)
    assert dispatch.capacity_for(10, e_cfg) == 3
    assert dispatch.capacity_for(10, e_cfg, 2.0) == 5
    ref_cfg = RefMoEConfig(n_experts=4, top_k=1, d_ff_expert=8,
                           capacity_factor=1.0)
    for t in (1, 10, 4096):
        for cf in (None, 0.25, 1.25, 8.0):
            assert dispatch.capacity_for(t, e_cfg, cf) == \
                ref_dispatch.capacity_for(t, ref_cfg, cf)


# ---------------------------------------------------------------------------
# Grouped-expert FFN
# ---------------------------------------------------------------------------

GEMM_SHAPES = [
    (4, 16, 8, 12, 4),       # one group per expert
    (8, 32, 8, 16, 2),       # (expert, src-rank) grouping: gpe=4
    (3, 256, 8, 8, 3),       # multi-block capacity walk (blk_c=128)
]


def _gemm_operands(seed, G, C, D, F, E):
    """The reference test's operands: valid counts of 0, C and between,
    1e3-scale garbage in the rows past them."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(G, C, D)).astype(np.float32)
    valid = rng.integers(0, C + 1, size=G).astype(np.int32)
    valid[0] = 0
    valid[-1] = C
    rows = np.arange(C)
    h = np.where(rows[None, :, None] < valid[:, None, None], h,
                 1e3 * rng.normal(size=h.shape)).astype(np.float32)
    w1 = rng.normal(size=(E, D, F)).astype(np.float32) * 0.1
    w1g = rng.normal(size=(E, D, F)).astype(np.float32) * 0.1
    w2 = rng.normal(size=(E, F, D)).astype(np.float32) * 0.1
    return h, w1, w1g, w2, valid


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=str)
def test_grouped_ffn_matches_jnp_and_pallas_interpret(mlp, shape):
    G, C, D, F, E = shape
    h, w1, w1g, w2, valid = _gemm_operands(G * 7 + C, G, C, D, F, E)
    w1g_in = w1g if gm.gated(mlp) else None
    jargs = [jnp.asarray(h), jnp.asarray(w1),
             None if w1g_in is None else jnp.asarray(w1g_in),
             jnp.asarray(w2), jnp.asarray(valid)]
    want_jnp = np.asarray(ref_gm.grouped_expert_ffn(*jargs, mlp=mlp,
                                                    engine="jnp"))
    want_pal = np.asarray(ref_gm.grouped_expert_ffn(*jargs, mlp=mlp,
                                                    engine="pallas"))
    targs = [_t(h), _t(w1), None if w1g_in is None else _t(w1g_in),
             _t(w2), _t(valid)]
    plain = gm.grouped_expert_ffn_torch(*targs, mlp)
    auto = gm.grouped_expert_ffn(*targs, mlp=mlp)       # the Function
    for name, got in (("plain", plain), ("function", auto)):
        for wname, want in (("jnp", want_jnp), ("pallas", want_pal)):
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                       atol=TOL,
                                       err_msg=f"{name} vs {wname}")
    pad = np.arange(C)[None, :, None] >= valid[:, None, None]
    assert np.all(plain.numpy()[np.broadcast_to(pad, plain.shape)] == 0)
    assert torch.equal(plain, auto)


@pytest.mark.parametrize("mlp", ["swiglu", "relu2"])
def test_grouped_ffn_gradients_match_reference_vjp(mlp):
    """Gradients through the port's autograd Function (backward = the
    plain version under autograd) against the reference's custom VJP of
    the Pallas path (backward = the jnp engine)."""
    G, C, D, F, E = 8, 32, 8, 16, 2
    h, w1, w1g, w2, valid = _gemm_operands(11, G, C, D, F, E)
    gated = gm.gated(mlp)
    rng = np.random.default_rng(12)
    dy = rng.normal(size=(G, C, D)).astype(np.float32)

    def ref_loss(hh, a, b, c):
        out = ref_gm.grouped_expert_ffn(hh, a, b if gated else None, c,
                                        jnp.asarray(valid), mlp=mlp,
                                        engine="pallas")
        return jnp.sum(out * jnp.asarray(dy))

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (h, w1, w1g, w2)))
    leaves = [_t(a).requires_grad_() for a in (h, w1, w1g, w2)]
    out = gm.grouped_expert_ffn(leaves[0], leaves[1],
                                leaves[2] if gated else None, leaves[3],
                                _t(valid), mlp=mlp)
    (out * _t(dy)).sum().backward()
    for leaf, w, name in zip(leaves, want, ("h", "w1", "w1_gate", "w2")):
        if name == "w1_gate" and not gated:
            assert leaf.grad is None
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=2e-5, atol=2e-5, err_msg=name)


def test_grouped_ffn_refuses_what_it_does_not_take():
    h, w1, w1g, w2, valid = map(_t, _gemm_operands(0, 4, 8, 4, 6, 2))
    with pytest.raises(ValueError, match="w1_gate"):
        gm.grouped_expert_ffn(h, w1, None, w2, valid, mlp="swiglu")
    with pytest.raises(ValueError, match="groups over"):
        gm.grouped_expert_ffn(h[:3], w1, w1g, w2, valid[:3], mlp="swiglu")
    with pytest.raises(ValueError, match="engine"):
        gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp="swiglu",
                              engine="pallas")
    with pytest.raises(RuntimeError, match="no grouped-expert kernel"):
        gm.grouped_expert_ffn_cuda(h, w1, w1g, w2, valid, "swiglu")


# ---------------------------------------------------------------------------
# Model blocks at tp=1, against the reference
# ---------------------------------------------------------------------------

E_, D_, F_ = 4, 16, 32


def _block_cfgs(impl, disp, mlp="swiglu", cf=8.0):
    kw = dict(name="t", family="moe", n_layers=1, d_model=D_, n_heads=2,
              n_kv_heads=2, d_ff=0, vocab_size=64, tp_multiple=1,
              dtype="float32", mlp=mlp)
    ekw = dict(n_experts=E_, top_k=2, d_ff_expert=F_, capacity_factor=cf,
               impl=impl, dispatch=disp)
    return (RefModelConfig(**kw, moe=RefMoEConfig(**ekw)),
            ModelConfig(**kw, moe=MoEConfig(**ekw)))


@pytest.fixture(scope="module")
def block_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, D_)).astype(np.float32)
    params = {
        "w_router": rng.normal(size=(D_, E_)).astype(np.float32),
        "w1": rng.normal(size=(E_, D_, F_)).astype(np.float32) * 0.1,
        "w1_gate": rng.normal(size=(E_, D_, F_)).astype(np.float32) * 0.1,
        "w2": rng.normal(size=(E_, F_, D_)).astype(np.float32) * 0.1,
    }
    return x, params


def _ref_block(fn_name, ref_cfg, x, params):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ctx = RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk")
    fn = getattr(ref_moe, fn_name)
    run = jax.jit(smap(
        lambda xx, pp: fn(xx, pp, ref_cfg, ctx), mesh,
        in_specs=(P(None, "model", None), P()),
        out_specs=(P(None, "model", None), P())))
    y, aux = run(jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("disp", ["bulk", "stream", "dense", "auto"])
@pytest.mark.parametrize("impl,fn_name", [("ep_a2a", "moe_block_ep"),
                                          ("expert_tp",
                                           "moe_block_expert_tp")])
def test_block_matches_reference(impl, fn_name, disp, block_inputs):
    x, params = block_inputs
    ref_cfg, cfg = _block_cfgs(impl, disp)
    want_y, want_aux = _ref_block(fn_name, ref_cfg, x, params)
    ctx = MeshCtx(mdmp_mode="bulk")
    y, aux = getattr(moe, fn_name)(_t(x), {k: _t(v) for k, v in
                                           params.items()}, cfg, ctx)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)
    assert abs(aux.item() - want_aux) <= TOL * max(1.0, abs(want_aux))
    y2, _ = moe.moe_block(_t(x), {k: _t(v) for k, v in params.items()},
                          cfg, ctx)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("mlp", ["geglu", "relu2"])
def test_block_other_activations_match_reference(mlp, block_inputs):
    x, params = block_inputs
    ref_cfg, cfg = _block_cfgs("expert_tp", "bulk", mlp=mlp, cf=1.0)
    if mlp == "relu2":
        params = {k: v for k, v in params.items() if k != "w1_gate"}
    want_y, _ = _ref_block("moe_block_expert_tp", ref_cfg, x, params)
    y, _ = moe.moe_block_expert_tp(_t(x), {k: _t(v) for k, v in
                                           params.items()}, cfg, MeshCtx())
    np.testing.assert_allclose(y.numpy(), want_y, rtol=TOL, atol=TOL)


def test_dense_is_capacity_free_on_degenerate_axis(block_inputs):
    """At a starved capacity factor the capacity path drops tokens; the
    dense schedule matches the unlimited-capacity path."""
    x, params = block_inputs
    tp = {k: _t(v) for k, v in params.items()}

    def run(disp, cf):
        return moe.moe_block_ep(_t(x), tp, _block_cfgs("ep_a2a", disp,
                                                       cf=cf)[1],
                                MeshCtx())[0].numpy()

    unlimited = run("bulk", 64.0)
    np.testing.assert_allclose(run("dense", 0.25), unlimited, rtol=TOL,
                               atol=1e-6)
    assert np.abs(run("bulk", 0.25) - unlimited).max() > 1e-3


@pytest.mark.parametrize("impl", ["ep_a2a", "expert_tp"])
@pytest.mark.parametrize("mlp", ["swiglu", "relu2"])
def test_block_decode_matches_reference(impl, mlp, block_inputs):
    _, params = block_inputs
    if mlp == "relu2":
        params = {k: v for k, v in params.items() if k != "w1_gate"}
    x = np.random.default_rng(5).normal(size=(5, D_)).astype(np.float32)
    ref_cfg, cfg = _block_cfgs(impl, "bulk", mlp=mlp)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ctx = RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk")
    want = jax.jit(smap(
        lambda xx, pp: ref_moe.moe_block_decode(xx, pp, ref_cfg, ctx),
        mesh, in_specs=(P(None, None), P()), out_specs=P(None, None)))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    got = moe.moe_block_decode(_t(x), {k: _t(v) for k, v in params.items()},
                               cfg, MeshCtx())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_grouped_ffn_engine_pin_reaches_the_block(block_inputs, monkeypatch):
    """``engine="torch"`` reaches the grouped FFN: the Function is never
    called, while the default engine calls it once per block."""
    x, params = block_inputs
    _, cfg = _block_cfgs("ep_a2a", "bulk")
    calls = []
    real = gm._GroupedFFN.apply
    monkeypatch.setattr(gm._GroupedFFN, "apply",
                        lambda *a: calls.append(1) or real(*a))
    tp = {k: _t(v) for k, v in params.items()}
    y_auto, _ = moe.moe_block(_t(x), tp, cfg, MeshCtx())
    assert len(calls) == 1
    y_plain, _ = moe.moe_block(_t(x), tp, cfg, MeshCtx(), engine="torch")
    assert len(calls) == 1
    assert torch.equal(y_auto, y_plain)


# ---------------------------------------------------------------------------
# The managed decision
# ---------------------------------------------------------------------------

DECIDE_CASES = [
    # tokens, d_model, E, K, F, axis, kwargs
    (8192, 2048, 64, 6, 1408, 16, dict(mults=3, dtype_bytes=2,
                                       capacity_factor=1.25)),
    (1024, 256, 8, 2, 128, 8, dict(dtype_bytes=4, capacity_factor=8.0)),
    (1024, 256, 8, 2, 128, 1, {}),
    (1024, 256, 8, 2, 128, 8, dict(force_schedule="stream", force_g=4)),
    (1024, 256, 8, 2, 128, 8, dict(force_schedule="dense", force_g=4)),
    (1024, 256, 8, 2, 128, 8, dict(measured_imbalance=3.2)),
    (1024, 256, 8, 2, 128, 8, dict(capacity_factor=8.0,
                                   measured_imbalance=1.1)),
    (1024, 256, 8, 2, 128, 8, dict(capacity_factor=1.0,
                                   measured_imbalance=100.0,
                                   force_schedule="bulk")),
    (1024, 256, 8, 2, 128, 8, dict(capacity_factor=1.0,
                                   measured_imbalance=100.0)),
    (1024, 256, 8, 2, 128, 8, dict(measured_drop_rate=0.1)),
    (4096, 6144, 8, 2, 32768, 16, dict(layout="expert_tp")),
    (4096, 2048, 64, 6, 1408, 1, dict(force_schedule="stream")),
]


@pytest.mark.parametrize("args,kw", [(c[:6], c[6]) for c in DECIDE_CASES])
def test_decide_moe_dispatch_equals_reference(args, kw):
    got = cm.decide_moe_dispatch(*args, hw=cm.TPU_V5E, **kw)
    want = ref_cm.decide_moe_dispatch(*args, hw=ref_cm.TPU_V5E, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_resolve_moe_dispatch_trail_equals_reference():
    cases = [(None, {}), ("bulk", {}), ("interleaved", {}),
             ("interleaved", dict(schedule="dense")),
             (None, dict(schedule="stream", g=3)),
             (None, dict(capacity_factor_override=2.0))]
    for mode, kw in cases:
        args = ("model", 8, 1024, 256, 8, 2, 128)
        recs = []
        for mgr, m in ((managed, "port"), (ref_managed, "ref")):
            cfg = mgr.MDMPConfig(hw=(cm if m == "port" else ref_cm).TPU_V5E,
                                 **({"mode": mode} if mode else {}))
            with mgr.use_config(cfg), mgr.capture_decisions() as cap:
                d = mgr.resolve_moe_dispatch(*args, **kw)
            recs.append((d.schedule, d.g, d.capacity_factor,
                         cap.records[-1]))
        (s0, g0, c0, r0), (s1, g1, c1, r1) = recs
        assert (s0, g0, c0) == (s1, g1, c1), (mode, kw)
        assert (r0.op, r0.axis, r0.nbytes, r0.mode, r0.chunks,
                r0.predicted_bulk_s, r0.predicted_interleaved_s) == \
            (r1.op, r1.axis, r1.nbytes, r1.mode, r1.chunks,
             r1.predicted_bulk_s, r1.predicted_interleaved_s)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def test_train_cli_takes_moe_dispatch(tmp_path, capsys):
    from repro_torch.launch import train

    train.main(["--arch", "moonshot-v1-16b-a3b", "--reduced", "--device",
                "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
                "--moe-dispatch", "dense", "--ckpt", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "decision moe_dispatch(dense g=1 axis=model" in out
    assert "done at step 2" in out
    with pytest.raises(SystemExit):
        train.main(["--arch", "phi4-mini-3.8b", "--reduced", "--device",
                    "cpu", "--moe-dispatch", "auto"])


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "grok-1-314b"])
def test_serve_cli_serves_moe(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                "--requests", "3", "--new-tokens", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "tokens in" in out and "req0" in out
