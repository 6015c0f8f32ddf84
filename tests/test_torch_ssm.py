"""The port's Mamba-2 pieces (models/ssm.py) held against
``repro.models.ssm`` on the CPU in f32 (rtol 1e-5, gradients 1e-4; the
absolute tolerance is the same fraction of the compared tensor's largest
magnitude, so an element near zero in a sum of large terms is held to
f32 rounding of those terms):
``ssd_scan`` (with and without an initial state, at lengths that are and
are not a multiple of the chunk, and the length the reference refuses),
``ssd_decode_step``, ``causal_conv``, ``conv_step``, ``mamba_mixer_sp``
and ``mamba_mixer_decode`` on reduced mamba2-130m weights.

It also pins the one deliberate difference: the reference's ``ssd_scan``
masks its intra-chunk decay after the exponent, so at the full configs'
chunk of 256 the gradient by ``dt`` is not finite (the forward is); the
port masks first, and its gradient at chunk 256 is finite and equal to
the reference's at chunk 32, where the reference's is finite (the math
does not depend on the chunk)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as ref_configs
from repro.models import ssm as ref_ssm
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.parallel.sharding import smap
from repro_torch import configs
from repro_torch.models import ssm
from repro_torch.models.model import SSM_INIT, Model
from repro_torch.parallel.sharding import MeshCtx

TOL = 1e-5
GRAD_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())),
        err_msg=err_msg)


def _scan_inputs(b, s, h, p, n, seed=0, a_log=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt_raw = rng.normal(size=(b, s, h)).astype(np.float32) + 0.1
    dt = np.logaddexp(dt_raw, 0.0).astype(np.float32)
    a_log = (rng.normal(size=(h,)).astype(np.float32) * 0.3
             if a_log is None else np.full((h,), a_log, np.float32))
    a = -np.exp(a_log).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, d, h0


SCAN_CASES = [  # (b, s, h, p, n, chunk, with h0)
    (2, 64, 3, 4, 5, 16, False),
    (2, 64, 3, 4, 5, 16, True),
    (1, 40, 2, 8, 4, 32, False),      # one chunk of 40
    (1, 70, 2, 8, 4, 32, True),       # two chunks of 35
    (1, 8, 2, 4, 4, 32, False),       # shorter than a chunk
]


@pytest.mark.parametrize("case", SCAN_CASES, ids=str)
def test_ssd_scan_matches_reference(case):
    b, s, h, p, n, chunk, with_h0 = case
    x, dt, a, bm, cm, d, h0 = _scan_inputs(b, s, h, p, n)
    h0 = h0 if with_h0 else None
    y_ref, hf_ref = ref_ssm.ssd_scan(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(bm),
        jnp.asarray(cm), jnp.asarray(d), chunk,
        None if h0 is None else jnp.asarray(h0))
    y, hf = ssm.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), _t(d), chunk,
                         None if h0 is None else _t(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_ref), rtol=TOL,
                               atol=TOL)


def test_ssd_scan_refuses_what_the_reference_refuses():
    """71 positions at chunk 32: two chunks of 35 leave one position; the
    reference's reshape fails, and so does the port."""
    x, dt, a, bm, cm, d, _ = _scan_inputs(1, 71, 2, 4, 4)
    with pytest.raises(TypeError):
        ref_ssm.ssd_scan(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                         jnp.asarray(bm), jnp.asarray(cm), jnp.asarray(d),
                         32)
    with pytest.raises(ValueError, match="chunks"):
        ssm.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), _t(d), 32)


def _ref_scan_grads(x, dt, a, bm, cm, d, cot, chunk):
    def loss(x, dt, bm, cm):
        y, _ = ref_ssm.ssd_scan(x, dt, jnp.asarray(a), bm, cm,
                                jnp.asarray(d), chunk)
        return jnp.sum(y * cot)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(bm), jnp.asarray(cm))]


def _port_scan_grads(x, dt, a, bm, cm, d, cot, chunk):
    leaves = [_t(v).requires_grad_() for v in (x, dt, bm, cm)]
    y, _ = ssm.ssd_scan(leaves[0], leaves[1], _t(a), leaves[2], leaves[3],
                        _t(d), chunk)
    return [g.numpy() for g in torch.autograd.grad(
        (y * _t(cot)).sum(), leaves)]


def test_ssd_scan_gradients_match_reference():
    x, dt, a, bm, cm, d, _ = _scan_inputs(2, 64, 3, 4, 5, seed=3)
    cot = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    want = _ref_scan_grads(x, dt, a, bm, cm, d, cot, 16)
    got = _port_scan_grads(x, dt, a, bm, cm, d, cot, 16)
    for name, g, w in zip(("x", "dt", "b", "c"), got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_ssd_scan_masks_before_the_exponent():
    """B 1, S 512, 4 heads, P 16, N 16, dt = softplus(N(0, 1) + 0.1),
    a_log 0.5 (the reference's init): at chunk 256 the reference's
    forward is finite and its d/d dt is not; the port's is finite, equal
    to the reference's chunk-32 gradient, and its forward equals the
    reference's."""
    x, dt, a, bm, cm, d, _ = _scan_inputs(1, 512, 4, 16, 16, seed=5,
                                          a_log=0.5)
    cot = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    y_ref, _ = ref_ssm.ssd_scan(jnp.asarray(x), jnp.asarray(dt),
                                jnp.asarray(a), jnp.asarray(bm),
                                jnp.asarray(cm), jnp.asarray(d), 256)
    assert np.isfinite(np.asarray(y_ref)).all()
    ref256 = _ref_scan_grads(x, dt, a, bm, cm, d, cot, 256)
    assert np.isfinite(ref256[0]).all()                 # d/dx
    assert not np.isfinite(ref256[1]).all()             # d/d dt
    ref32 = _ref_scan_grads(x, dt, a, bm, cm, d, cot, 32)
    assert all(np.isfinite(g).all() for g in ref32)
    got = _port_scan_grads(x, dt, a, bm, cm, d, cot, 256)
    for name, g, w in zip(("x", "dt", "b", "c"), got, ref32):
        assert np.isfinite(g).all(), name
        _close(g, w, GRAD_TOL, name)
    y, _ = ssm.ssd_scan(_t(x), _t(dt), _t(a), _t(bm), _t(cm), _t(d), 256)
    _close(y.numpy(), y_ref)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(7)
    b, h, p, n = 3, 4, 8, 5
    xt = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, h))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    bt = rng.normal(size=(b, n)).astype(np.float32)
    ct = rng.normal(size=(b, n)).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    hs = rng.normal(size=(b, h, p, n)).astype(np.float32)
    want = ref_ssm.ssd_decode_step(*map(jnp.asarray, (xt, dt, a, bt, ct, d,
                                                      hs)))
    got = ssm.ssd_decode_step(*map(_t, (xt, dt, a, bt, ct, d, hs)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_matches_reference(s, with_state):
    rng = np.random.default_rng(8)
    u = rng.normal(size=(2, s, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32) if with_state \
        else None
    want = ref_ssm.causal_conv(jnp.asarray(u), jnp.asarray(w),
                               None if st is None else jnp.asarray(st))
    got = ssm.causal_conv(_t(u), _t(w), None if st is None else _t(st))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL,
                                   atol=TOL)


def test_conv_step_matches_reference():
    rng = np.random.default_rng(9)
    ut = rng.normal(size=(2, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    st = rng.normal(size=(2, 3, 6)).astype(np.float32)
    want = ref_ssm.conv_step(*map(jnp.asarray, (ut, w, st)))
    got = ssm.conv_step(*map(_t, (ut, w, st)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# the mixer on reduced mamba2-130m weights
# ---------------------------------------------------------------------------


def _mixer_setup():
    cfg_ref = dataclasses.replace(ref_configs.get_reduced("mamba2-130m"),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_reduced("mamba2-130m"),
                              dtype="float32")
    model = Model(cfg, device="cpu")
    specs = model._ssm_specs()
    rng = np.random.default_rng(10)
    params = {k: (rng.normal(size=s.shape) * 0.2).astype(np.float32)
              for k, s in specs.items()}
    params["a_log"] = np.full(specs["a_log"].shape, 0.5, np.float32)
    params["dt_bias"] = np.full(specs["dt_bias"].shape, 0.1, np.float32)
    return cfg_ref, cfg, params


def _ref_call(fn):
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ctx = RefMeshCtx.from_mesh(mesh, mdmp_mode="bulk")
    return jax.jit(smap(lambda *a: fn(ctx, *a), mesh, in_specs=P(),
                        out_specs=P()))


def test_mamba_mixer_sp_matches_reference():
    """Output, final state and conv tail, and the gradients of every
    weight (f32)."""
    cfg_ref, cfg, params = _mixer_setup()
    x = np.random.default_rng(11).normal(size=(2, 40, cfg.d_model)) \
        .astype(np.float32)

    def fwd(ctx, pp, xx):
        return ref_ssm.mamba_mixer_sp(xx, pp, cfg_ref, ctx,
                                      return_state=True)
    y_ref, (h_ref, tail_ref) = _ref_call(fwd)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    def loss(ctx, pp, xx):
        return jnp.sum(ref_ssm.mamba_mixer_sp(xx, pp, cfg_ref, ctx) ** 2)
    g_ref = _ref_call(lambda ctx, pp, xx: jax.grad(
        lambda q: loss(ctx, q, xx))(pp))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))

    leaves = {k: _t(v).requires_grad_() for k, v in params.items()}
    y, (h, tail) = ssm.mamba_mixer_sp(_t(x), leaves, cfg, MeshCtx(),
                                      return_state=True)
    for g, w in ((y, y_ref), (h, h_ref), (tail, tail_ref)):
        _close(g.detach().numpy(), w)
    grads = torch.autograd.grad((ssm.mamba_mixer_sp(
        _t(x), leaves, cfg, MeshCtx()) ** 2).sum(), list(leaves.values()))
    for k, g in zip(leaves, grads):
        _close(g.numpy(), g_ref[k], GRAD_TOL, k)


def test_mamba_mixer_decode_matches_reference():
    cfg_ref, cfg, params = _mixer_setup()
    rng = np.random.default_rng(12)
    s = cfg.ssm
    h, di = cfg.ssm_heads, cfg.ssm_heads * s.headdim
    x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    hs = rng.normal(size=(3, h, s.headdim, s.d_state)).astype(np.float32)
    cs = rng.normal(size=(3, s.d_conv - 1, di + 2 * s.d_state)) \
        .astype(np.float32)

    def fwd(ctx, pp, xx, hh, cc):
        return ref_ssm.mamba_mixer_decode(xx, (hh, cc), pp, cfg_ref, ctx)
    y_ref, (h_ref, c_ref) = _ref_call(fwd)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(hs), jnp.asarray(cs))
    y, (h2, c2) = ssm.mamba_mixer_decode(
        _t(x), (_t(hs), _t(cs)), {k: _t(v) for k, v in params.items()},
        cfg, MeshCtx())
    for g, w in ((y, y_ref), (h2, h_ref), (c2, c_ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_model_init_fixes_the_ssm_scalars(arch):
    """The port's own ``Model.init``: a_log 0.5, dt_bias 0.1, d_skip 1 in
    every layer (the reference's fix_ssm), the other per-head scalars and
    norms zero, the matrices drawn."""
    model = Model(configs.get_reduced(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    seen = set()
    for name, p in model.flat.items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in SSM_INIT:
            seen.add(leaf)
            assert torch.all(p == SSM_INIT[leaf]), name
        elif leaf.startswith("w_"):
            assert p.abs().sum() > 0, name
    assert seen == set(SSM_INIT)
