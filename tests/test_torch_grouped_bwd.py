"""The grouped-expert FFN's backward on the CPU: the port's plain backward
(``grouped_expert_ffn_bwd_torch``, the formulas of the card's kernels)
against the reference's ``jax.vjp`` of ``grouped_expert_ffn``.

  * the same numpy inputs (f32 values that bf16 represents, 1e3-scale
    garbage in h and dy past each group's valid count) through the jnp
    engine's vjp, for the four activations, one and two groups an expert,
    and valid counts of 0, part of the capacity and all of it: f32 at
    rtol = 1e-5 and atol = 1e-5 of max(1, max|want|); bf16 within 2e-2 of
    max(1, max|want|) (the reference rounds each group's weight gradient
    and each of dh's two products to bf16 before it sums them; the port
    sums in f32 and rounds once);
  * once through the reference's Pallas kernel in interpret mode, whose
    custom VJP is the same jnp backward;
  * rows past valid give dh exactly 0 and an expert with no kept row a
    weight gradient of exactly 0;
  * ``_GroupedFFN``'s backward on the CPU is the entry's result, and on
    meta tensors under a recorder the entry is one launch of its work
    function, ``grouped_bwd_work``.

The card's kernels are held to the plain backward by
``tests/test_torch_kernels_card.py`` (``test_grouped_ffn_bwd_*``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import grouped_matmul as ref_gm
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.launch import hlo

MLPS = ("swiglu", "geglu", "relu2", "gelu")
#: G groups of C capacity rows, D, F; valid counts per group: an empty
#: expert at one and two groups an expert, partial and full groups
G, C, D, F = 6, 8, 16, 24
VALID = np.array([0, 0, 3, 8, 5, 8], np.int32)
BF16_TOL = 2e-2


def _inputs(seed, gpe):
    """f32 numpy arrays that bf16 represents exactly: h, w1, w1g, w2, dy,
    with garbage past the valid rows of h and dy."""
    rng = np.random.default_rng(seed)
    e = G // gpe

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).bfloat16().float() \
            .numpy()

    live = np.arange(C)[None, :, None] < VALID[:, None, None]
    h = np.where(live, rng.normal(size=(G, C, D)),
                 1e3 * rng.normal(size=(G, C, D)))
    dy = np.where(live, rng.normal(size=(G, C, D)),
                  1e3 * rng.normal(size=(G, C, D)))
    w1, w1g = (0.3 * rng.normal(size=(e, D, F)) for _ in range(2))
    w2 = 0.3 * rng.normal(size=(e, F, D))
    return [bf16(x) for x in (h, w1, w1g, w2, dy)]


def _reference(arrs, mlp, dtype, engine="jnp"):
    """The reference's vjp of grouped_expert_ffn at dy, as f32 numpy
    (dw1g None when ungated)."""
    h, w1, w1g, w2, dy = (jnp.asarray(a, dtype) for a in arrs)
    g = gm.gated(mlp)

    def ffn(h_, w1_, w1g_, w2_):
        return ref_gm.grouped_expert_ffn(h_, w1_, w1g_ if g else None, w2_,
                                         jnp.asarray(VALID), mlp=mlp,
                                         engine=engine)

    _, vjp = jax.vjp(ffn, h, w1, w1g, w2)
    dh, dw1, dw1g, dw2 = vjp(dy)
    out = [np.asarray(t.astype(jnp.float32)) for t in (dh, dw1, dw1g, dw2)]
    if not g:
        out[2] = None
    return out


def _port(arrs, mlp, dtype):
    h, w1, w1g, w2, dy = (torch.from_numpy(a).to(dtype) for a in arrs)
    return gm.grouped_expert_ffn_bwd_torch(
        h, w1, w1g if gm.gated(mlp) else None, w2, torch.from_numpy(VALID),
        dy, mlp)


def _close_f32(got, want):
    """rtol 1e-5, atol 1e-5 of max(1, max|want|): a weight gradient sums
    up to C x gpe rows, so one of magnitude ~25 carries f32 rounding of
    ~1e-5 in either package (the reference's tanh is XLA's approximation;
    against a float64 autograd the port is the closer of the two)."""
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def _check_zeros(got, gpe):
    dh = got[0].float().numpy()
    dead = np.arange(C)[None, :] >= VALID[:, None]
    assert np.all(dh[dead] == 0.0)
    # expert 0's groups keep no row
    for dw in got[1:]:
        if dw is not None:
            assert torch.equal(dw[0], torch.zeros_like(dw[0]))
    assert gpe in (1, 2) and VALID[:gpe].sum() == 0


@pytest.mark.parametrize("gpe", [1, 2])
@pytest.mark.parametrize("mlp", MLPS)
def test_plain_backward_matches_the_reference_vjp_f32(mlp, gpe):
    arrs = _inputs(gpe, gpe)
    want = _reference(arrs, mlp, jnp.float32)
    got = _port(arrs, mlp, torch.float32)
    assert (got[2] is None) == (want[2] is None)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float32
            _close_f32(g, w)
    _check_zeros(got, gpe)


@pytest.mark.parametrize("gpe", [1, 2])
@pytest.mark.parametrize("mlp", MLPS)
def test_plain_backward_matches_the_reference_vjp_bf16(mlp, gpe):
    arrs = _inputs(10 + gpe, gpe)
    want = _reference(arrs, mlp, jnp.bfloat16)
    got = _port(arrs, mlp, torch.bfloat16)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.bfloat16
            err = np.abs(g.float().numpy() - w).max()
            assert err <= BF16_TOL * max(1.0, np.abs(w).max()), err
    _check_zeros(got, gpe)


def test_plain_backward_matches_the_pallas_kernels_vjp_in_interpret_mode():
    """The reference's Pallas path (interpret mode on the CPU) carries a
    custom VJP whose backward is the jnp engine's vjp."""
    arrs = _inputs(3, 2)
    want = _reference(arrs, "swiglu", jnp.float32, engine="pallas")
    got = _port(arrs, "swiglu", torch.float32)
    for g, w in zip(got, want):
        _close_f32(g, w)


@pytest.mark.parametrize("mlp", MLPS)
def test_function_backward_is_the_entry_on_the_cpu(mlp):
    """Autograd through grouped_expert_ffn on CPU tensors gives the
    entry's (the plain backward's) gradients bit for bit."""
    arrs = _inputs(7, 2)
    h, w1, w1g, w2, dy = (torch.from_numpy(a) for a in arrs)
    w1g = w1g if gm.gated(mlp) else None
    valid = torch.from_numpy(VALID)
    leaves = [t.clone().requires_grad_() for t in (h, w1, w2)]
    if w1g is not None:
        leaves.append(w1g.clone().requires_grad_())
    out = gm.grouped_expert_ffn(leaves[0], leaves[1],
                                leaves[3] if w1g is not None else None,
                                leaves[2], valid, mlp=mlp)
    grads = torch.autograd.grad(out, leaves, dy)
    dh, dw1, dw1g, dw2 = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy,
                                                   mlp)
    for got, want in zip(grads, (dh, dw1, dw2, dw1g)):
        assert torch.equal(got, want)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("mlp", ["swiglu", "relu2"])
def test_entry_on_meta_counts_one_launch_of_its_work(mlp):
    g, c, d, f, e = 4, 16, 32, 48, 2
    w1g = _meta(e, d, f) if gm.gated(mlp) else None
    counter = hlo.count(lambda: gm.grouped_expert_ffn_bwd(
        _meta(g, c, d), _meta(e, d, f), w1g, _meta(e, f, d),
        _meta(g, dtype=torch.int32), _meta(g, c, d), mlp))
    assert counter.launches() == {"grouped_expert_ffn_bwd": 1}
    assert counter.ops == 0
    assert (counter.flops, counter.hbm_bytes) == gm.grouped_bwd_work(
        g * c, g, c, d, f, e, 2, gm.gated(mlp))


def test_function_backward_on_meta_is_one_backward_launch():
    """A forward and its backward through autograd on meta tensors: one
    forward launch and one backward launch, no plain version."""
    g, c, d, f, e = 4, 16, 32, 48, 2
    leaves = [_meta(*s).requires_grad_() for s in
              ((g, c, d), (e, d, f), (e, d, f), (e, f, d))]
    valid = _meta(g, dtype=torch.int32)

    def step():
        out = gm.grouped_expert_ffn(leaves[0], leaves[1], leaves[2],
                                    leaves[3], valid, mlp="swiglu")
        return torch.autograd.grad(out, leaves, torch.ones_like(out))

    counter = hlo.count(step)
    assert counter.launches() == {"grouped_expert_ffn": 1,
                                  "grouped_expert_ffn_bwd": 1}


def test_work_counts_eight_products_gated_and_five_ungated():
    for gated, n in ((True, 8), (False, 5)):
        flops, nbytes = gm.grouped_bwd_work(100, 4, 30, 16, 24, 2, 2, gated)
        assert flops == 2 * n * 16 * 24 * 100
        weights = (3 if gated else 2) * 2 * 16 * 24
        assert nbytes == (2 * 100 * 16 + 2 * weights + 4 * 30 * 16) * 2 + 16
    # moonshot-v1-16b-a3b's training call: bytes bound it on an H100
    flops, nbytes = gm.grouped_bwd_work(12288, 64, 240, 2048, 1408, 64, 2)
    assert flops / 989e12 < nbytes / 3.35e12
