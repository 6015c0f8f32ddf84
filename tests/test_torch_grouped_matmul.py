"""The grouped-expert FFN's plan and the tensor-core engine's numerics,
on the CPU.

  * ``grouped_plan`` picks the tensor-core engine for bf16 with D and F
    multiples of 64 (moonshot's MoE layers) and SIMT otherwise, from
    shapes and types alone: it runs on meta tensors, which hold no value;
  * the engine's arithmetic in plain torch — bf16 operands, f32 first
    products and activation, act split into bf16 act_hi and act_lo, and
    act_hi w2 + act_lo w2 accumulated in f32 — against the reference's
    ``grouped_expert_ffn_jnp`` on the same numpy inputs at F = 1408.  The
    inputs are f32 arrays whose values bf16 represents, so the reference's
    output stays f32 and w2 is exact in bf16, while act_hi w2 alone is
    not the f32 product; rounded to bf16, the split's output equals the
    reference's rounded on at least 99% of the elements, act_hi's alone
    on about 58%.  The card's kernel is held to the same numerics by
    ``tests/test_torch_kernels_card.py``
    (``test_grouped_ffn_f32_down_product_keeps_f32`` for the f32 readout,
    ``test_grouped_ffn_bf16_output_rounds_the_f32_product`` for the bf16
    binary the models run).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import grouped_matmul as ref_gm
from repro_torch.kernels import grouped_matmul as gm

#: moonshot-v1-16b-a3b's prefill call: G = E = 64, C = 480, D 2048, F 1408
MOONSHOT = (64, 480, 2048, 1408, 64)


def _meta(shape, dtype=torch.bfloat16):
    """h [G, C, D], w1 [E, D, F], w2 [E, F, D] on the meta device."""
    g, c, d, f, e = shape
    return [torch.empty(s, dtype=dtype, device="meta")
            for s in ((g, c, d), (e, d, f), (e, f, d))]


def test_plan_takes_the_tensor_cores_at_moonshots_shape():
    """Every activation, gated or not, at moonshot's shape and at the
    smallest it maps: one persistent CTA per SM (the kernel launches no
    more CTAs than it has tiles)."""
    h, w1, w2 = _meta(MOONSHOT)
    for mlp in ("swiglu", "geglu", "relu2", "gelu"):
        assert gm.grouped_plan(h, w1, w2, mlp, n_sm=132) == \
            gm.Plan("wgmma", 132)
    small = gm.grouped_plan(*_meta((2, 1, 64, 64, 2)), "swiglu", n_sm=114)
    assert small == gm.Plan("wgmma", 114)


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, MOONSHOT),               # f32: the SIMT engine
    (torch.bfloat16, (64, 480, 2040, 1408, 64)),   # D no multiple of 64
    (torch.bfloat16, (64, 480, 2048, 1400, 64)),   # F no multiple of 64
    (torch.bfloat16, (4, 16, 8, 12, 4)),
], ids=["f32", "bf16-D2040", "bf16-F1400", "bf16-D8-F12"])
def test_plan_takes_simt_for_f32_and_unmapped_shapes(dtype, shape):
    h, w1, w2 = _meta(shape, dtype)
    for mlp in ("swiglu", "relu2"):
        # a grid over every tile, no persistent CTAs
        assert gm.grouped_plan(h, w1, w2, mlp, n_sm=132) == gm.Plan("simt", 0)


def test_plan_reads_no_tensor_value():
    """Meta tensors carry shapes and types and no data: the plan needs no
    more, so the wrapper never waits for the card (valid is not even an
    argument)."""
    h, w1, w2 = _meta(MOONSHOT)
    with pytest.raises(Exception):
        h.sum().item()                        # a value cannot be read
    assert gm.grouped_plan(h, w1, w2, "geglu", n_sm=132).engine == "wgmma"


def _bf16_values(rng, shape, scale=1.0):
    """f32 numpy values that bf16 represents exactly."""
    x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return x.bfloat16().float().numpy()


def _tensor_core_arithmetic(h, w1, w1g, w2, valid, mlp, lo=True):
    """The tensor-core engine's arithmetic on f32 tensors holding bf16
    values: the first products and the activation in f32, act split into
    bf16 act_hi and act_lo = act - act_hi, and act_hi w2 (+ act_lo w2),
    each bf16 x bf16 product exact in f32 and summed in f32."""
    n_g, c, d = h.shape
    e = w1.shape[0]
    live = torch.arange(c)[None, :, None] < valid[:, None, None]
    he = torch.where(live, h, 0.0).reshape(e, (n_g // e) * c, d)
    u = torch.bmm(he, w1)
    act = gm._act(mlp, u, torch.bmm(he, w1g) if w1g is not None else None)
    hi = act.bfloat16().float()
    out = torch.bmm(hi, w2)
    if lo:
        out = out + torch.bmm((act - hi).bfloat16().float(), w2)
    return out.reshape(n_g, c, d)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
def test_hi_lo_down_product_matches_the_f32_reference(mlp):
    """act_hi w2 + act_lo w2 is the reference's f32 product within 1e-5 of
    its largest magnitude; act_hi w2 alone is not."""
    g, c, d, f, e = 4, 16, 64, 1408, 2
    rng = np.random.default_rng(19)
    h = _bf16_values(rng, (g, c, d))
    w1, w1g = (_bf16_values(rng, (e, d, f), 0.1) for _ in range(2))
    w2 = _bf16_values(rng, (e, f, d), 0.1)
    valid = np.array([16, 9, 0, 13], np.int32)
    w1g = w1g if gm.gated(mlp) else None
    want = np.asarray(ref_gm.grouped_expert_ffn_jnp(
        jnp.asarray(h), jnp.asarray(w1),
        None if w1g is None else jnp.asarray(w1g), jnp.asarray(w2),
        jnp.asarray(valid), mlp))
    assert want.dtype == np.float32
    args = [torch.from_numpy(a) if a is not None else None
            for a in (h, w1, w1g, w2, valid)]
    scale = np.abs(want).max()
    split = _tensor_core_arithmetic(*args, mlp).numpy()
    assert np.abs(split - want).max() <= 1e-5 * scale
    hi_only = _tensor_core_arithmetic(*args, mlp, lo=False).numpy()
    assert np.abs(hi_only - want).max() > 1e-5 * scale
    pad = np.arange(c)[None, :, None] >= valid[:, None, None]
    assert np.all(split[np.broadcast_to(pad, split.shape)] == 0)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
def test_hi_lo_rounds_to_the_references_bf16(mlp):
    """The bf16 output the models get: act_hi w2 + act_lo w2 rounded to
    bf16 equals the reference's f32 product rounded to bf16 on at least 99%
    of the elements (the card's kernel is held to the same share);
    act_hi w2 alone does so on about 58% only."""
    g, c, d, f, e = 4, 64, 128, 1408, 4
    rng = np.random.default_rng(23)
    h = _bf16_values(rng, (g, c, d))
    w1, w1g = (_bf16_values(rng, (e, d, f), 0.1) for _ in range(2))
    w2 = _bf16_values(rng, (e, f, d), 0.1)
    valid = np.full(g, c, np.int32)
    w1g = w1g if gm.gated(mlp) else None
    want = torch.from_numpy(np.array(ref_gm.grouped_expert_ffn_jnp(
        jnp.asarray(h), jnp.asarray(w1),
        None if w1g is None else jnp.asarray(w1g), jnp.asarray(w2),
        jnp.asarray(valid), mlp))).bfloat16()
    args = [torch.from_numpy(a) if a is not None else None
            for a in (h, w1, w1g, w2, valid)]
    split = _tensor_core_arithmetic(*args, mlp).bfloat16()
    assert (split == want).float().mean().item() >= 0.99
    hi_only = _tensor_core_arithmetic(*args, mlp, lo=False).bfloat16()
    assert (hi_only == want).float().mean().item() < 0.9
