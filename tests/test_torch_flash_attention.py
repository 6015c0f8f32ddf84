"""The port's flash attention (kernels/ops.py, kernels/flash_attention.py)
held against the reference's, on the CPU.

  * forward — the port's ``ops.flash_attention`` on CPU tensors (the dense
    path below DENSE_MAX_SEQ**2, and the plain blockwise engine pinned
    with ``engine="torch"``) against the reference's Pallas kernel
    ``flash_attention_pallas(..., interpret=True)``, and the plain lse
    against the reference's blockwise lse;
  * backward — gradients of the port's autograd Function against
    ``jax.grad`` of the reference's ``ops.flash_attention`` under
    ``REPRO_PALLAS=interpret`` (Pallas forward, flash backward).

Inputs come from a numpy seed.  Tolerances, in f32: 1e-5 on outputs and
the lse, 1e-4 on gradients (sums over kv blocks in another order).  The
CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels_card.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

OUT_TOL = 1e-5
GRAD_TOL = 1e-4

#: (B, Sq, Skv, H, KV, hd, causal, window, q_offset); Sq and Skv are
#: multiples of the Pallas blocks of 32 except the ragged-Skv cases,
#: which the reference runs through its blockwise engine
CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 0),        # GQA, causal
    (1, 64, 64, 4, 4, 32, False, 0, 0),       # MHA, not causal
    (1, 64, 64, 6, 1, 16, True, 0, 0),        # MQA
    (1, 64, 64, 4, 2, 16, True, 24, 0),       # sliding window
    (1, 32, 96, 4, 2, 16, True, 0, 64),       # q_offset, Sq < Skv
    (1, 32, 50, 4, 1, 16, False, 12, 18),     # ragged Skv, window
]
PALLAS_CASES = [c for c in CASES if c[2] % 32 == 0]


def _inputs(case, seed=0):
    b, sq, skv, h, kvh, hd = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd),
                      (b, sq, h, hd))]


def _kw(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8])


@pytest.mark.parametrize("engine", ["auto", "torch"])
@pytest.mark.parametrize("case", PALLAS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_forward_matches_reference_pallas_kernel(case, engine):
    q, k, v, _ = _inputs(case)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), blk_q=32, blk_kv=32,
                                  interpret=True, **_kw(case))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), engine=engine,
                              **_kw(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_forward_and_lse_match_reference_blockwise(case):
    """The plain engine at a block that splits the kv (16), against the
    reference's blockwise forward and its lse ([b, kvh, g, sq] there), and
    ``flash_attention_blockwise`` against the reference's."""
    q, k, v, _ = _inputs(case)
    b, sq, _, h, kvh, _ = case[:6]
    want_out, want_lse = ref_ops._blockwise_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), case[6], case[7],
        case[8], 16)
    got_out, got_lse = fa.flash_attention_torch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        blk_kv=16, **_kw(case))
    want_lse = np.asarray(want_lse).transpose(0, 3, 1, 2).reshape(b, sq, h)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=OUT_TOL,
                               atol=OUT_TOL)
    blockwise = ops.flash_attention_blockwise(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        blk_kv=16, **_kw(case))
    want_blockwise = ref_ops.flash_attention_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), blk_kv=16,
        **_kw(case))
    np.testing.assert_allclose(blockwise.numpy(), np.asarray(want_blockwise),
                               rtol=OUT_TOL, atol=OUT_TOL)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The reference's ops.flash_attention through its Pallas kernel: the
    module-level jit is cleared so no trace cached under 'off' is
    reused."""
    monkeypatch.setenv("REPRO_PALLAS", "interpret")
    jax.clear_caches()
    yield
    monkeypatch.delenv("REPRO_PALLAS")
    jax.clear_caches()


@pytest.mark.parametrize("engine", ["auto", "torch"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_gradients_match_reference_flash_backward(pallas_interpret, case,
                                                  engine):
    q, k, v, g = _inputs(case)

    def ref_loss(q_, k_, v_):
        out = ref_ops.flash_attention(q_, k_, v_, blk_q=32, blk_kv=32,
                                      **_kw(case))
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, engine=engine, **_kw(case))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_fully_masked_rows_give_zeros_not_nan():
    """Rows whose window lies past every key: the blockwise engine (the
    kernels' plain version) gives zero output, the finite lse -1e30 and
    zero gradients, as the reference's blockwise engine does.  (The dense
    path, like the reference's attend_ref, softmaxes such a row
    uniformly.)"""
    q, k, v, g = _inputs((1, 16, 8, 2, 1, 8, True, 4, 20))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=4,
                              q_offset=20, engine="torch")
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert torch.equal(out, torch.zeros_like(out))
    for t in grads:
        assert torch.equal(t, torch.zeros_like(t))
    want = ref_ops.flash_attention_blockwise(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=4, q_offset=20)
    assert not np.asarray(want).any()
    _, lse = fa.flash_attention_torch(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=True,
                                      window=4, q_offset=20)
    assert (lse == -1e30).all()


def test_cpu_tensors_take_the_plain_versions_without_counting():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    f0, b0 = fa.FWD_LAUNCHES, fa.BWD_LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v)
    want_out, want_lse = fa.flash_attention_torch(q, k, v)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, g)
    for a, w in zip(grads, fa.flash_attention_bwd_torch(q, k, v, out, lse,
                                                         g)):
        assert torch.equal(a, w)
    assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == (f0, b0)


def test_wrappers_reject_bad_inputs():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    with pytest.raises(ValueError, match="engine"):
        fa.flash_attention_fwd(q, k, v, engine="pallas")
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention_fwd(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="fit"):
        fa.flash_attention_fwd(q, k, v[:, :5])
    out, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="fit"):
        fa.flash_attention_bwd(q, k, v, out, lse[:, 1:], g)


def test_dispatch_follows_the_device_and_the_reference_off_rule():
    """On the CPU, ops takes the dense path below DENSE_MAX_SEQ**2 logits
    and the blockwise engine at or above it; a CUDA tensor always takes
    the kernel (checked on the card)."""
    small = torch.zeros(1, 64, 2, 8)
    assert not ops.flash_attention_applicable(small, small, small)
    big_q = torch.zeros(1, ops.DENSE_MAX_SEQ, 1, 8)
    assert ops.flash_attention_applicable(big_q, big_q, big_q)
