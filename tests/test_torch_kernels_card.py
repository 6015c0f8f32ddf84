"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a CUDA card (a hand-written CUDA kernel has no CPU
mode) and skip without one.  The file imports neither jax nor the
reference, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_kernels_card.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import halo
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import stencil


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _paged_inputs(rng, b, h, kvh, hd, page, pmax, npool):
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    table = rng.permutation(npool)[:b * pmax].reshape(b, pmax) \
        .astype(np.int32)
    lens = rng.integers(0, page * pmax + 1, size=b).astype(np.int32)
    lens[:4] = 0, 1, page, 2 * page               # empty, 1, page edges
    for i in range(b):                            # garbage past the chain
        used = -(-int(lens[i]) // page)
        table[i, used:] = rng.integers(0, npool, size=pmax - used)
    return q, kp, vp, table, lens


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kvh,window", [(32, 8, 0), (32, 8, 64),
                                          (48, 1, 0)])
def test_paged_attention_kernel_matches_plain(cuda, dtype, tol, h, kvh,
                                              window):
    """The kernel against the plain version in f32 on the same inputs
    (f32 atol 1e-4; bf16 atol/rtol 2e-2)."""
    rng = np.random.default_rng(h + window)
    arrs = _paged_inputs(rng, 8, h, kvh, 128, 16, 8, 80)
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    for i in range(3):
        args[i] = args[i].to(dtype)
    before = paged.LAUNCHES
    got = paged.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    assert paged.LAUNCHES == before + 1
    want = paged.paged_attention_torch(
        *[a.float() if i < 3 else a for i, a in enumerate(args)],
        window=window)
    rtol = 0.0 if dtype == torch.float32 else tol
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=tol)
    assert torch.equal(got[0].float(), torch.zeros_like(got[0].float()))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 12])
def test_paged_attention_kernel_matches_plain_on_edge_inputs(cuda, window):
    """lens past the table's reach and page ids outside the pool inside a
    chain: the kernel attends only what the plain version attends (f32,
    atol 1e-4) and reads nothing outside the table or the pool."""
    rng = np.random.default_rng(11)
    page, pmax, npool = 8, 3, 16
    q, kp, vp, table, _ = _paged_inputs(rng, 4, 8, 2, 32, page, pmax, npool)
    lens = np.array([page * pmax + 5, page * pmax + 40, 20, 17], np.int32)
    table[1, 1] = npool + 3
    table[2, 0] = -1
    table[3, :] = npool
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, table, lens)]
    got = paged.paged_attention(*args, window=window)
    torch.cuda.synchronize()
    want = paged.paged_attention_torch(*args, window=window)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-4)
    assert torch.equal(got[3], torch.zeros_like(got[3]))


@pytest.mark.gpu
def test_paged_attention_kernel_rejects_noncontiguous(cuda):
    rng = np.random.default_rng(0)
    arrs = _paged_inputs(rng, 8, 32, 8, 128, 16, 4, 40)
    q, kp, vp, table, lens = [torch.from_numpy(a).to(cuda) for a in arrs]
    with pytest.raises(ValueError):
        paged.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                              kp, vp, table, lens)


# ---------------------------------------------------------------------------
# flash attention, forward and backward
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, KV, hd, causal, window, q_offset): GQA 32/8 and MQA
#: 48/1, causal and not, windows, q_offset > 0 with Sq < Skv, and ragged
#: lengths that are not multiples of the kernels' 64-row tiles; then the
#: edges of the bf16 kernel's 128-row tiles: Sq and Skv of 127, 129 and
#: 257, a window of 100 (less than a tile), a causal q_offset that puts
#: the diagonal mid-tile, and MQA 48/1 at hd 64; then the edges of the
#: bf16 backward's 128-row kv tiles and 64-row query tiles: Skv of 127,
#: 129 and 257, Sq that is not a multiple of 64, at G = 1, 4 and 48 and
#: hd 64 and 128
FLASH_CASES = [
    (2, 256, 256, 32, 8, 128, True, 0, 0),
    (1, 200, 200, 32, 8, 128, False, 0, 0),
    (2, 130, 130, 32, 8, 128, True, 64, 0),
    (1, 96, 300, 48, 1, 128, True, 0, 204),
    (1, 77, 141, 8, 2, 64, False, 64, 0),
    (2, 45, 190, 4, 4, 64, True, 64, 120),
    (1, 127, 127, 32, 8, 128, True, 0, 0),
    (2, 129, 129, 32, 8, 128, True, 0, 0),
    (1, 257, 257, 32, 8, 128, False, 0, 0),
    (1, 127, 257, 8, 2, 64, False, 0, 0),
    (1, 257, 257, 32, 8, 128, True, 100, 0),
    (1, 129, 257, 32, 8, 128, True, 0, 60),
    (1, 200, 200, 48, 1, 64, True, 0, 0),
    (1, 100, 127, 8, 8, 64, True, 0, 27),
    (1, 129, 129, 8, 8, 128, True, 0, 0),
    (1, 70, 129, 16, 4, 128, False, 0, 0),
    (1, 190, 257, 16, 4, 64, True, 30, 67),
    (2, 150, 257, 48, 1, 128, True, 0, 107),
    (1, 65, 127, 48, 1, 64, False, 0, 0),
]


def _flash_inputs(cuda, dtype, b, sq, skv, h, kvh, hd, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd),
                      (b, sq, h, hd))]
    return [torch.from_numpy(a).to(cuda).to(dtype) for a in arrs]


def _close(got, want, tol, what):
    """max|got - want| <= tol * max(1, max|want|), in f32."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= tol * scale, \
        f"{what}: max|err| {err:.3e} > {tol} x {scale:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_kernels_match_plain(cuda, dtype, tol, case):
    """Forward (out, lse) and backward (dq, dk, dv) kernels against the
    plain versions run in f32 on the same inputs: f32 within 1e-4 and
    bf16 within 2e-2 of the largest magnitude (the kernels round only
    their outputs to bf16); the lse within 1e-4 in both."""
    b, sq, skv, h, kvh, hd, causal, window, q_offset = case
    q, k, v, dout = _flash_inputs(cuda, dtype, b, sq, skv, h, kvh, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    f0, b0 = fa.FWD_LAUNCHES, fa.BWD_LAUNCHES
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_torch(q.float(), k.float(),
                                                  v.float(), **kw)
    _close(out, want_out, tol, "out")
    _close(lse, want_lse, 1e-4, "lse")
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    wants = fa.flash_attention_bwd_torch(q.float(), k.float(), v.float(),
                                         out.float(), lse, dout.float(),
                                         **kw)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), wants):
        assert got.dtype == dtype
        _close(got, want, tol, name)
    assert (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) == (f0 + 1, b0 + 1)


@pytest.mark.gpu
def test_flash_attention_kernels_on_fully_masked_rows(cuda):
    """Rows that see no key (the window lies past every key) give zero
    output, the finite lse -1e30, and zero gradients — never NaN."""
    q, k, v, dout = _flash_inputs(cuda, torch.float32, 1, 70, 16, 4, 2, 64)
    kw = dict(causal=True, window=8, q_offset=10)   # rows 14.. see nothing
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.flash_attention_torch(q, k, v, **kw)
    wants = fa.flash_attention_bwd_torch(q, k, v, want_out, want_lse, dout,
                                         **kw)
    for got in (out, lse, dq, dk, dv):
        assert torch.isfinite(got).all()
    assert torch.equal(out[:, 14:], torch.zeros_like(out[:, 14:]))
    assert torch.equal(dq[:, 14:], torch.zeros_like(dq[:, 14:]))
    assert (lse[:, 14:] == -1e30).all()
    _close(out, want_out, 1e-4, "out")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), wants):
        _close(got, want, 1e-4, name)


def _misaligned(x):
    """A contiguous copy of ``x`` whose base lies one element past a
    16-byte boundary (TMA, which feeds the bf16 kernel, needs 16)."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    y = buf[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16
    return y


@pytest.mark.gpu
def test_flash_attention_kernels_reject_what_they_do_not_take(cuda):
    q, k, v, dout = _flash_inputs(cuda, torch.float32, 1, 64, 64, 4, 2, 128)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, k.bfloat16(), v)
    q32, k32, v32, _ = _flash_inputs(cuda, torch.float32, 1, 64, 64, 4, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q32, k32, v32)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    f0 = fa.FWD_LAUNCHES
    for args in ((_misaligned(qb), kb, vb), (qb, kb, _misaligned(vb))):
        with pytest.raises(RuntimeError, match="misaligned"):
            fa.flash_attention_fwd(*args)
    assert fa.FWD_LAUNCHES == f0


@pytest.mark.gpu
def test_flash_forward_equals_finalized_empty_carry_bit_for_bit(cuda):
    """In bf16 the forward and the carry step are one kernel: at an empty
    carry, finalized as ring attention finalizes it, the carry gives the
    forward's output and lse bit for bit (phi4-mini's heads, 1 x 1024,
    causal), which is what makes the one-rank ring prefill equal
    megatron's."""
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 1, 1024, 1024, 32, 8,
                               128)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    carry = fa.flash_attention_carry(
        q, k, v, *fa.init_partials(1, 1024, 32, 128, device=cuda),
        causal=True)
    out_c, lse_c = fa.finalize_partials(*carry, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out, out_c)
    assert torch.equal(lse, lse_c)


# ---------------------------------------------------------------------------
# flash attention carry step (ring attention)
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, KV, hd, causal, window, q_offset, k_offset, carried):
#: an empty and a carried state, offsets with the block before, at and
#: after the q rows (d < 0: nothing visible), a window, ragged Skv, hd 64
#: and MQA; then the bf16 kernel's edges: Sq and Skv of 127, 129 and 257,
#: a window of 100, d = 50 (the diagonal mid-tile), MQA 48/1 at hd 64
CARRY_CASES = [
    (1, 256, 256, 32, 8, 128, True, 0, 0, 0, False),
    (1, 128, 128, 32, 8, 128, True, 0, 256, 128, True),
    (1, 128, 128, 32, 8, 128, True, 0, 128, 256, True),
    (2, 130, 1000, 8, 2, 64, False, 0, 64, 32, True),
    (1, 200, 200, 8, 2, 64, True, 70, 300, 100, True),
    (1, 96, 160, 48, 1, 128, False, 100, 0, 40, True),
    (1, 127, 129, 32, 8, 128, True, 0, 128, 0, True),
    (1, 257, 257, 32, 8, 128, True, 100, 0, 0, False),
    (1, 129, 257, 32, 8, 128, True, 0, 300, 250, True),
    (1, 257, 127, 8, 2, 128, False, 0, 0, 0, True),
    (1, 200, 129, 48, 1, 64, True, 0, 128, 0, True),
]
CARRY_TOL = [(torch.float32, 2e-5), (torch.bfloat16, 1e-4)]


def _carry_inputs(cuda, dtype, b, sq, skv, h, kvh, hd, carried, seed=0):
    """q, k, v in ``dtype`` and an f32 carry: empty, or the plain step of
    an earlier random block (so m, l and acc are not trivial)."""
    q, k, v, _ = _flash_inputs(cuda, dtype, b, sq, skv, h, kvh, hd, seed)
    carry = fa.init_partials(b, sq, h, hd, device=cuda)
    if carried:
        _, k0, v0, _ = _flash_inputs(cuda, torch.float32, b, sq, 64, h, kvh,
                                     hd, seed + 1)
        carry = fa.flash_attention_step_torch(q.float(), k0, v0, *carry,
                                              causal=False)
    return q, k, v, carry


def _carry_close(got, want, tol, what):
    """m, l, acc within ``tol`` of the largest magnitude of each; rows
    that see nothing keep the sentinel m = -1e30 exactly."""
    m, want_m = got[0], want[0]
    dead = want_m <= -1e29
    assert torch.equal(m[dead], want_m[dead]), f"{what}: m of masked rows"
    for name, g, w in (("m", m[~dead], want_m[~dead]), ("l", got[1], want[1]),
                       ("acc", got[2], want[2])):
        if w.numel() == 0:
            continue
        err = (g - w).abs().max().item()
        scale = max(w.abs().max().item(), 1e-30)
        assert err <= tol * scale, \
            f"{what} {name}: max|err| {err:.3e} > {tol} x {scale:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", CARRY_TOL)
@pytest.mark.parametrize("case", CARRY_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_carry_kernel_matches_plain(cuda, dtype, tol, case):
    """The carry kernel against ``flash_attention_step_torch`` on the same
    (upcast) inputs: m, l and acc within 2e-5 (f32 inputs) / 1e-4 (bf16)
    of their largest magnitudes; the inputs are left as they were."""
    b, sq, skv, h, kvh, hd, causal, window, q_off, k_off, carried = case
    q, k, v, carry = _carry_inputs(cuda, dtype, b, sq, skv, h, kvh, hd,
                                   carried)
    before = [t.clone() for t in carry]
    kw = dict(causal=causal, window=window, q_offset=q_off, k_offset=k_off)
    c0 = fa.CARRY_LAUNCHES
    got = fa.flash_attention_carry(q, k, v, *carry, **kw)
    torch.cuda.synchronize()
    assert fa.CARRY_LAUNCHES == c0 + 1
    want = fa.flash_attention_step_torch(q.float(), k.float(), v.float(),
                                         *carry, **kw)
    _carry_close(got, want, tol, str(case))
    for t, t0 in zip(carry, before):
        assert torch.equal(t, t0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", CARRY_TOL)
def test_flash_carry_kernel_in_place(cuda, dtype, tol):
    """The launch with the *_out pointers equal to the *_in ones (each CTA
    reads only the rows it writes) against the plain step, at the
    tolerances of the out-of-place test."""
    b, sq, skv, h, kvh, hd = 1, 257, 300, 8, 2, 128
    q, k, v, carry = _carry_inputs(cuda, dtype, b, sq, skv, h, kvh, hd,
                                   True)
    kw = dict(causal=True, window=0, q_offset=200, k_offset=0)
    want = fa.flash_attention_step_torch(q.float(), k.float(), v.float(),
                                         *carry, **kw)
    m, l, acc = (t.clone() for t in carry)
    lib = fa._lib()
    err = lib.flash_attention_carry_launch(
        1 if dtype == torch.bfloat16 else 0, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), b, sq, skv, h, kvh, hd,
        kw["q_offset"], kw["k_offset"], kw["window"], 1, 1.0 / math.sqrt(hd),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    _carry_close((m, l, acc), want, tol, "in place")


@pytest.mark.gpu
def test_flash_carry_kernel_leaves_invisible_blocks_bit_for_bit(cuda):
    """A block wholly after the q rows (causal) or wholly outside the
    window leaves the carry exactly as it came in; an empty carry over a
    fully masked row stays (-1e30, 0, 0)."""
    q, k, v, carry = _carry_inputs(cuda, torch.float32, 1, 130, 70, 8, 2,
                                   64, True)
    for kw in (dict(causal=True, q_offset=0, k_offset=130),
               dict(causal=False, window=16, q_offset=500, k_offset=0)):
        got = fa.flash_attention_carry(q, k, v, *carry, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, carry):
            assert torch.equal(g, w), kw
    empty = fa.init_partials(1, 130, 8, 64, device=cuda)
    m, l, acc = fa.flash_attention_carry(q, k, v, *empty, causal=True,
                                         window=4, q_offset=100,
                                         k_offset=0)
    torch.cuda.synchronize()
    assert (m == -1e30).all() and (l == 0).all() and (acc == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 150)])
def test_flash_carry_virtual_ring_equals_flash_forward(cuda, dtype, causal,
                                                       window):
    """One card folds the kv blocks of 4 virtual ranks in ring order
    (k_offset = src * 128, invisible blocks skipped, later steps carried)
    and, finalized, equals the flash forward over the whole sequence:
    out within 2e-5 (f32) / 2e-2 (bf16, whose forward output is rounded)
    of its largest magnitude, lse within 1e-4."""
    n, blk = 4, 128
    q, k, v, _ = _flash_inputs(cuda, dtype, 1, n * blk, n * blk, 8, 2, 128)
    want_out, want_lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                                window=window)
    outs, lses = [], []
    for rank in range(n):
        qb = q[:, rank * blk:(rank + 1) * blk].contiguous()
        carry = fa.init_partials(1, blk, 8, 128, device=cuda)
        for s in range(n):
            src = (rank - s) % n
            lo = src * blk
            if causal and lo > rank * blk + blk - 1:
                continue
            if window and rank * blk - (lo + blk - 1) >= window:
                continue
            carry = fa.flash_attention_carry(
                qb, k[:, lo:lo + blk].contiguous(),
                v[:, lo:lo + blk].contiguous(), *carry, causal=causal,
                window=window, q_offset=rank * blk, k_offset=lo)
        out, lse = fa.finalize_partials(*carry)
        outs.append(out)
        lses.append(lse)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    _close(torch.cat(outs, dim=1), want_out, tol, "out")
    _close(torch.cat(lses, dim=1), want_lse, 1e-4, "lse")


@pytest.mark.gpu
def test_flash_carry_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, carry = _carry_inputs(cuda, torch.float32, 1, 64, 64, 4, 2,
                                   128, False)
    with pytest.raises(TypeError):
        fa.flash_attention_carry(q, k, v, carry[0].double(), *carry[1:])
    with pytest.raises(ValueError):
        fa.flash_attention_carry(q, k, v, *fa.init_partials(
            1, 64, 4, 128, device="cpu"))
    with pytest.raises(ValueError):
        fa.flash_attention_carry(q, k, v, carry[0][:, :32], *carry[1:])
    q32, k32, v32, c32 = _carry_inputs(cuda, torch.float32, 1, 64, 64, 4,
                                       2, 32, False)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_carry(q32, k32, v32, *c32)
    c0 = fa.CARRY_LAUNCHES
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_attention_carry(q.bfloat16(), _misaligned(k.bfloat16()),
                                 v.bfloat16(), *carry)
    assert fa.CARRY_LAUNCHES == c0


@pytest.mark.gpu
def test_flash_backward_twice_agrees(cuda):
    """The bf16 backward run twice on the same inputs.  Its f32 workspaces
    sum the CTAs' contributions with atomics, in an order that changes
    from run to run, so the two runs may differ in the last bits of the
    f32 sums: within 1e-6 of the largest magnitude before the bf16
    rounding, and so within one bf16 rounding (2e-2, as against the plain
    version) after it."""
    q, k, v, dout = _flash_inputs(cuda, torch.bfloat16, 2, 256, 256, 32, 8,
                                  128)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    first = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    second = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    dsum = (dout.float() * out.float()).sum(-1)
    blocks = [fa.flash_attention_bwd_block(q, k, v, dout, lse, dsum,
                                           causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        _close(a, b, 2e-2, name)
    for name, a, b in zip(("dq", "dk", "dv"), *blocks):
        _close(a, b, 1e-6, f"block {name}")


@pytest.mark.gpu
def test_flash_backward_rejects_misaligned_bases(cuda):
    """TMA, which feeds the bf16 backward, needs 16-byte aligned bases:
    the launcher refuses others and the wrappers raise without counting."""
    q, k, v, dout = _flash_inputs(cuda, torch.bfloat16, 1, 64, 64, 4, 2, 128)
    out, lse = fa.flash_attention_fwd(q, k, v)
    dsum = (dout.float() * out.float()).sum(-1)
    b0, k0 = fa.BWD_LAUNCHES, fa.BWD_BLOCK_LAUNCHES
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_attention_bwd(q, k, v, out, lse, _misaligned(dout))
    with pytest.raises(RuntimeError, match="misaligned"):
        fa.flash_attention_bwd_block(q, _misaligned(k), v, dout, lse, dsum,
                                     causal=True)
    assert (fa.BWD_LAUNCHES, fa.BWD_BLOCK_LAUNCHES) == (b0, k0)


# ---------------------------------------------------------------------------
# ring attention's block backward
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, KV, hd, causal, window, q_offset, k_offset): the block
#: before the q rows, on the diagonal, a window, a negative offset
#: difference (not causal, and causal with part visible), G = 1, 4, 48,
#: ragged Sq and Skv, and a block that nothing sees
BLOCK_CASES = [
    (1, 256, 256, 32, 8, 128, True, 0, 256, 0),
    (1, 256, 256, 32, 8, 128, True, 0, 256, 256),
    (1, 200, 300, 8, 2, 64, True, 100, 300, 150),
    (2, 130, 129, 48, 1, 128, False, 0, 0, 500),
    (1, 127, 257, 8, 8, 128, True, 0, 100, 0),
    (1, 96, 160, 16, 4, 64, True, 0, 0, 64),
    (1, 64, 64, 8, 2, 128, True, 0, 0, 128),
]


def _block_inputs(cuda, dtype, b, sq, skv, h, kvh, hd, causal, window,
                  q_offset, k_offset, seed=0):
    """q, k, v, dout in ``dtype``; lse of the plain forward over this
    block and dsum = sum(dout * out), both f32 (so p <= 1)."""
    q, k, v, dout = _flash_inputs(cuda, dtype, b, sq, skv, h, kvh, hd, seed)
    out, lse = fa.flash_attention_torch(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        q_offset=q_offset - k_offset)
    return q, k, v, dout, lse.contiguous(), (dout.float() * out).sum(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BLOCK_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_block_backward_matches_plain(cuda, dtype, case):
    """The block backward's f32 outputs against
    ``flash_attention_bwd_block_torch`` run in f32 on the same (upcast)
    inputs, within 1e-4 of the largest magnitude of each, in both types:
    the bf16 kernel keeps P and dS as bf16 hi/lo pairs (to about 2^-17);
    one bf16 rounding of either would miss this tolerance."""
    b, sq, skv, h, kvh, hd, causal, window, qo, ko = case
    q, k, v, dout, lse, dsum = _block_inputs(cuda, dtype, *case)
    kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko)
    c0 = fa.BWD_BLOCK_LAUNCHES
    got = fa.flash_attention_bwd_block(q, k, v, dout, lse, dsum, **kw)
    torch.cuda.synchronize()
    assert fa.BWD_BLOCK_LAUNCHES == c0 + 1
    want = fa.flash_attention_bwd_block_torch(
        q.float(), k.float(), v.float(), dout.float(), lse, dsum, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all(), name
        err = (g - w).abs().max().item()
        scale = max(w.abs().max().item(), 1e-30)
        assert err <= 1e-4 * scale or err == 0.0, \
            f"{name}: max|err| {err:.3e} > 1e-4 x {scale:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_block_backward_virtual_ring_equals_one_rank(cuda, dtype):
    """One card plays a causal 4-rank ring: each rank's q block against
    every kv block it sees (k_offset = src * 128), dq summed per q block
    and dk, dv per kv block, equals the block backward over the whole
    sequence at one rank, within 1e-4 of the largest magnitude (f32 sums
    taken in another order)."""
    n, blk, h, kvh, hd = 4, 128, 8, 2, 128
    q, k, v, dout, lse, dsum = _block_inputs(cuda, dtype, 1, n * blk,
                                             n * blk, h, kvh, hd, True, 0,
                                             0, 0)
    want = fa.flash_attention_bwd_block(q, k, v, dout, lse, dsum,
                                        causal=True)
    dq = torch.zeros_like(want[0])
    dk = torch.zeros_like(want[1])
    dv = torch.zeros_like(want[2])
    rows = [slice(r * blk, (r + 1) * blk) for r in range(n)]
    for rank in range(n):
        for src in range(rank + 1):
            gq, gk, gv = fa.flash_attention_bwd_block(
                q[:, rows[rank]].contiguous(), k[:, rows[src]].contiguous(),
                v[:, rows[src]].contiguous(),
                dout[:, rows[rank]].contiguous(),
                lse[:, rows[rank]].contiguous(),
                dsum[:, rows[rank]].contiguous(), causal=True,
                q_offset=rank * blk, k_offset=src * blk)
            dq[:, rows[rank]] += gq
            dk[:, rows[src]] += gk
            dv[:, rows[src]] += gv
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), f"{name}: {err:.3e}"


# ---------------------------------------------------------------------------
# Jacobi stencil: one sweep and k sweeps per round trip
# ---------------------------------------------------------------------------

#: ragged (not multiples of the kernels' tiles or row strips),
#: tiny, and the reference tests' shapes
STENCIL_SHAPES = [(1000, 777), (3, 3), (5, 130), (66, 130), (258, 514)]
STENCIL_TOL = [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)]


def _grid(cuda, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(cuda).to(dtype) for _ in range(2)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", STENCIL_TOL)
@pytest.mark.parametrize("shape", STENCIL_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_step_kernel_matches_plain(cuda, dtype, tol, shape):
    """One sweep with Dirichlet rows, with halo rows, and the interleaved
    schedule's interior and edge-row passes into a prefilled ``out``
    (rows outside ``rows`` untouched), against the plain version; f32
    within 1e-6 and bf16 within 2e-2 of the largest magnitude."""
    u, f = _grid(cuda, dtype, shape, 3)
    lo, hi = _grid(cuda, dtype, (1, shape[1]), 4)
    m = shape[0]
    for kw in ({}, {"lo": lo, "hi": hi}):
        before = stencil.STEP_LAUNCHES
        got = stencil.jacobi_step(u, f, **kw)
        torch.cuda.synchronize()
        assert stencil.STEP_LAUNCHES == before + 1
        want = stencil.jacobi_step(u, f, engine="torch", **kw)
        assert got.dtype == dtype
        _close(got, want, tol, f"jacobi_step {sorted(kw)}")
    for rows, kw in ((((1, m - 1),), {}),
                     (((0, 1), (m - 1, m)), {"lo": lo, "hi": hi})):
        out = torch.full_like(u, 7.0)
        stencil.jacobi_step(u, f, rows=rows, out=out, **kw)
        torch.cuda.synchronize()
        want = torch.full_like(u, 7.0)
        stencil.jacobi_step(u, f, rows=rows, out=want, engine="torch", **kw)
        _close(out, want, tol, f"jacobi_step rows={rows}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", STENCIL_TOL)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(64, 130), (1000, 777), (5, 130)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_ksweep_kernel_matches_plain(cuda, dtype, tol, k, shape):
    """k sweeps on a slab with a live k-row apron, frozen depths (0, 0),
    (k, k) and (k+1, k+1), against the plain trapezoid; in f32 with
    (0, 0) also against k sweeps of the larger grid in which every row
    updates (tests/test_kernels.py::test_jacobi_ksweep_slab_interior)."""
    m, n = shape
    big, fbig = _grid(cuda, dtype, (m + 2 * k, n), 9)
    for ft, fb in ((0, 0), (k, k), (k + 1, k + 1)):
        before = stencil.KSWEEP_LAUNCHES
        got = stencil.jacobi_ksweep(big, fbig, k, ft, fb)
        torch.cuda.synchronize()
        assert stencil.KSWEEP_LAUNCHES == before + 1
        want = stencil.jacobi_ksweep(big, fbig, k, ft, fb, engine="torch")
        assert got.shape == (m, n) and got.dtype == dtype
        _close(got, want, tol, f"frozen ({ft}, {fb})")
    if dtype == torch.float32:
        want = big.clone()
        z = torch.zeros((1, n), device=cuda)
        for _ in range(k):
            up = torch.cat([z, want, z])
            want[:, 1:-1] = 0.25 * (up[:-2, 1:-1] + up[2:, 1:-1]
                                    + up[1:-1, :-2] + up[1:-1, 2:]
                                    - fbig[:, 1:-1])
        _close(stencil.jacobi_ksweep(big, fbig, k, 0, 0), want[k:-k], tol,
               "slab interior")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_jacobi_multistep_kernel_equals_k_unit_sweeps(cuda, k):
    """The temporally-blocked kernel against k launches of the one-sweep
    kernel (bit for bit: the same f32 operations in the same order)."""
    u, f = _grid(cuda, torch.float32, (258, 514), 7)
    got = stencil.jacobi_multistep(u, f, k=k)
    want = u
    for _ in range(k):
        want = stencil.jacobi_step(want, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("periodic", [False, True])
def test_jacobi_solve_kernel_path_matches_plain_path(cuda, periodic):
    """Every schedule through the kernels against the plain versions pinned
    (rtol = atol = 1e-5, as tests/dist_suite/test_halo.py), with exact
    launch counts: a row-4 launch per bulk sweep, two per interleaved
    sweep, and 19 // k row-5 launches plus 19 % k row-4 launches."""
    u, f = _grid(cuda, torch.float32, (130, 258), 11)
    iters = 19
    want = halo.jacobi_solve(u, f, None, iters, "bulk", periodic=periodic,
                             engine="torch")
    for mode, k, launches in (("bulk", 1, (iters, 0)),
                              ("interleaved", 1, (2 * iters, 0)),
                              ("aggregated", 2, (1, 9)),
                              ("aggregated", 4, (3, 4)),
                              ("aggregated", 8, (3, 2))):
        s0, k0 = stencil.STEP_LAUNCHES, stencil.KSWEEP_LAUNCHES
        got = halo.jacobi_solve(u, f, None, iters, mode, k=k,
                                periodic=periodic)
        torch.cuda.synchronize()
        assert (stencil.STEP_LAUNCHES - s0,
                stencil.KSWEEP_LAUNCHES - k0) == launches, (mode, k)
        plain = halo.jacobi_solve(u, f, None, iters, mode, k=k,
                                  periodic=periodic, engine="torch")
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_jacobi_kernels_reject_what_they_do_not_take(cuda):
    u, f = _grid(cuda, torch.float32, (66, 130), 0)
    with pytest.raises(TypeError):
        stencil.jacobi_step(u.half(), f.half())
    with pytest.raises(TypeError):
        stencil.jacobi_step(u, f.bfloat16())
    with pytest.raises(ValueError):
        stencil.jacobi_step(u.t().contiguous().t(), f.t().contiguous().t())
    with pytest.raises(ValueError, match="shared memory"):
        stencil.jacobi_ksweep(u, f, 32, 0, 0)


@pytest.mark.gpu
def test_bf16_loss_cuda_branch_keeps_the_f32_accumulator(cuda):
    """The CUDA branch of the loss's logits (``aten::mm.dtype`` forward,
    bf16 backward): the logits within 1e-4 of the f32 product of the same
    bf16 operands, which the bf16-rounded product (about 2^-9 of each
    logit) misses; the loss within 1e-5 (relative) and its gradients
    within 2e-2 of their largest magnitude of the CPU branch, which
    tests/test_torch_train.py holds to the reference."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import layers
    from repro_torch.parallel.sharding import MeshCtx

    cfg = get_reduced("phi4-mini-3.8b")
    b, s, d, v = 2, 64, 3072, 1024
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(b, s, d))).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(d, v)) * 3.0 / np.sqrt(d)) \
        .to(torch.bfloat16)
    tokens = rng.integers(0, v, size=(b, s)).astype(np.int32)
    tokens[:, -3:] = -1                                  # ignored labels
    tokens = torch.from_numpy(tokens)

    want_logits = x.double() @ w.double()                # exact products
    got_logits = layers.logits_f32(x.to(cuda), w.to(cuda))
    assert got_logits.dtype == torch.float32
    torch.testing.assert_close(got_logits.cpu().double(), want_logits,
                               rtol=0, atol=1e-4)

    results = []
    for dev in (cuda, torch.device("cpu")):
        tx = x.to(dev).requires_grad_()
        tw = w.to(dev).requires_grad_()
        loss, count = layers.lm_loss_sp(tx, tw, tokens.to(dev), cfg,
                                        MeshCtx(), chunk=16)
        assert loss.dtype == torch.float32 and count.item() == b * (s - 3)
        dx, dw = torch.autograd.grad(loss, (tx, tw))
        assert dx.dtype == dw.dtype == torch.bfloat16
        results.append((loss.item(), dx.float().cpu(), dw.float().cpu()))
    (loss, dx, dw), (want_loss, want_dx, want_dw) = results
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for got, want, name in ((dx, want_dx, "dx"), (dw, want_dw, "dw")):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-2 * want.abs().max().item(),
                                   msg=name)


# ---------------------------------------------------------------------------
# Grouped-expert FFN
# ---------------------------------------------------------------------------

#: (G, C, D, F, E): one group per expert, gpe = 2 and 4, sizes that are no
#: multiple of the kernel's tiles, and the moonshot prefill's call
GROUPED_SHAPES = [(4, 16, 8, 12, 4), (8, 32, 8, 16, 2), (3, 257, 130, 70, 3),
                  (6, 100, 200, 77, 3), (64, 480, 2048, 1408, 64)]
GROUPED_TOL = [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)]


def _grouped_inputs(cuda, dtype, shape, seed):
    """Valid counts of 0, C and between; 1e3-scale garbage past them."""
    g, c, d, f, e = shape
    rng = np.random.default_rng(seed)
    valid = rng.integers(0, c + 1, size=g).astype(np.int32)
    valid[0], valid[-1] = 0, c
    h = rng.normal(size=(g, c, d)).astype(np.float32)
    rows = np.arange(c)[None, :, None]
    h = np.where(rows < valid[:, None, None], h,
                 1e3 * rng.normal(size=h.shape).astype(np.float32))
    ws = [(rng.normal(size=s) * 0.1).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    return ([torch.from_numpy(a).to(cuda).to(dtype) for a in (h, *ws)],
            torch.from_numpy(valid).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", GROUPED_TOL)
@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("shape", GROUPED_SHAPES, ids=str)
def test_grouped_ffn_kernel_matches_plain(cuda, dtype, tol, mlp, shape):
    """The kernel against the plain version on the same inputs, in f32:
    within tol x max(1, max|want|) (f32 1e-5, bf16 2e-2), padded rows
    exactly zero, one launch counted."""
    (h, w1, w1g, w2), valid = _grouped_inputs(cuda, dtype, shape,
                                              sum(shape))
    w1g = w1g if gm.gated(mlp) else None
    before = gm.GROUPED_LAUNCHES
    got = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp=mlp)
    torch.cuda.synchronize()
    assert gm.GROUPED_LAUNCHES == before + 1
    want = gm.grouped_expert_ffn_torch(
        h.float(), w1.float(), None if w1g is None else w1g.float(),
        w2.float(), valid, mlp)
    _close(got, want, tol, f"{mlp} {shape}")
    pad = (torch.arange(shape[1], device=cuda)[None, :, None]
           >= valid[:, None, None]).expand_as(got)
    assert torch.equal(got[pad].float(), torch.zeros_like(got[pad].float()))


@pytest.mark.gpu
def test_grouped_ffn_kernel_rejects_what_it_does_not_take(cuda):
    (h, w1, w1g, w2), valid = _grouped_inputs(cuda, torch.float32,
                                              (4, 16, 8, 12, 2), 0)
    with pytest.raises(TypeError):
        gm.grouped_expert_ffn(h, w1.bfloat16(), w1g, w2, valid,
                              mlp="swiglu")
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_expert_ffn(h.transpose(1, 2).contiguous().transpose(1, 2),
                              w1, w1g, w2, valid, mlp="swiglu")
    with pytest.raises(ValueError, match="devices"):
        gm.grouped_expert_ffn(h, w1, w1g, w2, valid.cpu(), mlp="swiglu")
    with pytest.raises(RuntimeError, match="launch failed"):
        # more groups than a grid's z dimension takes: the launch refuses
        big = torch.zeros((65536, 1, 8), device=cuda)
        gm.grouped_expert_ffn_cuda(
            big, w1[:1].contiguous(), w1g[:1].contiguous(),
            w2[:1].contiguous(),
            torch.zeros(65536, dtype=torch.int32, device=cuda), "swiglu")
