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


def _split_inputs(cuda, dtype, kvh, groups, hd, page, seed):
    """Chains that the card's split plan cuts several times: lens just
    below, at and above a split boundary, lens == 0, lens = pmax * page and
    past it, a long chain with a page id outside the pool in its middle,
    and garbage ids (in and out of the pool) past every chain.  Returns
    the tensors and the split boundary in positions."""
    b, pmax = 8, 40
    npool = b * pmax + 10
    rng = np.random.default_rng(seed)
    q, kp, vp, table, _ = _paged_inputs(rng, b, kvh * groups, kvh, hd, page,
                                        pmax, npool)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, table)]
    plan = paged.launch_plan(args[0].to(torch.bfloat16), args[1],
                             args[3])
    bnd = plan.pages_per_split * page
    lens = np.array([bnd - 1, bnd, bnd + 1, 0, pmax * page,
                     pmax * page + 7, 2 * bnd + 5, 1], np.int32)
    for i in range(b):
        used = min(pmax, -(-int(lens[i]) // page))
        table[i, used:] = rng.integers(-npool, 3 * npool, size=pmax - used)
    table[6, plan.pages_per_split + 1] = npool + 5     # mid-chain, no page
    args[3] = torch.from_numpy(table).to(cuda)
    args.append(torch.from_numpy(lens).to(cuda))
    for i in range(3):
        args[i] = args[i].to(dtype)
    return args, bnd


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hd", [32, 64, 128, 192])
@pytest.mark.parametrize("kvh,groups", [(4, 1), (2, 4), (2, 6), (1, 12),
                                        (1, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", ["none", "mid", "short"])
def test_paged_attention_split_kv_edges(cuda, dtype, kvh, groups, hd, page,
                                        window):
    """The kernel against the plain version in f32 (f32 atol 1e-4; bf16
    atol/rtol 2e-2) where split-KV can go wrong: lens around a split
    boundary, a window that starts mid-split ("mid") or empties all but
    the last split of the long chains ("short"), an out-of-pool page
    mid-chain, lens at and past pmax * page; lens == 0 gives exact
    zeros.  bf16 runs the split-KV fast path (hd 192 is nemotron's), f32
    the SIMT kernel."""
    args, bnd = _split_inputs(cuda, dtype, kvh, groups, hd, page,
                              seed=kvh * groups + hd + page)
    win = {"none": 0, "mid": bnd // 2 + 3, "short": 5}[window]
    plan = paged.launch_plan(args[0], args[1], args[3])
    if dtype == torch.bfloat16:
        assert plan.engine == "mma" and plan.n_splits > 3
    else:
        assert plan.engine == "simt"
    before = paged.LAUNCHES
    got = paged.paged_attention(*args, window=win)
    torch.cuda.synchronize()
    assert paged.LAUNCHES == before + 1
    want = paged.paged_attention_torch(
        *[a.float() if i < 3 else a for i, a in enumerate(args)],
        window=win)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    rtol = 0.0 if dtype == torch.float32 else tol
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=tol)
    assert torch.equal(got[3].float(), torch.zeros_like(got[3].float()))


def assert_split_partials_close(got, want, rel=1e-4):
    """Each split's f32 partials (m, l, acc) from the card against the
    plain ones on the same inputs in f32: m and l within ``rel`` of their
    size, acc within ``rel`` of the largest |acc| of its split.  P in bf16
    instead of the kernel's hi + lo pair moves acc by about 1e-3 of it."""
    (m, l, acc), (m_ref, l_ref, acc_ref) = got, want
    torch.testing.assert_close(l, l_ref, rtol=rel, atol=0.0)
    live = l_ref > 0
    torch.testing.assert_close(m[live], m_ref[live], rtol=rel, atol=rel)
    assert bool((m[~live] == m_ref[~live]).all())
    size = acc_ref.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)
    worst = ((acc - acc_ref).abs() / size).max().item()
    assert worst <= rel, f"acc off by {worst:.3e} of its size (> {rel})"


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 64, 128, 192])
@pytest.mark.parametrize("kvh,groups", [(4, 1), (2, 4), (2, 6), (1, 12),
                                        (1, 48)])
@pytest.mark.parametrize("window", ["none", "mid"])
def test_paged_attention_split_partials_keep_p_in_f32(cuda, kvh, groups, hd,
                                                      window):
    """P stays f32 in P.V on the fast path (the TPU kernel's f32 product):
    the f32 partials of every split, read from the card's workspace, equal
    the plain version's in f32 on the same bf16 inputs within 1e-4 of
    their size, which the bf16 output cannot show."""
    args, bnd = _split_inputs(cuda, torch.bfloat16, kvh, groups, hd, 16,
                              seed=7 * groups + hd)
    win = {"none": 0, "mid": bnd // 2 + 3}[window]
    plan, got = paged.split_partials(*args, window=win)
    torch.cuda.synchronize()
    want = paged.split_partials_torch(
        *[a.float() if i < 3 else a for i, a in enumerate(args)],
        plan.pages_per_split, window=win)
    assert got[2].shape == want[2].shape == (plan.n_splits, *args[0].shape)
    assert_split_partials_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [4, 48])
def test_paged_attention_split_kv_is_deterministic_and_graph_safe(cuda,
                                                                  groups):
    """Two calls give the same bits (the splits merge in a fixed order),
    and the wrapper captured in a CUDA graph and replayed gives the eager
    call's bits: it reads nothing back from the card."""
    kvh = 8 if groups == 4 else 1
    args, _ = _split_inputs(cuda, torch.bfloat16, kvh, groups, 128, 16,
                            seed=groups)
    first = paged.paged_attention(*args)
    second = paged.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged.paged_attention(*args)          # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = paged.paged_attention(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)


@pytest.mark.gpu
def test_paged_attention_rejects_unaligned_pool(cuda):
    """The fast path's 16-byte copies need 16-byte aligned bases: a pool
    that starts 2 bytes into its buffer is refused, not read."""
    args, _ = _split_inputs(cuda, torch.bfloat16, 2, 4, 64, 16, seed=3)
    kp = args[1]
    buf = torch.empty(kp.numel() + 1, dtype=kp.dtype, device=cuda)
    shifted = buf[1:].view(kp.shape)
    shifted.copy_(kp)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte"):
        paged.paged_attention(args[0], shifted, args[2], args[3], args[4])


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
#: hd 64 and 128; hd 16 (the reduced configs, SIMT kernels in both types)
#: at the quickstart's shape and ragged with a window; hd 192
#: (nemotron-4-340b, whose bf16 kernels take 64 kv rows a stage or a CTA):
#: GQA 12:1, MHA and MQA 12/1, causal and windowed, ragged Skv and
#: q_offset; then the edges of the hd-192 backward's clusters of two kv
#: tiles: an odd number of kv tiles (Skv 192, 320), Skv = 64 k + 1 (65),
#: a cluster whose upper CTA has no rows (Skv 64, 192, 320), causal with
#: q_offset > 0 and Sq < Skv, a window smaller than a tile, G = 1 and 12,
#: B = 2; then edges of the hd-192 forward (2 stages of 64 kv rows): one
#: kv tile for every CTA (Skv <= 64), and odd tile counts that wrap the
#: ring (7 and 11 tiles)
FLASH_CASES = [
    (8, 128, 128, 4, 1, 16, True, 0, 0),
    (1, 100, 127, 8, 2, 16, True, 30, 27),
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
    (1, 256, 256, 24, 2, 192, True, 0, 0),
    (2, 129, 129, 4, 4, 192, True, 0, 0),
    (1, 100, 257, 12, 1, 192, False, 64, 0),
    (1, 190, 257, 24, 2, 192, True, 30, 67),
    (1, 65, 127, 8, 8, 192, True, 0, 62),
    (1, 300, 300, 12, 1, 192, True, 0, 0),
    (1, 192, 192, 12, 1, 192, True, 0, 0),
    (2, 320, 320, 8, 8, 192, True, 0, 0),
    (1, 100, 65, 4, 4, 192, True, 0, 0),
    (1, 64, 64, 8, 2, 192, False, 0, 0),
    (2, 129, 320, 24, 2, 192, True, 20, 191),
    (1, 70, 192, 12, 12, 192, True, 0, 122),
    (2, 130, 50, 12, 1, 192, False, 0, 0),
    (1, 200, 430, 24, 2, 192, False, 0, 0),
    (1, 704, 704, 8, 2, 192, True, 0, 0),
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
@pytest.mark.parametrize("h,kvh,hd", [(32, 8, 128), (24, 2, 192)])
def test_flash_forward_equals_finalized_empty_carry_bit_for_bit(cuda, h, kvh,
                                                                hd):
    """In bf16 the forward and the carry step are one kernel: at an empty
    carry, finalized as ring attention finalizes it, the carry gives the
    forward's output and lse bit for bit (phi4-mini's heads, and
    nemotron's head_dim and 12:1 grouping, 1 x 1024, causal), which is
    what makes the one-rank ring prefill equal megatron's."""
    q, k, v, _ = _flash_inputs(cuda, torch.bfloat16, 1, 1024, 1024, h, kvh,
                               hd)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    carry = fa.flash_attention_carry(
        q, k, v, *fa.init_partials(1, 1024, h, hd, device=cuda),
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
#: a window of 100, d = 50 (the diagonal mid-tile), MQA 48/1 at hd 64;
#: then hd 192 (64-row kv stages) empty, carried, windowed and ragged;
#: then the hd-192 kernel's edges: one kv tile (Skv <= 64), none (d < 0:
#: every row copied through), and 7 tiles that wrap its 2-stage ring,
#: carried
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
    (1, 130, 200, 4, 1, 16, True, 0, 128, 64, True),
    (1, 256, 256, 24, 2, 192, True, 0, 0, 0, False),
    (1, 129, 257, 24, 2, 192, True, 100, 300, 250, True),
    (1, 257, 127, 4, 4, 192, False, 0, 0, 0, True),
    (1, 200, 129, 12, 1, 192, True, 0, 128, 0, True),
    (1, 129, 64, 24, 2, 192, False, 0, 0, 0, True),
    (1, 128, 128, 24, 2, 192, True, 0, 0, 200, True),
    (2, 130, 448, 12, 1, 192, False, 0, 0, 0, True),
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
@pytest.mark.parametrize("dtype,tol", CARRY_TOL)
def test_flash_carry_kernel_in_place_hd192(cuda, dtype, tol):
    """The hd-192 carry step with the *_out pointers equal to the *_in
    ones, carried, over 5 kv tiles a CTA and the diagonal, against the
    plain step at the out-of-place tolerances."""
    b, sq, skv, h, kvh, hd = 1, 257, 300, 12, 1, 192
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


def _trend_inputs(cuda, trend, b=1, s=384, h=12, kvh=1, hd=192, seed=3):
    """bf16 q, k, v whose logits rise along the keys (``"rising"``: each
    64-key tile raises every row's max, so no alpha is 1) or peak in the
    first 8 keys (``"first"``: after a row's first tile its max never
    moves, so every later alpha is exactly 1)."""
    rng = np.random.default_rng(seed)
    u = np.ones(hd, np.float32) / math.sqrt(hd)
    if trend == "rising":
        lift = 16.0 * np.arange(s, dtype=np.float32) / s
    else:
        lift = np.where(np.arange(s) < 8, 16.0, 0.0).astype(np.float32)
    q = 16.0 * u + 0.1 * rng.normal(size=(b, s, h, hd))
    k = lift[None, :, None, None] * u + 0.1 * rng.normal(
        size=(b, s, kvh, hd))
    v = rng.normal(size=(b, s, kvh, hd))
    return [torch.from_numpy(x.astype(np.float32)).to(cuda).bfloat16()
            for x in (q, k, v)]


@pytest.mark.gpu
@pytest.mark.parametrize("trend", ["rising", "first"])
def test_flash192_rescale_skip_both_branches(cuda, trend):
    """The hd-192 forward and carry skip acc *= alpha where every alpha of
    a warp is exactly 1: held to the plain versions where the max moves
    on every tile (no skip) and where it never moves after a row's first
    tile (a skip on every later tile), causal and not."""
    q, k, v = _trend_inputs(cuda, trend)
    b, s, h, hd = q.shape
    for causal in (True, False):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_carry(
            q, k, v, *fa.init_partials(b, s, h, hd, device=cuda),
            causal=causal)
        torch.cuda.synchronize()
        want_out, want_lse = fa.flash_attention_torch(
            q.float(), k.float(), v.float(), causal=causal)
        _close(out, want_out, 2e-2, f"{trend} causal={causal} out")
        _close(lse, want_lse, 1e-4, f"{trend} causal={causal} lse")
        want = fa.flash_attention_step_torch(
            q.float(), k.float(), v.float(),
            *fa.init_partials(b, s, h, hd, device=cuda), causal=causal)
        _carry_close(got, want, 1e-4, f"{trend} causal={causal} carry")


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
@pytest.mark.parametrize("batch,s,h,kvh,hd", [(2, 256, 32, 8, 128),
                                              (1, 320, 24, 2, 192)])
def test_flash_backward_twice_agrees(cuda, batch, s, h, kvh, hd):
    """The bf16 backward run twice on the same inputs.  Its f32 workspaces
    sum the CTAs' contributions with atomics, in an order that changes
    from run to run, so the two runs may differ in the last bits of the
    f32 sums: within 1e-6 of the largest magnitude before the bf16
    rounding, and so within one bf16 rounding (2e-2, as against the plain
    version) after it.  At hd 192 the clusters' partials meet in one CTA
    before the sum."""
    q, k, v, dout = _flash_inputs(cuda, torch.bfloat16, batch, s, s, h,
                                  kvh, hd)
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


@pytest.mark.gpu
def test_flash_bwd192_built_kernel_matches_its_plan(cuda):
    """The built hd-192 backward's geometry (kv rows a CTA, CTAs a
    cluster, shared memory, threads, the L2 chunk) is
    ``flash_attention.bwd192_plan``'s, and the card keeps clusters of it
    resident (at most one CTA an SM: the plan's count is an upper
    bound)."""
    built = fa.bwd192_built()
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = fa.bwd192_plan(1, 4096, 4096, 96, 8, True, n_sm=n_sm)
    assert (built["kv_rows"], built["cluster"], built["smem"],
            built["threads"]) == (plan.kv_rows, plan.cluster, plan.smem,
                                  plan.threads)
    assert built["l2_chunk"] == fa.BWD192_L2_CHUNK
    assert 1 <= built["resident"] <= plan.resident


@pytest.mark.gpu
def test_flash_fwd192_built_kernel_matches_its_plan(cuda):
    """The built hd-192 forward's geometry (query rows a CTA, kv rows a
    stage, stages, threads, shared memory) is
    ``flash_attention.fwd192_plan``'s, and the card keeps one CTA of it
    on each SM."""
    built = fa.fwd192_built()
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = fa.fwd192_plan(1, 4096, 4096, 96, 8, True, n_sm=n_sm)
    assert (built["q_rows"], built["kv_rows"], built["stages"],
            built["threads"], built["smem"]) == (
        plan.q_rows, plan.kv_rows, plan.stages, plan.threads, plan.smem)
    assert built["resident"] == 1 and plan.resident == n_sm


# ---------------------------------------------------------------------------
# ring attention's block backward
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, KV, hd, causal, window, q_offset, k_offset): the block
#: before the q rows, on the diagonal, a window, a negative offset
#: difference (not causal, and causal with part visible), G = 1, 4, 48,
#: ragged Sq and Skv, and a block that nothing sees; then hd 192 (the
#: bf16 kernel of 64 kv rows a CTA) at G = 12, 1 and 4, and its clusters'
#: edges: odd kv tiles, Skv = 64 k + 1, an upper CTA with no rows, a
#: window under a tile with q_offset > 0 and Sq < Skv, B = 2
BLOCK_CASES = [
    (1, 256, 256, 32, 8, 128, True, 0, 256, 0),
    (1, 256, 256, 32, 8, 128, True, 0, 256, 256),
    (1, 200, 300, 8, 2, 64, True, 100, 300, 150),
    (2, 130, 129, 48, 1, 128, False, 0, 0, 500),
    (1, 127, 257, 8, 8, 128, True, 0, 100, 0),
    (1, 96, 160, 16, 4, 64, True, 0, 0, 64),
    (1, 64, 64, 8, 2, 128, True, 0, 0, 128),
    (1, 96, 160, 4, 1, 16, True, 0, 0, 64),
    (1, 256, 256, 24, 2, 192, True, 0, 256, 0),
    (1, 127, 257, 8, 8, 192, True, 0, 100, 0),
    (2, 130, 129, 12, 1, 192, False, 0, 0, 500),
    (1, 200, 300, 8, 2, 192, True, 100, 300, 150),
    (1, 64, 64, 8, 2, 192, True, 0, 0, 128),
    (1, 192, 192, 12, 1, 192, True, 0, 0, 0),
    (2, 320, 320, 8, 8, 192, True, 0, 0, 0),
    (1, 100, 65, 4, 4, 192, True, 0, 64, 0),
    (1, 129, 320, 12, 1, 192, True, 30, 191, 0),
    (2, 64, 64, 4, 1, 192, False, 0, 0, 0),
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


#: the main path's width, an odd width over three bands, rows over several
#: strips with a ragged last one, and m < k
KSWEEP_SHAPES = [(40, 16386), (700, 2101), (3001, 130), (5, 130)]


def _ksweep_parts(cuda, dtype, m, n, k, seed, offset=0):
    """The slab's six parts, each a view ``offset`` elements into a buffer
    of its own (offset 1: bases that are only element-aligned)."""
    rng = np.random.default_rng(seed)
    parts = []
    for rows in (k, m, k) * 2:
        a = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
        buf = torch.zeros(rows * n + offset, device=cuda, dtype=dtype)
        buf[offset:] = a.to(cuda).to(dtype).flatten()
        parts.append(buf[offset:].view(rows, n))
    return parts


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype,tol", STENCIL_TOL)
@pytest.mark.parametrize("k", range(1, stencil.KSWEEP_MAX_K + 1))
@pytest.mark.parametrize("shape", KSWEEP_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_ksweep_kernel_equals_plain_across_bands_and_strips(
        cuda, shape, k, dtype, tol, offset):
    """The streamed kernel on the plan's bands and strips, frozen depths
    (0, 0), (k, k), (k+1, k+1), parts at aligned and one-element-offset
    bases: f32 equal to the plain version bit for bit, bf16 within 2e-2 of
    the largest magnitude."""
    m, n = shape
    parts = _ksweep_parts(cuda, dtype, m, n, k, 17, offset)
    for ft, fb in ((0, 0), (k, k), (k + 1, k + 1)):
        got = stencil.jacobi_ksweep_parts(*parts, k, ft, fb)
        torch.cuda.synchronize()
        want = stencil.jacobi_ksweep_parts(*parts, k, ft, fb,
                                           engine="torch")
        if dtype == torch.float32:
            assert torch.equal(got, want), (ft, fb)
        else:
            _close(got, want, tol, f"frozen ({ft}, {fb})")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_jacobi_ksweep_frozen_rows_across_strip_boundaries(cuda, k, dtype):
    """Strips of 1, 3 and k rows launched through the C entry (the plan
    never cuts so short), so that strip boundaries fall inside the frozen
    rows at both ends: equal to the plain version (f32 bit for bit)."""
    m, n = 23, 777
    parts = _ksweep_parts(cuda, dtype, m, n, k, 19)
    lib = stencil._lib()
    for strip in (1, 3, k):
        for ft, fb in ((k + 1, k + 1), (k, 0), (0, k + 1)):
            out = torch.full((m, n), 7.0, device=cuda, dtype=dtype)
            err = lib.jacobi_ksweep_launch(
                stencil._DTYPE_CODE[dtype], *(t.data_ptr() for t in parts),
                out.data_ptr(), m, n, k, ft, fb, strip,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0
            torch.cuda.synchronize()
            want = stencil.jacobi_ksweep_parts(*parts, k, ft, fb,
                                               engine="torch")
            if dtype == torch.float32:
                assert torch.equal(out, want), (strip, ft, fb)
            else:
                _close(out, want, 2e-2, f"strip {strip} ({ft}, {fb})")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 8])
def test_jacobi_ksweep_twice_and_graph_replayed_give_equal_bits(cuda, k):
    """Two calls, and a CUDA-graph capture replayed, equal bit for bit at
    the main path's width."""
    parts = _ksweep_parts(cuda, torch.float32, 700, 16386, k, 23)
    first = stencil.jacobi_ksweep_parts(*parts, k, k, k)
    second = stencil.jacobi_ksweep_parts(*parts, k, k, k)
    out = torch.empty_like(first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        stencil.jacobi_ksweep_parts(*parts, k, k, k, out=out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stencil.jacobi_ksweep_parts(*parts, k, k, k, out=out)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, out)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [9, 16, 23])
@pytest.mark.parametrize("shape", [(700, 2101), (5, 130)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jacobi_ksweep_chained_launches_equal_plain(cuda, shape, k):
    """k > 8 as chained launches of depth <= 8 over the one k-deep slab
    (``ksweep_chain``), frozen depths (0, 0), (k, k), (k+1, k+1): f32
    equal to the plain version bit for bit, one launch per link."""
    m, n = shape
    parts = _ksweep_parts(cuda, torch.float32, m, n, k, 29)
    for ft, fb in ((0, 0), (k, k), (k + 1, k + 1)):
        before = stencil.KSWEEP_LAUNCHES
        got = stencil.jacobi_ksweep_parts(*parts, k, ft, fb)
        torch.cuda.synchronize()
        assert stencil.KSWEEP_LAUNCHES - before == \
            len(stencil.ksweep_chain(k))
        want = stencil.jacobi_ksweep_parts(*parts, k, ft, fb,
                                           engine="torch")
        assert torch.equal(got, want), (ft, fb)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jacobi_ksweep_built_kernel_matches_its_plan(cuda, dtype):
    """The built kernel's band and shared memory are the plan's and the
    cost model's (``ksweep_smem_bytes``), and the card keeps at least the
    CTAs the plan counts on (``KSWEEP_CTAS``) resident on an SM."""
    for k in range(1, stencil.KSWEEP_MAX_K + 1):
        band, smem, resident = stencil.ksweep_built(k, dtype)
        plan = stencil.ksweep_plan(16386, 16386, k, dtype)
        assert band == plan.band == stencil.ksweep_band(k)
        assert smem == stencil.ksweep_smem_bytes(k, dtype.itemsize)
        assert resident >= stencil.KSWEEP_CTAS, (k, resident)


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
    with pytest.raises(ValueError, match="k <= 8"):
        stencil.ksweep_built(stencil.KSWEEP_MAX_K + 1)


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
    # the entry makes a strided operand contiguous (an FSDP-gathered
    # expert weight is a moved view): its result is the contiguous one's;
    # the raw launch still refuses a strided operand
    view = h.transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    got = gm.grouped_expert_ffn(view, w1, w1g, w2, valid, mlp="swiglu")
    want = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp="swiglu")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_expert_ffn_cuda(view, w1, w1g, w2, valid, "swiglu")
    with pytest.raises(ValueError, match="devices"):
        gm.grouped_expert_ffn(h, w1, w1g, w2, valid.cpu(), mlp="swiglu")
    with pytest.raises(RuntimeError, match="launch failed"):
        # more groups than a grid's z dimension takes: the launch refuses
        big = torch.zeros((65536, 1, 8), device=cuda)
        gm.grouped_expert_ffn_cuda(
            big, w1[:1].contiguous(), w1g[:1].contiguous(),
            w2[:1].contiguous(),
            torch.zeros(65536, dtype=torch.int32, device=cuda), "swiglu")


# The tensor-core engine (bf16, D and F multiples of 64)

#: (G, C, D, F, E): C = 480, 129 and 1; gpe 1, 2 and 4; an F and a D that
#: end on a half tile of 128
GROUPED_TC_SHAPES = [(6, 480, 128, 192, 6), (8, 129, 192, 128, 4),
                     (8, 1, 128, 64, 2)]
#: valid counts, clamped to C: the edges of a 128-row tile
GROUPED_TC_VALID = (0, 1, 127, 128, 129, 10**9)
ACTIVATIONS = ["swiglu", "geglu", "relu2", "gelu"]


def _tc_inputs(cuda, shape, seed, junk="big"):
    """bf16 operands; past each group's valid count h holds 1e3-scale
    garbage (``junk="big"``) or NaN, +Inf and -Inf (``junk="nonfinite"``)."""
    g, c, d, f, e = shape
    rng = np.random.default_rng(seed)
    valid = np.array([min(GROUPED_TC_VALID[i % 6], c) for i in range(g)],
                     np.int32)
    h = rng.normal(size=(g, c, d)).astype(np.float32)
    rows = np.arange(c)[None, :, None]
    bad = (1e3 * rng.normal(size=h.shape) if junk == "big" else
           np.array([np.nan, np.inf, -np.inf])[rng.integers(0, 3, h.shape)])
    h = np.where(rows < valid[:, None, None], h, bad).astype(np.float32)
    ws = [(rng.normal(size=s) * 0.1).astype(np.float32)
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    return ([torch.from_numpy(a).to(cuda).bfloat16() for a in (h, *ws)],
            torch.from_numpy(valid).to(cuda))


def _plain_f32(h, w1, w1g, w2, valid, mlp):
    return gm.grouped_expert_ffn_torch(
        h.float(), w1.float(), None if w1g is None else w1g.float(),
        w2.float(), valid, mlp)


def _padded(got, valid):
    return (torch.arange(got.shape[1], device=got.device)[None, :, None]
            >= valid[:, None, None]).expand_as(got)


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ACTIVATIONS)
@pytest.mark.parametrize("shape", GROUPED_TC_SHAPES, ids=str)
def test_grouped_ffn_tensor_cores_match_plain(cuda, mlp, shape):
    """The tensor-core engine against the plain version in f32 on the same
    bf16 inputs: within 2e-2 x max(1, max|want|), padded rows exactly
    zero, one launch counted on the wgmma engine."""
    (h, w1, w1g, w2), valid = _tc_inputs(cuda, shape, sum(shape))
    w1g = w1g if gm.gated(mlp) else None
    assert gm.grouped_plan(h, w1, w2, mlp).engine == "wgmma"
    before, tc = gm.GROUPED_LAUNCHES, gm.ENGINE_LAUNCHES["wgmma"]
    got = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp=mlp)
    torch.cuda.synchronize()
    assert gm.GROUPED_LAUNCHES == before + 1
    assert gm.ENGINE_LAUNCHES["wgmma"] == tc + 1
    _close(got, _plain_f32(h, w1, w1g, w2, valid, mlp), 2e-2,
           f"{mlp} {shape}")
    pad = _padded(got, valid)
    assert torch.equal(got[pad].float(), torch.zeros_like(got[pad].float()))


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ACTIVATIONS)
def test_grouped_ffn_tensor_cores_keep_nonfinite_garbage_out(cuda, mlp):
    """NaN and Inf in h past valid reach only their own rows, which come
    out exactly zero; the live rows are finite and match the plain
    version (which selects the padded rows away) at 2e-2."""
    shape = GROUPED_TC_SHAPES[0]
    (h, w1, w1g, w2), valid = _tc_inputs(cuda, shape, 5, junk="nonfinite")
    w1g = w1g if gm.gated(mlp) else None
    assert not torch.isfinite(h.float()).all()
    got = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp=mlp)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    pad = _padded(got, valid)
    assert torch.equal(got[pad].float(), torch.zeros_like(got[pad].float()))
    _close(got, _plain_f32(h, w1, w1g, w2, valid, mlp), 2e-2, mlp)


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ACTIVATIONS)
@pytest.mark.parametrize("shape", GROUPED_TC_SHAPES
                         + [(8, 480, 256, 1408, 8)], ids=str)
def test_grouped_ffn_f32_down_product_keeps_f32(cuda, mlp, shape):
    """The down launch's f32 result before rounding is within 1e-4 of its
    largest magnitude of the plain f32 product: act runs as act_hi w2 +
    act_lo w2; act_hi w2 alone is off by about 1e-3, which the bf16
    output at 2e-2 cannot show."""
    (h, w1, w1g, w2), valid = _tc_inputs(cuda, shape, 7 + sum(shape))
    w1g = w1g if gm.gated(mlp) else None
    got = gm.down_product_f32(h, w1, w1g, w2, valid, mlp)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    want = _plain_f32(h, w1, w1g, w2, valid, mlp)
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), \
        f"{mlp} {shape}: {err:.3e} of {want.abs().max().item():.3g}"
    pad = _padded(got, valid)
    assert torch.equal(got[pad], torch.zeros_like(got[pad]))


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ACTIVATIONS)
@pytest.mark.parametrize("shape", GROUPED_TC_SHAPES[:2]
                         + [(8, 480, 256, 1408, 8)], ids=str)
def test_grouped_ffn_bf16_output_rounds_the_f32_product(cuda, mlp, shape):
    """The bf16 binary the models run (the f32 readout is another
    instantiation of its template): its output equals the plain f32
    product rounded to bf16 on at least 99% of the live elements, which
    act_hi w2 alone meets on about 58% only."""
    (h, w1, w1g, w2), valid = _tc_inputs(cuda, shape, 11 + sum(shape))
    w1g = w1g if gm.gated(mlp) else None
    got = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp=mlp)
    torch.cuda.synchronize()
    want = _plain_f32(h, w1, w1g, w2, valid, mlp).bfloat16()
    live = ~_padded(got, valid)
    share = (got[live] == want[live]).float().mean().item()
    assert share >= 0.99, f"{mlp} {shape}: {share:.4f} equal"


@pytest.mark.gpu
def test_grouped_ffn_tensor_cores_twice_give_equal_bits(cuda):
    """No split-K and no atomics: two calls write the same bits."""
    (h, w1, w1g, w2), valid = _tc_inputs(cuda, (8, 480, 256, 1408, 8), 3)
    a = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp="swiglu")
    b = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp="swiglu")
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_grouped_ffn_counts_each_engine(cuda):
    """The plan's engine is the one that launches and counts: f32 and bf16
    with D or F no multiple of 64 on SIMT, bf16 at 64-multiples on the
    tensor cores."""
    cases = [(torch.float32, (4, 16, 128, 64, 2), "simt"),
             (torch.bfloat16, (3, 257, 130, 70, 3), "simt"),
             (torch.bfloat16, (4, 16, 128, 64, 2), "wgmma")]
    for dtype, shape, engine in cases:
        (h, w1, w1g, w2), valid = _grouped_inputs(cuda, dtype, shape, 0)
        assert gm.grouped_plan(h, w1, w2, "swiglu").engine == engine
        before = dict(gm.ENGINE_LAUNCHES)
        gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp="swiglu")
        torch.cuda.synchronize()
        want = dict(before)
        want[engine] += 1
        assert gm.ENGINE_LAUNCHES == want, (dtype, shape)


@pytest.mark.gpu
def test_grouped_ffn_tensor_cores_reject_misaligned_bases(cuda):
    """TMA needs 16-byte bases: an aligned shape on a misaligned base
    raises before any launch, for each operand."""
    (h, w1, w1g, w2), valid = _tc_inputs(cuda, (4, 16, 128, 64, 2), 0)
    before = gm.GROUPED_LAUNCHES
    for i in range(4):
        args = [h, w1, w1g, w2]
        args[i] = _misaligned(args[i])
        with pytest.raises(ValueError, match="16-byte"):
            gm.grouped_expert_ffn(*args, valid, mlp="swiglu")
    assert gm.GROUPED_LAUNCHES == before


# ---------------------------------------------------------------------------
# The grouped-expert FFN's backward kernels against the plain backward
# ---------------------------------------------------------------------------

#: (G, C, D, F, E) of the SIMT backward (f32, and bf16 where D or F is no
#: multiple of 64) and of the tensor cores' (bf16): one and two groups an
#: expert, sizes that end on part of a tile, one capacity row
GROUPED_BWD_SHAPES = [(4, 16, 8, 12, 4), (8, 32, 8, 16, 2),
                      (3, 257, 130, 70, 3)]
GROUPED_BWD_TC_SHAPES = [(4, 200, 128, 192, 4), (4, 129, 192, 128, 2),
                         (4, 1, 64, 64, 2)]
#: the tensor cores' bf16 gradients equal the plain f32 ones rounded to
#: bf16 on at least this share of their elements (dU, dG and act in bf16
#: alone, without their lo halves, move them by about 4e-3)
GROUPED_BWD_BF16_SHARE = 0.99


def _grouped_bwd_inputs(cuda, dtype, shape, seed):
    """h and dy with 1e3-scale garbage past each group's valid count, the
    weights ~0.1 N(0, 1), and valid counts of 0 (every group of expert 0),
    C and between."""
    g, c, d, f, e = shape
    (h, w1, w1g, w2), valid = _grouped_inputs(cuda, dtype, shape, seed)
    valid[: g // e] = 0
    valid[-1] = c
    rng = np.random.default_rng(seed + 1)
    dy = rng.normal(size=(g, c, d)).astype(np.float32)
    rows = np.arange(c)[None, :, None]
    dy = np.where(rows < valid.cpu().numpy()[:, None, None], dy,
                  1e3 * rng.normal(size=dy.shape).astype(np.float32))
    return h, w1, w1g, w2, valid, torch.from_numpy(dy).to(cuda).to(dtype)


def _grouped_bwd_call(cuda, dtype, tol, mlp, shape, engine):
    h, w1, w1g, w2, valid, dy = _grouped_bwd_inputs(cuda, dtype, shape,
                                                    sum(shape) + len(mlp))
    w1g = w1g if gm.gated(mlp) else None
    assert gm.bwd_engine(h, w1, w2) == engine
    before = (gm.GROUPED_BWD_LAUNCHES, gm.BWD_ENGINE_LAUNCHES[engine])
    got = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, mlp)
    torch.cuda.synchronize()
    assert (gm.GROUPED_BWD_LAUNCHES, gm.BWD_ENGINE_LAUNCHES[engine]) == (
        before[0] + 1, before[1] + 1)
    want = gm.grouped_expert_ffn_bwd_torch(
        *[None if t is None else t.float() for t in (h, w1, w1g, w2)], valid,
        dy.float(), mlp)
    live = (torch.arange(shape[1], device=cuda)[None, :, None]
            < valid[:, None, None]).expand_as(h)
    for name, g_, w_, like in zip(("dh", "dw1", "dw1g", "dw2"), got, want,
                                  (h, w1, w1g, w2)):
        if like is None:
            assert g_ is None and w_ is None
            continue
        assert g_.dtype == like.dtype and g_.shape == like.shape
        _close(g_, w_, tol, f"{name} {mlp} {shape}")
        if name == "dh":
            assert torch.equal(g_[~live].float(),
                               torch.zeros_like(g_[~live].float()))
        else:                               # expert 0 keeps no row
            assert torch.equal(g_[0].float(), torch.zeros_like(g_[0].float()))
        if engine == "mma":
            sel = live if name == "dh" else torch.ones_like(g_, dtype=bool)
            share = (g_[sel] == w_[sel].to(g_.dtype)).float().mean().item()
            assert share >= GROUPED_BWD_BF16_SHARE, (name, share)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", GROUPED_TOL)
@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("shape", GROUPED_BWD_SHAPES, ids=str)
def test_grouped_ffn_bwd_simt_matches_plain(cuda, dtype, tol, mlp, shape):
    """The SIMT backward against the plain backward in f32 on the same
    inputs: every gradient within tol x max(1, max|want|) (f32 1e-5, bf16
    2e-2), dh exactly 0 past valid, an empty expert's weight gradients
    exactly 0, one launch counted."""
    _grouped_bwd_call(cuda, dtype, tol, mlp, shape, "simt")


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("shape", GROUPED_BWD_TC_SHAPES, ids=str)
def test_grouped_ffn_bwd_tensor_cores_match_plain(cuda, mlp, shape):
    """The tensor-core backward (bf16) as the SIMT test holds it, and each
    gradient equal to the plain f32 one rounded to bf16 on at least
    GROUPED_BWD_BF16_SHARE of its elements: dU, dG and act keep f32 through
    their hi/lo planes."""
    _grouped_bwd_call(cuda, torch.bfloat16, 2e-2, mlp, shape, "mma")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_bwd_is_the_functions_backward(cuda, dtype):
    """Autograd through grouped_expert_ffn on the card launches the
    backward kernels once and gives the entry's bits (no atomics: two
    calls agree), and the call replayed from a CUDA graph gives them too."""
    shape = (4, 129, 192, 128, 2)
    h, w1, w1g, w2, valid, dy = _grouped_bwd_inputs(cuda, dtype, shape, 3)
    leaves = [t.clone().requires_grad_() for t in (h, w1, w1g, w2)]
    out = gm.grouped_expert_ffn(*leaves[:3], leaves[3], valid, mlp="swiglu")
    before = gm.GROUPED_BWD_LAUNCHES
    grads = torch.autograd.grad(out, leaves, dy)
    assert gm.GROUPED_BWD_LAUNCHES == before + 1
    want = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, "swiglu")
    for g_, w_ in zip(grads, want):
        assert torch.equal(g_, w_)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, "swiglu")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy,
                                             "swiglu")
    graph.replay()
    torch.cuda.synchronize()
    for g_, w_ in zip(captured, want):
        assert torch.equal(g_, w_)


def _poison_bwd_workspace(cuda, shape, mlp):
    """Free a block of the tensor-core backward's workspace size filled
    with NaN, so the call's torch.empty takes it back: the planes past
    valid then hold NaN, as they may in any call."""
    g, c, _, f, _ = shape
    junk = torch.full((8 if gm.gated(mlp) else 6, g, c, f), float("nan"),
                      dtype=torch.bfloat16, device=cuda)
    del junk


def _nonfinite_past_valid(t, valid):
    """t with NaN and Inf (alternate rows) past each group's valid."""
    rows = torch.arange(t.shape[1], device=t.device)[None, :, None]
    junk = torch.where(rows % 2 == 0, float("nan"), float("inf"))
    return torch.where(rows < valid[:, None, None], t, junk.to(t.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "relu2", "gelu"])
def test_grouped_ffn_bwd_tensor_cores_keep_nonfinite_garbage_out(cuda, mlp):
    """NaN and Inf in h and dy past valid, and NaN in the workspace's
    planes past valid, reach no gradient: dh is exactly 0 past valid and
    finite, every weight gradient finite (the rows past valid are step 3's
    contraction: the kernel zeroes them in shared memory), expert 0 (no
    kept row) exactly 0, and the rest within 2e-2 of the plain backward,
    which selects the padded rows away.  The backward's twin of
    test_grouped_ffn_tensor_cores_keep_nonfinite_garbage_out."""
    shape = GROUPED_BWD_TC_SHAPES[0]
    h, w1, w1g, w2, valid, dy = _grouped_bwd_inputs(cuda, torch.bfloat16,
                                                    shape, 11)
    h, dy = _nonfinite_past_valid(h, valid), _nonfinite_past_valid(dy, valid)
    w1g = w1g if gm.gated(mlp) else None
    _poison_bwd_workspace(cuda, shape, mlp)
    got = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, mlp)
    torch.cuda.synchronize()
    want = gm.grouped_expert_ffn_bwd_torch(
        *[None if t is None else t.float() for t in (h, w1, w1g, w2)], valid,
        dy.float(), mlp)
    live = (torch.arange(shape[1], device=cuda)[None, :, None]
            < valid[:, None, None]).expand_as(h)
    for name, g_, w_ in zip(("dh", "dw1", "dw1g", "dw2"), got, want):
        if g_ is None:
            continue
        assert torch.isfinite(g_.float()).all(), name
        _close(g_, w_, 2e-2, f"{name} {mlp}")
        zero = g_[~live] if name == "dh" else g_[0]
        assert torch.equal(zero.float(), torch.zeros_like(zero.float()))


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ["swiglu", "relu2"])
def test_grouped_ffn_bwd_tensor_cores_repeat_their_bits(cuda, mlp):
    """Two calls of the tensor-core backward give equal bits in every
    gradient: each output tile is summed by one CTA in a fixed order, with
    no split of the contraction and no atomics."""
    shape = GROUPED_BWD_TC_SHAPES[1]
    h, w1, w1g, w2, valid, dy = _grouped_bwd_inputs(cuda, torch.bfloat16,
                                                    shape, 12)
    w1g = w1g if gm.gated(mlp) else None
    first = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, mlp)
    second = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, mlp)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_grouped_ffn_bwd_tensor_cores_all_empty_give_zeros(cuda, mlp):
    """A call that keeps no row (every valid 0), with NaN in h, dy and the
    workspace, gives exact zeros in dh and every weight gradient."""
    shape = GROUPED_BWD_TC_SHAPES[1]
    h, w1, w1g, w2, valid, dy = _grouped_bwd_inputs(cuda, torch.bfloat16,
                                                    shape, 13)
    valid = torch.zeros_like(valid)
    h, dy = _nonfinite_past_valid(h, valid), _nonfinite_past_valid(dy, valid)
    w1g = w1g if gm.gated(mlp) else None
    _poison_bwd_workspace(cuda, shape, mlp)
    got = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, mlp)
    torch.cuda.synchronize()
    for g_ in got:
        if g_ is not None:
            assert torch.equal(g_.float(), torch.zeros_like(g_.float()))


@pytest.mark.gpu
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
def test_grouped_bwd_built_kernels_match_their_plan(cuda, gated):
    """The built tensor-core backward's geometry (threads, output tile,
    contraction a stage, stages, shared memory) is
    ``grouped_matmul.grouped_bwd_plan``'s for each of its four launches,
    and the card keeps one CTA of each resident on an SM (the launches
    are persistent, one CTA an SM)."""
    built = gm.grouped_bwd_built(gated)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    g, c, d, f, e = 64, 240, 2048, 1408, 64
    plan = gm.grouped_bwd_plan(g, c, d, f, e, gated, n_sm=n_sm)
    for ln in plan.launches:
        got = built[ln.step]
        assert got[:6] == (ln.threads, ln.rows, ln.cols, ln.depth,
                           ln.stages, ln.smem), ln.step
        assert got[6] == 1, ln.step
        assert ln.grid == n_sm


@pytest.mark.gpu
def test_grouped_ffn_bwd_rejects_what_it_does_not_take(cuda):
    h, w1, w1g, w2, valid, dy = _grouped_bwd_inputs(
        cuda, torch.bfloat16, (4, 129, 192, 128, 2), 5)
    with pytest.raises(ValueError, match="dy"):
        gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy.float(),
                                  "swiglu")
    with pytest.raises(ValueError, match="contiguous"):
        gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid,
                                  dy.transpose(1, 2).contiguous()
                                  .transpose(1, 2), "swiglu")
    odd = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=cuda)[1:]
    odd = odd.view(dy.shape).copy_(dy)
    with pytest.raises(ValueError, match="16-byte"):
        gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, odd, "swiglu")


# ---------------------------------------------------------------------------
# The paged kernel's partials over a sharded pool against the plain ones
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,hd,kvh,groups", [
    (torch.float32, 128, 8, 4), (torch.float32, 192, 2, 6),
    (torch.bfloat16, 128, 8, 4), (torch.bfloat16, 64, 1, 12),
    (torch.bfloat16, 192, 2, 6)], ids=str)
@pytest.mark.parametrize("window", ["none", "mid"])
def test_paged_partials_over_two_pool_halves_match_plain(cuda, dtype, hd,
                                                         kvh, groups, window):
    """The pool cut in two at a page that splits chains between the halves,
    each half a rank's pool with its offset: the kernel's f32 partials of
    each half (the f32 path's kernel, or the bf16 fast path through its
    merge) equal the plain partials in f32 on the same inputs within 1e-4
    of their size, and the two LSE-merge to the plain unsharded output
    within 1e-4 (f32) or 2e-2 (bf16, against the bf16 output's plain
    version)."""
    args, bnd = _split_inputs(cuda, dtype, kvh, groups, hd, 16,
                              seed=groups + hd)
    q, kp, vp, table, lens = args
    win = {"none": 0, "mid": bnd // 2 + 3}[window]
    half = kp.shape[0] // 2
    parts = []
    for off, end in ((0, half), (half, kp.shape[0])):
        local = (q, kp[off:end], vp[off:end], table, lens)
        before = paged.LAUNCHES
        got = paged.paged_attention_partials(*local, window=win,
                                             pool_offset=off)
        torch.cuda.synchronize()
        assert paged.LAUNCHES == before + 1
        want = paged.paged_attention_partials_torch(
            *[a.float() if i < 3 else a for i, a in enumerate(local)],
            window=win, pool_offset=off)
        assert all(g_.dtype == torch.float32 for g_ in got)
        assert_split_partials_close(got, want)
        parts.append(got)
    out, _ = fa.finalize_partials(*fa.merge_partials(*parts))
    full = paged.paged_attention_torch(q.float(), kp.float(), vp.float(),
                                       table, lens, window=win)
    torch.testing.assert_close(out[:, 0], full, rtol=0.0, atol=1e-4)


@pytest.mark.gpu
def test_paged_partials_with_one_split(cuda):
    """A table of one column: the bf16 fast path plans one split, and the
    partials still come through the merge, unnormalised."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(8, 32, 128))
    kp, vp = (rng.normal(size=(40, 16, 8, 128)) for _ in range(2))
    table = rng.permutation(40)[:8].reshape(8, 1).astype(np.int32)
    lens = np.array([0, 1, 5, 16, 16, 9, 3, 12], np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, table, lens)]
    for i in range(3):
        args[i] = args[i].to(torch.bfloat16)
    plan = paged.launch_plan(args[0], args[1], args[3])
    assert (plan.engine, plan.n_splits) == ("mma", 1)
    got = paged.paged_attention_partials(*args, pool_offset=3)
    want = paged.paged_attention_partials_torch(
        *[a.float() if i < 3 else a for i, a in enumerate(args)],
        pool_offset=3)
    assert_split_partials_close(got, want)
