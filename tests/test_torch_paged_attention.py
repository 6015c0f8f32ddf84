"""The port's paged decode attention held against the reference's.

On the CPU the wrapper takes the plain PyTorch version; it must equal the
reference's jnp engine and its Pallas kernel (in interpret mode) on
randomized page tables, including lens == 0 slots and garbage table
entries past lens.  The CUDA kernel itself is held against the plain
version on the card in tests/test_torch_kernels_card.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_paged
from repro.kernels.flash_attention import (finalize_partials as
                                           ref_finalize,
                                           merge_partials as ref_merge)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as paged

TOL = 1e-5   # f32 on both sides; sums differ only in order


def _inputs(rng, b, h, kvh, hd, page, pmax, npool):
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    table = rng.permutation(npool)[:b * pmax].reshape(b, pmax) \
        .astype(np.int32)
    lens = rng.integers(0, page * pmax + 1, size=b).astype(np.int32)
    lens[0] = 0                                   # an empty slot
    lens[-1] = max(1, lens[-1] // 2)              # leaves unused columns
    # entries past ceil(lens/page) may hold any in-range id
    for i in range(b):
        used = -(-int(lens[i]) // page)
        table[i, used:] = rng.integers(0, npool, size=pmax - used)
    return q, kp, vp, table, lens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,kvh,hd,page,pmax", [
    (8, 2, 32, 8, 5),     # GQA 4:1
    (4, 4, 16, 4, 7),     # MHA, small pages
    (8, 1, 64, 16, 3),    # MQA
    (32, 8, 128, 16, 4),  # phi4-mini's head geometry
])
@pytest.mark.parametrize("window", [0, 9])
def test_plain_matches_reference_engines(h, kvh, hd, page, pmax, window):
    rng = np.random.default_rng(h * 100 + page + window)
    q, kp, vp, table, lens = _inputs(rng, 4, h, kvh, hd, page, pmax, 32)
    before = paged.LAUNCHES
    got = paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                                window=window)
    assert paged.LAUNCHES == before     # a CPU tensor never launches
    want_jnp = ref_paged.paged_attention_jnp(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), window=window)
    want_pal = ref_paged.paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), window=window,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pal),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[0].numpy(), 0.0)   # lens == 0


def edge_inputs(rng, window):
    """lens past the table's reach (pmax * page) and page ids outside the
    pool inside a chain: only the positions the table names are attended,
    and an out-of-pool page contributes nothing."""
    b, h, kvh, hd, page, pmax, npool = 4, 8, 2, 32, 8, 3, 16
    q, kp, vp, table, _ = _inputs(rng, b, h, kvh, hd, page, pmax, npool)
    lens = np.array([page * pmax + 5, page * pmax + 40, 20, 17], np.int32)
    table[1, 1] = npool + 3
    table[2, 0] = -1
    table[3, :] = npool                    # every page outside the pool
    return q, kp, vp, table, lens, window


@pytest.mark.parametrize("window", [0, 12])
def test_plain_matches_reference_on_edge_inputs(window):
    q, kp, vp, table, lens, window = edge_inputs(
        np.random.default_rng(11), window)
    got = paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                                window=window)
    want = ref_paged.paged_attention_jnp(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(got[3].numpy(), 0.0)


def test_partials_shard_merge():
    """Partials over disjoint pool shards LSE-merge to the full result —
    the distributed flash-decoding contract — and equal the reference's
    partials shard by shard."""
    rng = np.random.default_rng(3)
    b, h, kvh, hd, page, pmax, npool = 2, 4, 2, 16, 4, 6, 16
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(npool, page, kvh, hd)).astype(np.float32)
    table = rng.permutation(npool)[:b * pmax].reshape(b, pmax) \
        .astype(np.int32)
    lens = np.array([17, 23], np.int32)
    full = paged.paged_attention_torch(_t(q), _t(kp), _t(vp), _t(table),
                                       _t(lens))
    parts, ref_parts = [], []
    for o in (0, 4, 8, 12):
        parts.append(paged.paged_attention_partials_torch(
            _t(q), _t(kp[o:o + 4]), _t(vp[o:o + 4]), _t(table), _t(lens),
            pool_offset=o))
        ref_parts.append(ref_paged.paged_attention_partials_jnp(
            jnp.asarray(q), jnp.asarray(kp[o:o + 4]),
            jnp.asarray(vp[o:o + 4]), jnp.asarray(table),
            jnp.asarray(lens), pool_offset=o))
    acc, ref_acc = parts[0], ref_parts[0]
    for p, rp in zip(parts[1:], ref_parts[1:]):
        acc = fa.merge_partials(acc, p)
        ref_acc = ref_merge(ref_acc, rp)
    out, lse = fa.finalize_partials(*acc, out_dtype=torch.float32)
    ref_out, ref_lse = ref_finalize(*ref_acc, out_dtype=jnp.float32)
    np.testing.assert_allclose(out[:, 0].numpy(), full.numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               rtol=TOL, atol=TOL)


def test_empty_partials_are_the_merge_identity():
    rng = np.random.default_rng(5)
    part = (torch.from_numpy(rng.normal(size=(2, 1, 4)).astype(np.float32)),
            torch.from_numpy(rng.random(size=(2, 1, 4)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(2, 1, 4, 8))
                             .astype(np.float32)))
    merged = fa.merge_partials(
        fa.init_partials(2, 1, 4, 8, device="cpu"), part)
    for got, want in zip(merged, part):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_malformed_inputs():
    rng = np.random.default_rng(6)
    q, kp, vp, table, lens = _inputs(rng, 2, 4, 2, 8, 4, 3, 8)
    with pytest.raises(ValueError):
        paged.paged_attention(_t(q[:, :3]), _t(kp), _t(vp), _t(table),
                              _t(lens))                 # 3 heads over 2 kv
    with pytest.raises(TypeError):
        paged.paged_attention(_t(q), _t(kp), _t(vp),
                              _t(table.astype(np.int64)), _t(lens))
    with pytest.raises(ValueError):
        paged.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                              engine="pallas")


# ---------------------------------------------------------------------------
# The card's split-KV plan: a pure function of the shapes, and the merge of
# its splits' partials in split order
# ---------------------------------------------------------------------------

#: (pmax, page, B, KV, row tiles): the serve shape (phi4-mini, B=8,
#: chains to 288), granite's MQA (48 heads over 1: 3 row tiles), moonshot
#: (G=1), the long-context shape, the decode step's 512-position table,
#: a one-slot 128K chain, a huge batch and a tiny table
PLAN_SHAPES = [(18, 16, 8, 8, 1), (18, 16, 8, 1, 3), (18, 16, 8, 16, 1),
               (512, 16, 32, 8, 1), (32, 16, 8, 8, 1), (8192, 16, 1, 1, 1),
               (64, 8, 512, 8, 1), (3, 8, 1, 1, 1), (1, 16, 4, 2, 3)]
N_SM = 132      # an H100 SXM's SMs


def _splits(pmax, pps, n):
    return [(s * pps, min((s + 1) * pps, pmax)) for s in range(n)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_covers_every_column_once(shape):
    pmax, page, b, kvh, rt = shape
    pps, n = paged.split_plan(pmax, page, b, kvh, rt, N_SM)
    assert 1 <= pps <= paged.MAX_SPLIT_PAGES
    assert n == -(-pmax // pps)
    cols = [c for lo, hi in _splits(pmax, pps, n) for c in range(lo, hi)]
    assert cols == list(range(pmax))          # each column once, in order
    assert all(hi > lo for lo, hi in _splits(pmax, pps, n))
    assert paged.split_plan(pmax, page, b, kvh, rt, N_SM) == (pps, n)


@pytest.mark.parametrize("shape", [(18, 16, 8, 8, 1), (18, 16, 8, 1, 3),
                                   (18, 16, 8, 16, 1), (512, 16, 32, 8, 1)])
def test_split_plan_fills_the_card(shape):
    """The serve, MQA, G=1 and long-context shapes get at least the fill
    target of CTAs (FILL_CTAS_PER_SM per SM)."""
    pmax, page, b, kvh, rt = shape
    pps, n = paged.split_plan(pmax, page, b, kvh, rt, N_SM)
    assert n * b * kvh * rt >= paged.FILL_CTAS_PER_SM * N_SM


def test_split_plan_rejects_empty_sizes():
    with pytest.raises(ValueError):
        paged.split_plan(0, 16, 8, 8, 1, N_SM)


def split_cases():
    """Chains cut by the plan at a small SM count, so they have several
    splits: lens just below, at and above a split boundary, a window that
    starts mid-split and empties whole splits, an out-of-pool page in the
    middle of a chain, lens == 0, lens = pmax * page and lens past it, and
    garbage table entries past every chain."""
    b, h, kvh, hd, page, pmax, npool = 8, 8, 2, 16, 4, 12, 120
    pps, n = paged.split_plan(pmax, page, b, kvh, 1, 80)
    bnd = pps * page
    lens = np.array([bnd - 1, bnd, bnd + 1, 0, pmax * page,
                     pmax * page + 9, 2 * bnd + 3, 1], np.int32)
    rng = np.random.default_rng(21)
    q, kp, vp, table, _ = _inputs(rng, b, h, kvh, hd, page, pmax, npool)
    for i in range(b):
        used = min(pmax, -(-int(lens[i]) // page))
        table[i, used:] = rng.integers(-npool, 2 * npool, size=pmax - used)
    table[6, pps + 1] = npool + 7            # out of the pool, mid-chain
    return q, kp, vp, table, lens, pps, n, bnd


@pytest.mark.parametrize("window", ["none", "mid", "short"])
def test_split_partials_merge_to_reference(window):
    """Each split's partials (split_partials_torch: the table with the
    other columns set to -1, which is outside the pool and contributes
    nothing), merged in split order with merge_partials, equal the
    reference's paged attention."""
    q, kp, vp, table, lens, pps, n, bnd = split_cases()
    assert n > 3
    win = {"none": 0, "mid": bnd // 2 + 3, "short": 3}[window]
    m, l, acc = paged.split_partials_torch(_t(q), _t(kp), _t(vp), _t(table),
                                           _t(lens), pps, window=win)
    assert m.shape == l.shape == (n, 8, 8) and acc.shape == (n, 8, 8, 16)
    carry = (m[0][:, None], l[0][:, None], acc[0][:, None])
    for s in range(1, n):
        carry = fa.merge_partials(
            carry, (m[s][:, None], l[s][:, None], acc[s][:, None]))
    out, _ = fa.finalize_partials(*carry, out_dtype=torch.float32)
    want = ref_paged.paged_attention_jnp(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), window=win)
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out[3, 0].numpy(), 0.0)     # lens == 0


def test_split_partials_needs_the_card():
    """The kernel's split partials exist only in the card's workspace: a
    CPU tensor is refused, not served by the plain version."""
    q, kp, vp, table, lens, *_ = split_cases()
    with pytest.raises(RuntimeError, match="no paged-attention kernel"):
        paged.split_partials(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
