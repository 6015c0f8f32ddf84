"""The hd-192 flash backward's plan (``flash_attention.bwd192_plan``), on
the CPU: the launch order and each CTA's query tiles that the kernel
``flash_bwd_wgmma_pair_kernel`` (csrc/flash_attention.cu) computes in
place of its Python twin.  Held against the plain version's mask, tile by
tile: every (query tile, kv tile) with an unmasked pair is visited once,
none without one is, and the order takes chunks of heads one after
another.  The built kernel's geometry is held to the plan on the card
(tests/test_torch_kernels_card.py)."""

import os
import sys

import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import FLASH192_CASES  # noqa: E402

#: (B, Sq, Skv, H, KV, causal, window, q_offset), as FLASH192_CASES: an
#: odd number of kv tiles (Skv 192, 320), Skv = 64 k + 1, pairs whose
#: upper CTA has no rows (Skv 64 and 192), causal with q_offset > 0 and
#: Sq < Skv, a window smaller than a tile, G = 1 and 12, B = 2, a block
#: before the query rows (negative offset) and one nothing sees
RAGGED_CASES = [
    (1, 256, 192, 12, 1, True, 0, 0),
    (2, 300, 320, 24, 2, True, 0, 0),
    (1, 129, 129, 8, 8, False, 0, 0),
    (1, 257, 257, 12, 1, True, 0, 0),
    (1, 100, 64, 4, 4, True, 0, 0),
    (2, 64, 192, 24, 2, False, 0, 0),
    (1, 129, 320, 12, 1, True, 0, 191),
    (1, 200, 333, 24, 2, True, 30, 133),
    (1, 190, 257, 12, 12, True, 30, 67),
    (2, 130, 129, 12, 1, False, 0, -500),
    (1, 64, 64, 8, 2, True, 0, -128),
    (1, 127, 257, 8, 8, True, 0, 100),
]
CASES = [pytest.param(c, id="-".join(map(str, c)))
         for c in FLASH192_CASES + RAGGED_CASES]


def _seen_tiles(sq, skv, causal, window, q_offset):
    """{(query tile, kv tile)} holding at least one pair the plain
    version's mask leaves unmasked (``_step_mask``: key < Skv, key <=
    query when causal, query - key < window when windowed)."""
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= qpos - kpos < window
    rows, tile = -(-sq // 64), 64
    cols = -(-skv // tile)
    pad = np.zeros((rows * tile, cols * tile), bool)
    pad[:sq, :skv] = ok
    hit = pad.reshape(rows, tile, cols, tile).any(axis=(1, 3))
    return {(int(t), int(k)) for t, k in zip(*np.nonzero(hit))}


def _visits(plan):
    """[(b, h, query tile, kv tile)] of every CTA's own query tiles."""
    out = []
    for cl in plan.clusters:
        for r, (t0, t1) in enumerate(cl.tiles):
            kt = cl.k0 // plan.kv_rows + r
            out += [(cl.b, cl.h, t, kt) for t in range(t0, t1)]
    return out


@pytest.mark.parametrize("case", CASES)
def test_bwd192_plan_visits_every_unmasked_tile_once(case):
    """Every (query tile, kv tile) with an unmasked pair is computed by
    exactly one CTA, and no tile the plain version masks wholly is."""
    b, sq, skv, h, kvh, causal, window, q_offset = case
    plan = fa.bwd192_plan(b, sq, skv, h, kvh, causal, window, q_offset)
    visits = _visits(plan)
    assert len(visits) == len(set(visits)), "a tile is visited twice"
    seen = _seen_tiles(sq, skv, causal, window, q_offset)
    want = {(bb, hh, t, k) for bb in range(b) for hh in range(h)
            for t, k in seen}
    assert set(visits) == want


@pytest.mark.parametrize("case", CASES)
def test_bwd192_plan_order_takes_chunks_of_heads(case):
    """Every (b, h, kv pair) is one cluster; the (b, h) units come in
    chunks, h slowest, one chunk after another, each chunk's Q, dO and dQ
    within the L2 budget (or one unit), and within a chunk the kv pairs
    lowest first; a CTA's tiles lie within its cluster's union, which
    both CTAs' tiles span."""
    b, sq, skv, h, kvh, causal, window, q_offset = case
    plan = fa.bwd192_plan(b, sq, skv, h, kvh, causal, window, q_offset)
    pair_rows = plan.cluster * plan.kv_rows
    n_pt = -(-skv // pair_rows)
    assert len(plan.clusters) == b * h * n_pt
    assert len({(c.b, c.h, c.k0) for c in plan.clusters}) == len(
        plan.clusters)
    assert plan.chunk == 1 or plan.chunk * sq * 192 * 8 <= fa.BWD192_L2_CHUNK
    units = [c.h * b + c.b for c in plan.clusters]
    chunks = [u // plan.chunk for u in units]
    assert chunks == sorted(chunks), "a chunk of heads comes back"
    by_chunk = {}
    for c, ch in zip(plan.clusters, chunks):
        by_chunk.setdefault(ch, []).append(c)
    order = sorted(by_chunk)
    for ch, nxt in zip(order, order[1:]):
        assert max(c.h for c in by_chunk[ch]) <= min(
            c.h for c in by_chunk[nxt]), "heads do not come slowest"
    for members in by_chunk.values():
        k0s = [c.k0 for c in members]
        assert k0s == sorted(k0s), "a lighter kv pair before a heavier one"
    for c in plan.clusters:
        live = [t for t in c.tiles if t[1] > t[0]]
        if not live:
            assert c.union == (0, 0)
            continue
        assert c.union == (min(t[0] for t in live), max(t[1] for t in live))


def test_bwd192_plan_geometry_and_nemotron_chunks():
    """The geometry constants the card test holds against the library,
    and nemotron's call (1 x 4096, 96/8): 5 heads a chunk (31.5 MB of Q,
    dO and dQ under the 32 MB budget), 32 kv pairs each, 66 clusters
    resident on 132 SMs; a 2 x 2048 4/2 call is one chunk (the pairs
    heaviest first over every unit)."""
    plan = fa.bwd192_plan(1, 4096, 4096, 96, 8, True)
    assert (plan.kv_rows, plan.cluster, plan.threads, plan.smem) == (
        64, 2, 256, fa.BWD192_SMEM)
    assert (plan.chunk, plan.resident, len(plan.clusters)) == (5, 66, 3072)
    assert [c.h for c in plan.clusters[:6]] == [0, 1, 2, 3, 4, 0]
    assert plan.clusters[160].h == 5 and plan.clusters[160].k0 == 0
    small = fa.bwd192_plan(2, 2048, 2048, 4, 2, True)
    assert small.chunk == 8
    assert [c.k0 for c in small.clusters[:9]] == [0] * 8 + [128]
    with pytest.raises(ValueError):
        fa.bwd192_plan(1, 64, 64, 3, 2, True)
