"""The hd-192 flash forward's plan (``flash_attention.fwd192_plan``), on
the CPU: the launch order and each CTA's kv tiles that the kernel
``flash_fwd_wgmma_skip_kernel`` (csrc/flash_attention.cu) computes in
place of its Python twin.  Held against the plain version's mask, tile by
tile: every (b, h, 128-row query tile) unit is one CTA, which visits
every 64-row kv tile holding one of its unmasked pairs and no other, and
the order takes the heaviest units first under causality.  The built
kernel's geometry is held to the plan on the card
(tests/test_torch_kernels_card.py)."""

import os
import sys

import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import FLASH192_CASES  # noqa: E402

#: (B, Sq, Skv, H, KV, causal, window, q_offset), as FLASH192_CASES: one
#: kv tile (Skv <= 64), odd tile counts that wrap the 2-stage ring (7,
#: 11), Sq not a multiple of 128, a window smaller than a tile, causal
#: with q_offset > 0 and Sq < Skv, G = 1 and 12, B = 2, a block before
#: the query rows (negative offset, nothing visible under causality) and
#: a block past a window
RAGGED_CASES = [
    (2, 130, 50, 12, 1, False, 0, 0),
    (1, 200, 430, 24, 2, False, 0, 0),
    (1, 704, 704, 8, 2, True, 0, 0),
    (1, 129, 129, 8, 8, True, 0, 0),
    (1, 257, 257, 12, 1, True, 30, 0),
    (2, 300, 320, 24, 2, True, 0, 20),
    (1, 127, 257, 8, 8, True, 0, 100),
    (1, 190, 257, 12, 12, True, 30, 67),
    (1, 128, 128, 24, 2, True, 0, -200),
    (2, 130, 129, 12, 1, False, 16, 500),
    (1, 64, 64, 8, 2, False, 0, 0),
]
CASES = [pytest.param(c, id="-".join(map(str, c)))
         for c in FLASH192_CASES + RAGGED_CASES]


def _seen(sq, skv, causal, window, q_offset):
    """[query tile] -> {kv tile holding a pair of it that the plain
    version's mask leaves unmasked} (``_step_mask``: key < Skv, key <=
    query when causal, query - key < window when windowed), for 128-row
    query tiles and 64-row kv tiles."""
    qpos = np.arange(sq)[:, None] + q_offset
    kpos = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= qpos - kpos < window
    qt, kt = fa.FWD192_Q_ROWS, fa.FWD192_KV_ROWS
    rows, cols = -(-sq // qt), -(-skv // kt)
    pad = np.zeros((rows * qt, cols * kt), bool)
    pad[:sq, :skv] = ok
    hit = pad.reshape(rows, qt, cols, kt).any(axis=(1, 3))
    return [set(np.nonzero(r)[0].tolist()) for r in hit]


@pytest.mark.parametrize("case", CASES)
def test_fwd192_plan_visits_every_unmasked_tile_once(case):
    """One CTA per (b, h, query tile); each visits exactly the kv tiles
    holding one of its unmasked pairs, as one contiguous run."""
    b, sq, skv, h, kvh, causal, window, q_offset = case
    plan = fa.fwd192_plan(b, sq, skv, h, kvh, causal, window, q_offset)
    keys = [(u.b, u.h, u.q0) for u in plan.units]
    assert len(keys) == len(set(keys)), "a unit is launched twice"
    n_qt = -(-sq // plan.q_rows)
    assert set(keys) == {(bb, hh, t * plan.q_rows) for bb in range(b)
                         for hh in range(h) for t in range(n_qt)}
    seen = _seen(sq, skv, causal, window, q_offset)
    for u in plan.units:
        got = set(range(u.t0, u.t0 + u.n_tiles))
        assert got == seen[u.q0 // plan.q_rows], u


@pytest.mark.parametrize("case", CASES)
def test_fwd192_plan_orders_heaviest_first(case):
    """Heads fastest, then batch rows, then query tiles; under causality
    the last query tile first, so without a window no unit follows a
    lighter one (with one, the units but the first few are alike)."""
    b, sq, skv, h, kvh, causal, window, q_offset = case
    plan = fa.fwd192_plan(b, sq, skv, h, kvh, causal, window, q_offset)
    assert [u.h for u in plan.units[:h]] == list(range(h))
    assert [u.b for u in plan.units[:b * h:h]] == list(range(b))
    tiles = [u.n_tiles for u in plan.units]
    if causal:
        q0s = [u.q0 for u in plan.units]
        assert q0s == sorted(q0s, reverse=True)
    if causal and window == 0:
        assert tiles == sorted(tiles, reverse=True), \
            "a lighter unit before a heavier one"


def test_fwd192_plan_geometry_and_nemotron_call():
    """The geometry constants the card test holds against the library (a
    producer and two consumer warpgroups of 64 query rows, 2 stages of 64
    kv rows, Q 48 KB + 2 x (K 24 KB + V 24 KB) + the barriers), and
    nemotron's call (1 x 4096, 96/8 heads, causal): 3072 CTAs over 101,376
    kv tiles, the first 96 on the last query tile's 64 tiles, the last on
    the first tile's 2."""
    plan = fa.fwd192_plan(1, 4096, 4096, 96, 8, True)
    assert (plan.q_rows, plan.kv_rows, plan.stages, plan.threads) == (
        128, 64, 2, 384)
    assert plan.smem == fa.FWD192_SMEM == 3 * 16384 + 4 * 24576 + 8 * 9 \
        + 1024
    assert len(plan.units) == 3072 and plan.resident == 132
    assert sum(u.n_tiles for u in plan.units) == 101376
    assert {u.n_tiles for u in plan.units[:96]} == {64}
    assert plan.units[-1] == fa.Fwd192Unit(0, 95, 0, 0, 2)
    with pytest.raises(ValueError):
        fa.fwd192_plan(1, 64, 64, 3, 2, True)
