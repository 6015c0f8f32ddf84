"""The tensor-core grouped backward's plan (``grouped_matmul.grouped_bwd_plan``
and ``dw_stages``), on the CPU: the launches and walks that the kernels
``ffn_bwd_act_wgmma_kernel``, ``ffn_bwd_dh_wgmma_kernel`` and
``ffn_bwd_dw_wgmma_kernel`` (csrc/grouped_matmul.cu) compute in place of
their Python twins.  Held against the plain backward's masks: every output
tile of act / dU / dG, dh, dw1, dw1g and dw2 is written by exactly one CTA,
and each weight-gradient tile contracts every kept row of its expert's
groups exactly once and no other row, even where the rows past valid hold
NaN.  The built kernels' geometry is held to the plan on the card
(tests/test_torch_kernels_card.py)."""

import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as gm

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import GROUPED_BWD_TC_SHAPES, MOE_TRAIN  # noqa: E402

MOONSHOT = (MOE_TRAIN["e"], MOE_TRAIN["c"], MOE_TRAIN["d"], MOE_TRAIN["f"],
            MOE_TRAIN["e"])
#: (G, C, D, F, E): the card's shapes, moonshot's training call, two
#: groups an expert, C = 129 (one row into the second row tile) and F =
#: 192 (no multiple of 128: step 1's and dw1's last column tile is half
#: out of the tensor)
SHAPES = GROUPED_BWD_TC_SHAPES + [MOONSHOT, (8, 129, 128, 192, 4),
                                  (6, 65, 192, 192, 3), (4, 1, 64, 64, 2)]
#: valid counts, cycled over the groups: none, one row, either side of a
#: 64-row warpgroup and of a 32-row stage, and all of C
VALID = (0, 1, 63, 64, 65, None)
SMALL = [s for s in SHAPES if s != MOONSHOT]


def _valid(shape, seed):
    g, c = shape[:2]
    if shape == MOONSHOT:                  # routed-like counts, ~C * 0.8
        rng = np.random.default_rng(seed)
        out = np.clip(rng.normal(0.8 * c, 0.15 * c, size=g), 0, c)
        out[seed % g] = 0
        return out.astype(np.int64)
    vals = [c if v is None else min(v, c) for v in VALID]
    return np.array([vals[(i + seed) % len(vals)] for i in range(g)])


def _ids(shape):
    return "x".join(map(str, shape))


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plan_geometry_walks_and_grids(shape, gated):
    """Five launches in stream order, each with ``GROUPED_BWD_GEOMETRY``'s
    geometry and min(n_sm, tiles) persistent CTAs, each output tile's
    origin on its tile grid, every origin of the grid once."""
    g, c, d, f, e = shape
    plan = gm.grouped_bwd_plan(g, c, d, f, e, gated, n_sm=132)
    assert [ln.step for ln in plan.launches] == list(gm.GROUPED_BWD_STEPS)
    out_dims = {"dact": (g, c, f), "act": (g, c, f), "dh": (g, c, d),
                "dw1": (e, d, f), "dw2": (e, f, d)}
    for ln in plan.launches:
        assert (ln.threads, ln.rows, ln.cols, ln.depth, ln.stages,
                ln.smem) == gm.GROUPED_BWD_GEOMETRY[(ln.step, gated)]
        assert ln.smem <= 232448
        assert ln.grid == min(132, len(ln.tiles))
        z, m, n = out_dims[ln.step]
        want = {(i, r, col) for i in range(z) for r in range(0, m, ln.rows)
                for col in range(0, n, ln.cols)}
        assert Counter(ln.tiles) == Counter(want)


def _written(plan_launch, dims, valid, c, live_only):
    """Element counts of one output written by the launch's CTAs (each
    taking tiles b, b + grid, ...); live_only: the kernel skips a row tile
    at or past valid[g] and writes rows below valid[g] only."""
    count = np.zeros(dims, np.int32)
    ln = plan_launch
    for b in range(ln.grid):
        for t in range(b, len(ln.tiles), ln.grid):
            i, r0, c0 = ln.tiles[t]
            r1 = min(r0 + ln.rows, dims[1])
            if live_only:
                v = max(0, min(int(valid[i]), c))
                if r0 >= v:
                    continue
                r1 = min(r1, v)
            count[i, r0:r1, c0:c0 + ln.cols] += 1
    return count


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "ungated"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SMALL, ids=_ids)
def test_every_output_element_written_once(shape, seed, gated):
    """Step 1 writes each kept row of dact and of act / dU / dG once (and
    no row the plain backward masks), step 2 every element of dh once
    (zeros past valid), step 3 every element of dw1 [and dw1g] and dw2
    once."""
    g, c, d, f, e = shape
    valid = _valid(shape, seed)
    plan = gm.grouped_bwd_plan(g, c, d, f, e, gated, n_sm=7)
    dact, act, dh, dw1, dw2 = plan.launches
    live = np.arange(c)[None, :, None] < valid[:, None, None]
    for ln in (dact, act):
        got = _written(ln, (g, c, f), valid, c, True)
        assert np.array_equal(got, np.broadcast_to(live, (g, c, f))
                              .astype(int))
    assert (_written(dh, (g, c, d), valid, c, False) == 1).all()
    # gated: each dw1 tile's columns are the same columns of dw1 and dw1g
    assert (_written(dw1, (e, d, f), valid, c, False) == 1).all()
    assert (_written(dw2, (e, f, d), valid, c, False) == 1).all()


def _plain_live(valid, c):
    """The plain backward's row mask (``grouped_expert_ffn_bwd_torch``:
    rows < valid, valid as given, so negative or past-C counts clamp)."""
    rows = torch.arange(c)
    return (rows[None, :] < torch.as_tensor(valid)[:, None]).numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step3_contracts_each_kept_row_once(shape, seed):
    """For every expert, ``dw_stages`` covers each kept row of its groups
    exactly once, in row order, in stages of at most 32 rows, and no row
    the plain backward masks; the rows a stage zeroes are all masked; an
    expert with no kept row has no stage."""
    g, c, d, f, e = shape
    gpe = g // e
    valid = _valid(shape, seed)
    live = _plain_live(valid, c)
    depth = gm.GROUPED_BWD_GEOMETRY[("dw1", True)][3]
    for ex in range(e):
        stages = gm.dw_stages(valid, c, ex, gpe, depth)
        rows = [(gg, r) for gg, r0, kept in stages
                for r in range(r0, r0 + kept)]
        want = [(gg, r) for gg in range(ex * gpe, (ex + 1) * gpe)
                for r in range(c) if live[gg, r]]
        assert rows == want
        for gg, r0, kept in stages:
            assert 0 < kept <= depth and r0 % depth == 0
            assert not live[gg, r0 + kept:r0 + depth].any()
        if not want:
            assert stages == []


@pytest.mark.parametrize("shape", SMALL, ids=_ids)
def test_step3_twin_sums_equal_the_plain_masked_product(shape):
    """Step 3's twin in f32: for each tile of the dw2 walk, the stages'
    whole 32-row boxes with rows [kept, 32) zeroed, summed, equal the
    plain backward's product over its masked rows (act^T dy with rows
    past valid selected to 0), though every row past valid holds NaN."""
    g, c, d, f, e = shape
    gpe = g // e
    valid = _valid(shape, 1)
    rng = np.random.default_rng(sum(shape))
    a = rng.normal(size=(g, c, f)).astype(np.float32)
    b = rng.normal(size=(g, c, d)).astype(np.float32)
    live = _plain_live(valid, c)
    a[~live] = np.nan
    b[~live] = np.inf
    pad = -(-c // 32) * 32 - c           # rows past C read as zeros (TMA)
    ap = np.concatenate([a, np.zeros((g, pad, f), np.float32)], 1)
    bp = np.concatenate([b, np.zeros((g, pad, d), np.float32)], 1)
    ln = gm.grouped_bwd_plan(g, c, d, f, e, False).launches[-1]
    assert ln.step == "dw2"
    got = np.zeros((e, f, d), np.float32)
    for ex, m0, n0 in ln.tiles:
        acc = np.zeros((ln.rows, ln.cols), np.float32)
        for gg, r0, kept in gm.dw_stages(valid, c, ex, gpe, ln.depth):
            sa = ap[gg, r0:r0 + ln.depth, m0:m0 + ln.rows].copy()
            sb = bp[gg, r0:r0 + ln.depth, n0:n0 + ln.cols].copy()
            sa[kept:] = 0
            sb[kept:] = 0
            sa = np.pad(sa, ((0, 0), (0, ln.rows - sa.shape[1])))
            sb = np.pad(sb, ((0, 0), (0, ln.cols - sb.shape[1])))
            acc += sa.T @ sb
        mm, nn = min(ln.rows, f - m0), min(ln.cols, d - n0)
        got[ex, m0:m0 + mm, n0:n0 + nn] = acc[:mm, :nn]
    ta = torch.where(torch.from_numpy(live)[..., None], torch.from_numpy(a),
                     0.0).reshape(e, gpe * c, f)
    tb = torch.where(torch.from_numpy(live)[..., None], torch.from_numpy(b),
                     0.0).reshape(e, gpe * c, d)
    want = torch.bmm(ta.transpose(1, 2), tb).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiples of 64"):
        gm.grouped_bwd_plan(4, 16, 96, 128, 2, True)
    with pytest.raises(ValueError, match="multiple of E"):
        gm.grouped_bwd_plan(5, 16, 64, 128, 2, True)
