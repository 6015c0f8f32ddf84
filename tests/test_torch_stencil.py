"""The port's Jacobi stencil (kernels/stencil.py, kernels/ref.py) held
against the reference's, on the CPU.

On CPU tensors the wrappers take their plain versions, which are held to
the reference's Pallas kernels in interpret mode (``jacobi_step_pallas``,
``jacobi_ksweep_pallas``, ``jacobi_multistep_pallas``), to its jnp
trapezoid ``ksweep_trapezoid`` and its halo-padded ``_five_point``, and to
its oracles in ``kernels/ref.py``.  Shapes, k values and tolerances are
those of tests/test_kernels.py: f32 within 1e-6, bf16 within 2e-2 (one
sweep) and 5e-2 (four sweeps).  Inputs come from a numpy seed.  The CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels_card.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import halo as ref_halo
from repro.kernels import ref as ref_ref
from repro.kernels import stencil as ref_stencil
from repro_torch.kernels import ops, ref, stencil


def _rand(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype=dtype)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(want,
                                                             np.float32),
        rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("m,n,bm,bn", [
    (66, 130, 64, 128),
    (130, 130, 64, 64),
    (258, 514, 128, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi_step_matches_pallas(m, n, bm, bn, dtype):
    rng = np.random.default_rng(3)
    u, f = _rand(rng, (m, n)), _rand(rng, (m, n))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_stencil.jacobi_step_pallas(_j(u, jdt), _j(f, jdt), blk_m=bm,
                                          blk_n=bn, interpret=True)
    oracle = ref_ref.jacobi_step_ref(_j(u, jdt), _j(f, jdt))
    got = stencil.jacobi_step(_t(u, tdt), _t(f, tdt))
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    _close(got, want, tol, "vs pallas")
    _close(got, oracle, tol, "vs ref")
    _close(ref.jacobi_step_ref(_t(u, tdt), _t(f, tdt)), oracle, tol,
           "port oracle vs reference oracle")


@pytest.mark.parametrize("m,n,bm", [
    (66, 130, 64),        # single-tile fallback (66 % 64 != 0)
    (256, 130, 64),       # 4-block grid
    (128, 258, 16),       # 8-block grid, tiny tiles
])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
def test_jacobi_multistep_matches_pallas(m, n, bm, k):
    """k sweeps per round trip against the Pallas kernel and against k
    unit sweeps of both oracles — the trapezoid plus frozen Dirichlet edges
    is redundant compute, not approximation."""
    rng = np.random.default_rng(7)
    u, f = _rand(rng, (m, n)), _rand(rng, (m, n))
    want = ref_stencil.jacobi_multistep_pallas(_j(u), _j(f), k=k, blk_m=bm,
                                               interpret=True)
    got = stencil.jacobi_multistep(_t(u), _t(f), k=k)
    _close(got, want, 1e-6, "vs pallas")
    _close(got, ref_ref.jacobi_multistep_ref(_j(u), _j(f), k), 1e-6,
           "vs reference oracle")
    _close(got, ref.jacobi_multistep_ref(_t(u), _t(f), k), 1e-6,
           "vs port oracle")


def test_jacobi_multistep_bf16():
    rng = np.random.default_rng(8)
    u, f = _rand(rng, (128, 130)), _rand(rng, (128, 130))
    want = ref_stencil.jacobi_multistep_pallas(
        _j(u, jnp.bfloat16), _j(f, jnp.bfloat16), k=4, blk_m=32,
        interpret=True)
    got = stencil.jacobi_multistep(_t(u, torch.bfloat16),
                                   _t(f, torch.bfloat16), k=4)
    assert got.dtype == torch.bfloat16
    _close(got, want, 5e-2)
    _close(got, ref_ref.jacobi_multistep_ref(_j(u, jnp.bfloat16),
                                             _j(f, jnp.bfloat16), 4), 5e-2)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("frozen", ["none", "k", "k+1"])
def test_jacobi_ksweep_slab_matches_pallas(k, frozen):
    """The distributed slab kernel's contract: a k-deep apron of live
    neighbour rows (frozen depths 0), or pinned ghost rows, against the
    Pallas slab kernel; with depths 0 also against k sweeps of the larger
    grid in which every row updates."""
    rng = np.random.default_rng(9)
    m, n = 64, 130
    big, fbig = _rand(rng, (m + 2 * k, n)), _rand(rng, (m + 2 * k, n))
    depth = {"none": 0, "k": k, "k+1": k + 1}[frozen]
    want = ref_stencil.jacobi_ksweep_pallas(_j(big), _j(fbig), k, depth,
                                            depth, blk_m=32, interpret=True)
    got = stencil.jacobi_ksweep(_t(big), _t(fbig), k, depth, depth)
    assert got.shape == (m, n)
    _close(got, want, 1e-6)
    if depth == 0:
        oracle = big.copy()
        for _ in range(k):
            up = np.concatenate([np.zeros((1, n), np.float32), oracle,
                                 np.zeros((1, n), np.float32)])
            oracle[:, 1:-1] = 0.25 * (up[:-2, 1:-1] + up[2:, 1:-1]
                                      + up[1:-1, :-2] + up[1:-1, 2:]
                                      - fbig[:, 1:-1])
        _close(got, oracle[k:-k], 1e-6, "vs the larger grid")


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("frozen", [(0, 0), (2, 0), (0, 5), (3, 3)])
def test_ksweep_trapezoid_matches_reference(k, frozen):
    """The plain trapezoid against the reference's jnp one on a whole
    tile, every row (not only the valid centre) equal."""
    rng = np.random.default_rng(11)
    tile, ftile = _rand(rng, (40, 34)), _rand(rng, (40, 34))
    want = ref_stencil.ksweep_trapezoid(_j(tile), _j(ftile), k, *frozen)
    got = stencil.ksweep_trapezoid(_t(tile), _t(ftile), k, *frozen)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("m", [1, 2, 7])
def test_jacobi_step_with_halo_rows_matches_five_point(m):
    """``jacobi_step`` with ``lo`` / ``hi`` is the reference's halo-padded
    ``_five_point`` on ``[lo; u; hi]``; ``rows`` writes only those rows of
    ``out``."""
    rng = np.random.default_rng(12)
    u, f = _rand(rng, (m, 34)), _rand(rng, (m, 34))
    lo, hi = _rand(rng, (1, 34)), _rand(rng, (1, 34))
    want = np.asarray(ref_halo._five_point(
        _j(np.concatenate([lo, u, hi])), _j(f)))
    got = stencil.jacobi_step(_t(u), _t(f), lo=_t(lo), hi=_t(hi))
    _close(got, want, 1e-6)
    out = torch.full((m, 34), 7.0)
    stencil.jacobi_step(_t(u), _t(f), lo=_t(lo), hi=_t(hi),
                        rows=((0, 1), (m - 1, m)), out=out)
    keep = np.full((m, 34), 7.0, np.float32)
    keep[[0, m - 1]] = want[[0, m - 1]]
    _close(out, keep, 1e-6)


def test_jacobi_converges():
    """Sweeps reduce the residual of Laplace's equation."""
    n = 66
    u = torch.zeros((n, n))
    u[0] = 1.0
    f = torch.zeros((n, n))
    residual = lambda u: float((ref.jacobi_step_ref(u, f) - u).abs().max())
    r0 = residual(u)
    for _ in range(50):
        u = stencil.jacobi_step(u, f)
    assert residual(u) < r0


def test_wrappers_check_their_arguments():
    u = torch.zeros((8, 10))
    with pytest.raises(ValueError):
        stencil.jacobi_step(u, torch.zeros((8, 9)))
    with pytest.raises(ValueError, match="out"):
        stencil.jacobi_step(u, u, rows=((1, 7),))
    with pytest.raises(ValueError):
        stencil.jacobi_step(u, u, lo=torch.zeros((2, 10)))
    with pytest.raises(ValueError):
        stencil.jacobi_ksweep(u, u, 4, 0, 0)       # needs 2k + 1 rows
    with pytest.raises(ValueError):
        stencil.jacobi_step(u, u, engine="pallas")
    assert ops.jacobi_step is stencil.jacobi_step
    # the k-sweep kernel's ring at k = 8 in f32: 7 rows of u and 13 of f
    # of a 768-column band (16 bytes of slack a row), the staged output
    # row twice, 7 inner sweeps' edges of 6 warps (+ 2) twice
    assert stencil.ksweep_band(8) == 768
    assert stencil.ksweep_smem_bytes(8) == \
        20 * (768 * 4 + 16) + 2 * 768 * 4 + 4 * 2 * 7 * 8 * 2
    with pytest.raises(ValueError, match="k <= 8"):
        stencil.ksweep_smem_bytes(stencil.KSWEEP_MAX_K + 1)


# -- the k-sweep kernel's plan: pieces, aprons, strips --------------------

#: (m, n) of the main path (one rank of the 16386^2 solve, and its 8-rank
#: block), ragged, tiny, and one row
PLAN_SHAPES = [(16386, 16386), (2048, 16386), (1000, 777), (5, 130),
               (3, 3), (1, 1), (3001, 130), (700, 2101)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", range(1, stencil.KSWEEP_MAX_K + 1))
@pytest.mark.parametrize("m,n", PLAN_SHAPES)
def test_ksweep_plan_covers_every_point_once(m, n, k, dtype):
    """The plan's (band, strip) pieces cover every output point exactly
    once, each loading its k-column and k-row apron; it fills the SMs once
    where the rows allow and never cuts a strip below KSWEEP_MIN_STRIP * k
    rows; its CTAs fit an SM's shared memory as often as it counts."""
    plan = stencil.ksweep_plan(m, n, k, dtype, 132)
    assert plan.band == stencil.ksweep_band(k)
    assert plan.ctas == plan.bands * plan.strips
    centre = plan.band - 2 * k                           # written columns
    covered_cols = np.zeros(n, np.int64)
    for bx in range(plan.bands):
        c0 = bx * centre
        assert c0 < n                                    # no empty band
        covered_cols[c0:min(c0 + centre, n)] += 1
        cb = c0 - k                                      # loaded: apron k
        assert cb + plan.band == c0 + centre + k
    covered_rows = np.zeros(m, np.int64)
    for by in range(plan.strips):
        r0 = by * plan.strip
        assert r0 < m                                    # no empty strip
        covered_rows[r0:min(r0 + plan.strip, m)] += 1
    assert (covered_cols == 1).all() and (covered_rows == 1).all()
    smem = stencil.ksweep_smem_bytes(k, dtype.itemsize)
    assert smem <= stencil.SMEM_LIMIT
    assert stencil.KSWEEP_CTAS * (smem + 1024) <= stencil.SM_SMEM
    if plan.strips > 1:
        assert plan.strip >= stencil.KSWEEP_MIN_STRIP * k
        assert plan.ctas <= stencil.KSWEEP_CTAS * 132


def test_ksweep_plan_on_the_main_path():
    """16386^2 f32 at k = 2, 4, 8: 22 bands of 768 columns, and 12 strips
    of 1366 rows that fill the 132 SMs once (2 CTAs each), so the 2k rows
    computed twice are 0.3-1.2% of a strip."""
    for k in (2, 4, 8):
        assert stencil.ksweep_plan(16386, 16386, k, torch.float32, 132) == \
            stencil.KsweepPlan(768, 22, 1366, 12, 264)


def _stitched(u_pad, f_pad, k, frozen_top, frozen_bot, plan):
    """The kernel's decomposition in plain torch: each (band, strip) piece
    through ``ksweep_trapezoid`` on its own apron tile (clipped to the
    array), frozen rows by global padded row, its centre kept."""
    mp, n = u_pad.shape
    m = mp - 2 * k
    out = torch.full((m, n), float("nan"))
    for by in range(plan.strips):
        r0 = by * plan.strip
        rows = min(plan.strip, m - r0)
        r1 = r0 + rows + 2 * k                           # padded rows loaded
        centre = plan.band - 2 * k
        for bx in range(plan.bands):
            c0, cb = bx * centre, bx * centre - k
            c1 = min(c0 + centre, n)
            lo, hi = max(cb, 0), min(cb + plan.band, n)
            tile = stencil.ksweep_trapezoid(
                u_pad[r0:r1, lo:hi], f_pad[r0:r1, lo:hi], k,
                max(0, frozen_top - r0), max(0, frozen_bot - (mp - r1)))
            out[r0:r0 + rows, c0:c1] = tile[k:k + rows, c0 - lo:c1 - lo]
    return out


#: (m, n, plan override): the plan at 4 SMs (m = None: three strips of at
#: least KSWEEP_MIN_STRIP * k rows, the last ragged, and two bands at n =
#: 1100); strips of 3 rows, so that a strip boundary falls inside the
#: frozen rows; m < k
STITCH_CASES = [(None, 1100, None), (40, 130, 3), (5, 130, None)]


@pytest.mark.parametrize("frozen", ["none", "k", "k+1"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m,n,strip", STITCH_CASES,
                         ids=lambda c: str(c))
def test_ksweep_plan_stitched_equals_pallas(m, n, strip, k, frozen):
    """The plan's pieces, each swept on its own apron tile, equal the
    reference's Pallas slab kernel (interpret mode) bit for bit in f32."""
    depth = {"none": 0, "k": k, "k+1": k + 1}[frozen]
    m = 3 * stencil.KSWEEP_MIN_STRIP * k + 1 if m is None else m
    rng = np.random.default_rng(13)
    u_pad, f_pad = _rand(rng, (m + 2 * k, n)), _rand(rng, (m + 2 * k, n))
    plan = stencil.ksweep_plan(m, n, k, torch.float32, 4)
    if strip is not None:
        plan = plan._replace(strip=strip, strips=-(-m // strip))
    if m >= 3 * stencil.KSWEEP_MIN_STRIP * k:
        assert plan.strips >= 3 and m % plan.strip != 0
    want = ref_stencil.jacobi_ksweep_pallas(_j(u_pad), _j(f_pad), k, depth,
                                            depth, interpret=True)
    got = _stitched(_t(u_pad), _t(f_pad), k, depth, depth, plan)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- k > 8: chained launches over one slab --------------------------------


def test_ksweep_chain_depths():
    """k sweeps on the card as launches of depth <= KSWEEP_MAX_K: 8s, the
    remainder last."""
    assert stencil.ksweep_chain(8) == (8,)
    assert stencil.ksweep_chain(9) == (8, 1)
    assert stencil.ksweep_chain(16) == (8, 8)
    assert stencil.ksweep_chain(23) == (8, 8, 7)
    with pytest.raises(ValueError):
        stencil.ksweep_chain(0)


@pytest.mark.parametrize("frozen", ["none", "k", "k+1"])
@pytest.mark.parametrize("k", [9, 16, 23])
def test_ksweep_chained_stitched_equals_pallas(k, frozen):
    """The card's path for k > 8 — ``ksweep_chained``'s launches, each
    run as the kernel's plan pieces on their own apron tiles
    (``_stitched``, frozen rows by global padded row) — equals the
    reference's Pallas slab kernel (interpret mode) bit for bit in f32."""
    depth = {"none": 0, "k": k, "k+1": k + 1}[frozen]
    m, n = 2 * stencil.KSWEEP_MIN_STRIP * stencil.KSWEEP_MAX_K + 3, 900
    rng = np.random.default_rng(k)
    u_pad, f_pad = _rand(rng, (m + 2 * k, n)), _rand(rng, (m + 2 * k, n))
    plans = []

    def sweep(u_lo, u, u_hi, f_lo, f, f_hi, d, ft, fb, out):
        plan = stencil.ksweep_plan(u.shape[0], n, d, torch.float32, 4)
        plans.append(plan)
        got = _stitched(torch.cat([u_lo, u, u_hi]), torch.cat([f_lo, f,
                                                                f_hi]),
                        d, ft, fb, plan)
        return got if out is None else out.copy_(got)

    got = stencil.ksweep_chained(_t(u_pad), _t(f_pad), k, depth, depth,
                                 sweep)
    assert len(plans) == len(stencil.ksweep_chain(k))
    assert all(p.bands == 2 for p in plans) and plans[0].strips > 1
    want = ref_stencil.jacobi_ksweep_pallas(_j(u_pad), _j(f_pad), k, depth,
                                            depth, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the wrapper's plain path takes any k and agrees
    plain = stencil.jacobi_ksweep(_t(u_pad), _t(f_pad), k, depth, depth)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
