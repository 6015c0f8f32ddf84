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
    rows, cols = stencil.KSWEEP_TILE
    assert stencil.ksweep_smem_bytes(8) == 3 * 4 * (rows + 16) * (cols + 16)
