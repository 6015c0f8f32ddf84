"""Jacobi 5-point stencil — hand-written CUDA kernels + plain PyTorch
versions (port of ``repro.kernels.stencil``).

The paper's running example (Fig. 2-4) is a 2-D Jacobi sweep whose halo
exchange MDMP manages; within a shard the sweep is a memory-bound
stencil.  Two kernels, in ``csrc/stencil.cu`` (Hopper, ``sm_90a``):

  * ``jacobi_step`` — one sweep (replaces ``jacobi_step_pallas``).  It
    reads the neighbours from ``u`` itself (the reference passes four
    shifted views to keep its BlockSpecs disjoint), takes any shape, and
    also serves the halo-padded sweep of ``core/halo.py``: the rows above
    and below the block arrive as ``lo`` / ``hi`` pointers, so no padded
    copy of ``u`` is made per sweep, and ``rows`` restricts the rows
    written (the interleaved schedule's interior and edge-row passes).
  * ``jacobi_ksweep`` — k sweeps per device-memory round trip of a
    k-halo-padded slab, the trapezoid of ``ksweep_trapezoid`` (replaces
    ``jacobi_ksweep_pallas``).  The Pallas tile spans whole rows; the
    CUDA kernel is a k-stage pipeline that a CTA streams down a strip of
    rows of a column band, each sweep's three-row window in registers
    and the rows of u and f loaded ahead into a ring in shared memory.
    ``ksweep_plan`` gives the band, the strip and the CTAs from shapes
    alone; ``ksweep_smem_bytes`` is the ring the kernel holds, which
    ``core/cost_model.py`` prices.  ``jacobi_ksweep_parts`` takes the
    slab as its three parts (ghost rows above, the block, ghost rows
    below), which is how the aggregated solve calls it;
    ``jacobi_multistep`` is the reference's Dirichlet wrapper.  The
    kernel holds each sweep's window in registers, one instantiation per
    k up to ``KSWEEP_MAX_K``; a deeper k runs as chained launches over
    the same slab (``ksweep_chain``, ``ksweep_chained``).

Beside each kernel is its plain version (``jacobi_step_torch``,
``ksweep_trapezoid`` / ``jacobi_ksweep_torch``) with the same arithmetic:
f32 in the reference's order of operations, so f32 results agree bit for
bit.  A wrapper launches the kernel for a CUDA tensor (or raises) and takes
the plain version for a CPU tensor; ``engine="torch"`` pins the plain
version on any device (a test switch).  ``STEP_LAUNCHES`` and
``KSWEEP_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import instrument
from repro_torch.kernels import build

#: kernel launches since the count was last set to 0
STEP_LAUNCHES = 0
KSWEEP_LAUNCHES = 0

#: the k-sweep kernel's geometry (csrc/stencil.cu): threads a CTA, columns
#: a thread owns (a band loads the product), CTAs the launch bounds keep
#: resident on an SM, rows of u and f loaded ahead of the first sweep, and
#: the deepest k (one instantiation per k: each sweep's window lives in
#: registers)
KSWEEP_THREADS = 192
KSWEEP_COLS = 4
KSWEEP_CTAS = 2
KSWEEP_AHEAD = 4
KSWEEP_MAX_K = 8
#: the plan cuts no strip shorter than this many rows per sweep, so the 2k
#: rows a strip computes twice stay under 1 / 20 of its rows
KSWEEP_MIN_STRIP = 40
#: shared memory one thread block may use on Hopper, and one SM's (each
#: resident CTA also takes 1 KB of it), bytes
SMEM_LIMIT = 232448
SM_SMEM = 233472

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Rows = tuple[tuple[int, int], ...]


def _check_k(k: int) -> None:
    if not 1 <= k <= KSWEEP_MAX_K:
        raise ValueError(f"k={k}: one launch of the k-sweep kernel takes "
                         f"1 <= k <= {KSWEEP_MAX_K} (one instantiation per "
                         f"k; its sweeps' windows live in registers)")


def ksweep_chain(k: int) -> tuple[int, ...]:
    """The depths of the launches that run ``k`` sweeps on the card:
    ``KSWEEP_MAX_K`` each, the remainder last (one launch for k <= 8)."""
    if k < 1:
        raise ValueError(f"k must be >= 1; got {k}")
    whole, rest = divmod(int(k), KSWEEP_MAX_K)
    return (KSWEEP_MAX_K,) * whole + ((rest,) if rest else ())


def ksweep_band(k: int) -> int:
    """Columns one CTA of the k-sweep kernel loads: its 2k apron columns
    and the band - 2k it writes."""
    _check_k(k)
    return KSWEEP_THREADS * KSWEEP_COLS


def ksweep_smem_bytes(k: int, itemsize: int = 4) -> int:
    """Shared memory a CTA of the k-sweep kernel opts into (``kSmem``):
    a ring of ``KSWEEP_AHEAD + 3`` rows of u and ``KSWEEP_AHEAD + k + 1``
    of f in the array's type (16 bytes of slack a row), the last sweep's
    row staged twice in f32, and each inner sweep's warp edges twice."""
    band = ksweep_band(k)
    rows = (KSWEEP_AHEAD + 3) + (KSWEEP_AHEAD + k + 1)
    edges = 2 * (k - 1) * (KSWEEP_THREADS // 32 + 2) * 2
    return rows * (band * itemsize + 16) + 2 * band * 4 + 4 * edges


class KsweepPlan(NamedTuple):
    """How one k-sweep call runs on the card: a grid of bands x strips."""
    band: int        # columns a CTA loads (it writes band - 2k)
    bands: int
    strip: int       # output rows a CTA walks (it loads strip + 2k)
    strips: int
    ctas: int        # bands x strips


def ksweep_plan(m: int, n: int, k: int, dtype: torch.dtype = torch.float32,
                n_sm: int = 132) -> KsweepPlan:
    """The k-sweep kernel's plan for an [m, n] block: bands of
    ``ksweep_band(k)`` columns, then as many strips of rows as fill the
    SMs once (``KSWEEP_CTAS`` CTAs each), down to strips of
    ``KSWEEP_MIN_STRIP * k`` rows.  Reads shapes and the SM count only,
    never a value; ``dtype`` leaves it unchanged, since the ring of
    either type fits an SM ``KSWEEP_CTAS`` times at every k."""
    if min(m, n, n_sm) < 1:
        raise ValueError("ksweep_plan takes positive sizes")
    band = ksweep_band(k)
    bands = -(-n // (band - 2 * k))
    strips = max(1, min((KSWEEP_CTAS * n_sm) // bands,
                        m // (KSWEEP_MIN_STRIP * k)))
    strip = -(-m // strips)
    strips = -(-m // strip)
    return KsweepPlan(band, bands, strip, strips, bands * strips)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _five_point(up, down, left, right, f):
    """The reference's order: ((up + down) + left) + right - f, then *0.25."""
    return 0.25 * (up + down + left + right - f)


def jacobi_step_torch(u: torch.Tensor, f: torch.Tensor, *,
                      lo: torch.Tensor | None = None,
                      hi: torch.Tensor | None = None) -> torch.Tensor:
    """One sweep of ``u`` [M, N] in f32, every row written: rows 0 and M-1
    take their outer neighbour from ``lo`` / ``hi`` ([1, N]), or are copied
    (Dirichlet) where that is None; columns 0 and N-1 are copied."""
    uf, ff = u.float(), f.float()
    z = uf.new_zeros((1, uf.shape[1]))
    up = torch.cat([z if lo is None else lo.float(), uf,
                    z if hi is None else hi.float()])
    new = uf.clone()
    new[:, 1:-1] = _five_point(up[:-2, 1:-1], up[2:, 1:-1], uf[:, :-2],
                               uf[:, 2:], ff[:, 1:-1])
    if lo is None:
        new[0] = uf[0]
    if hi is None:
        new[-1] = uf[-1]
    return new.to(u.dtype)


def ksweep_trapezoid(tile: torch.Tensor, f_tile: torch.Tensor, k: int,
                     frozen_top: int, frozen_bot: int) -> torch.Tensor:
    """Apply ``k`` masked Jacobi sweeps to a halo-padded row tile.

    tile, f_tile: [T, N] float32.  Columns 0 and N-1 are Dirichlet (never
    updated); rows 0 and T-1 are likewise never updated.  ``frozen_top`` /
    ``frozen_bot`` pin that many leading / trailing rows to their INITIAL
    value through all k sweeps (physical-boundary ghost rows).

    Validity contract (the trapezoid): if tile rows [0, T) hold
    iteration-0 values, then after this call rows [k, T-k) hold
    iteration-k values (frozen edges do not shrink)."""
    t_rows = tile.shape[0]
    rows = torch.arange(t_rows, device=tile.device)[:, None]
    upd = (rows >= frozen_top) & (rows < t_rows - frozen_bot)
    for _ in range(k):
        new = _five_point(tile[:-2, 1:-1], tile[2:, 1:-1], tile[1:-1, :-2],
                          tile[1:-1, 2:], f_tile[1:-1, 1:-1])
        mid = torch.cat([tile[1:-1, :1], new, tile[1:-1, -1:]], dim=1)
        swept = torch.cat([tile[:1], mid, tile[-1:]], dim=0)
        tile = torch.where(upd, swept, tile)
    return tile


def jacobi_ksweep_torch(u_lo: torch.Tensor, u: torch.Tensor,
                        u_hi: torch.Tensor, f_lo: torch.Tensor,
                        f: torch.Tensor, f_hi: torch.Tensor, k: int,
                        frozen_top: int, frozen_bot: int) -> torch.Tensor:
    """The k-sweep slab of ``jacobi_ksweep_parts`` in plain torch: the
    centre rows of ``ksweep_trapezoid`` on the assembled f32 slab."""
    tile = torch.cat([u_lo, u, u_hi]).float()
    f_tile = torch.cat([f_lo, f, f_hi]).float()
    out = ksweep_trapezoid(tile, f_tile, k, frozen_top, frozen_bot)
    return out[k:k + u.shape[0]].to(u.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("stencil")
    if lib.jacobi_step_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi_step_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, i,
                                           i, p]
        lib.jacobi_step_launch.restype = i
        lib.jacobi_ksweep_launch.argtypes = [i, p, p, p, p, p, p, p, i, i, i,
                                             i, i, i, p]
        lib.jacobi_ksweep_launch.restype = i
        lib.jacobi_ksweep_geometry.argtypes = [i, i, i]
        lib.jacobi_ksweep_geometry.restype = i
        lib.stencil_error_string.argtypes = [i]
        lib.stencil_error_string.restype = ctypes.c_char_p
    return lib


def ksweep_built(k: int, dtype: torch.dtype = torch.float32
                 ) -> tuple[int, int, int]:
    """(band, shared memory bytes, CTAs resident on an SM) of the built
    k-sweep kernel at k sweeps, read from the library: its constants, and
    the card's occupancy API on the compiled kernel (needs a card)."""
    _check_k(k)
    lib = _lib()
    got = tuple(lib.jacobi_ksweep_geometry(_DTYPE_CODE[dtype], k, what)
                for what in range(3))
    if min(got) < 0:
        raise RuntimeError(f"jacobi_ksweep_geometry({dtype}, {k}): {got}")
    return got


def _raise_on(lib: ctypes.CDLL, err: int, which: str) -> None:
    if err != 0:
        msg = lib.stencil_error_string(err).decode()
        raise RuntimeError(f"{which} kernel launch failed: {msg}")


def _check_engine(engine: str) -> None:
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")


def stencil_work(m: int, n: int, itemsize: int, sweeps: int,
                 u_ghost: int = 0, f_ghost: int = 0) -> tuple[int, int]:
    """(flops, bytes) of one call that leaves ``sweeps`` sweeps on an
    [m, n] block: the function's least work, however a kernel runs it.
    Flops: the 5 operations of each needed interior update; bytes: u with
    its ``u_ghost`` ghost rows and f with its ``f_ghost`` read once, u'
    written once."""
    nbytes = ((m + u_ghost) + (m + f_ghost) + m) * n * itemsize
    return 5 * m * max(n - 2, 0) * sweeps, nbytes


def _check_kernel_inputs(ref: torch.Tensor, *tensors: torch.Tensor) -> None:
    if ref.device.type != "cuda":
        raise RuntimeError(f"no stencil kernel for {ref.device}")
    _check_operands(ref, *tensors)


def _check_operands(ref: torch.Tensor, *tensors: torch.Tensor) -> None:
    """What the kernels take — types, devices, contiguity — checked on the
    card and on abstract (meta) tensors alike."""
    if ref.dtype not in _DTYPE_CODE or any(t.dtype != ref.dtype
                                           for t in tensors):
        raise TypeError(f"the stencil kernels take f32 or bf16 arrays of one "
                        f"type; got {[t.dtype for t in (ref, *tensors)]}")
    if any(t.device != ref.device for t in tensors):
        raise ValueError("inputs lie on several devices")
    if not all(t.is_contiguous() for t in (ref, *tensors)):
        raise ValueError("the stencil kernels take contiguous tensors")


def _row_ranges(rows: Rows | None, m: int) -> Rows:
    ranges = ((0, m),) if rows is None else tuple(rows)
    if len(ranges) > 2:
        raise ValueError(f"at most two row ranges; got {ranges}")
    out = []
    for a, b in ranges:
        a, b = max(0, int(a)), min(m, int(b))
        if a < b and (a, b) not in out:
            out.append((a, b))
    return tuple(out)


def jacobi_step(u: torch.Tensor, f: torch.Tensor, *,
                lo: torch.Tensor | None = None,
                hi: torch.Tensor | None = None, rows: Rows | None = None,
                out: torch.Tensor | None = None,
                engine: str = "auto") -> torch.Tensor:
    """One Jacobi sweep of ``u`` ([M, N]) with source ``f``.

    Without ``lo`` / ``hi`` it is ``jacobi_step_pallas``: boundary rows and
    columns are Dirichlet (copied through).  With them ([1, N] each: the
    rows above row 0 and below row M-1) rows 0 and M-1 are updated too,
    the halo-padded sweep of ``core/halo.py::_five_point``.  ``rows`` (at
    most two ``(start, stop)`` ranges) names the rows of ``out`` to write;
    the others are left as they are.  Without ``out`` every row is written
    to a new tensor.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version; ``engine="torch"`` pins the plain version."""
    global STEP_LAUNCHES
    _check_engine(engine)
    if u.dim() != 2 or f.shape != u.shape:
        raise ValueError(f"u and f must be [M, N] of one shape; got "
                         f"{tuple(u.shape)}, {tuple(f.shape)}")
    m, n = u.shape
    for name, h in (("lo", lo), ("hi", hi)):
        if h is not None and tuple(h.shape) != (1, n):
            raise ValueError(f"{name} must be [1, {n}]; got "
                             f"{tuple(h.shape)}")
    if rows is not None and out is None:
        raise ValueError("rows names rows of out: pass out")
    if out is not None and (out.shape != u.shape or out.dtype != u.dtype):
        raise ValueError(f"out must be {tuple(u.shape)} {u.dtype}")
    if out is not None and out.data_ptr() == u.data_ptr():
        raise ValueError("out must not be u: the sweep reads u")
    ranges = _row_ranges(rows, m)
    if engine == "torch" or u.device.type == "cpu":
        new = jacobi_step_torch(u, f, lo=lo, hi=hi)
        if out is None:
            return new
        for a, b in ranges:
            out[a:b] = new[a:b]
        return out
    halos = [h for h in (lo, hi) if h is not None]
    work = (lambda: stencil_work(m, n, u.element_size(), 1, len(halos)))
    if instrument.is_meta(u):
        _check_operands(u, f, *halos, *([] if out is None else [out]))
        return instrument.meta_kernel(
            "jacobi_step", (u, f, lo, hi),
            torch.empty_like(u) if out is None else out, work=work)
    _check_kernel_inputs(u, f, *halos, *([] if out is None else [out]))
    if out is None:
        out = torch.empty_like(u)
    if not ranges or u.numel() == 0:
        return out
    (a0, a1), (b0, b1) = (ranges + ((0, 0),))[:2]
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.jacobi_step_launch(
            _DTYPE_CODE[u.dtype], u.data_ptr(), f.data_ptr(),
            None if lo is None else lo.data_ptr(),
            None if hi is None else hi.data_ptr(), out.data_ptr(), m, n,
            a0, a1, b0, b1, stream)
    _raise_on(lib, err, "jacobi_step")
    STEP_LAUNCHES += 1
    instrument.note_kernel("jacobi_step", (u, f, lo, hi), (out,), work=work)
    return out


def jacobi_ksweep_parts(u_lo: torch.Tensor, u: torch.Tensor,
                        u_hi: torch.Tensor, f_lo: torch.Tensor,
                        f: torch.Tensor, f_hi: torch.Tensor, k: int,
                        frozen_top: int, frozen_bot: int, *,
                        out: torch.Tensor | None = None,
                        engine: str = "auto") -> torch.Tensor:
    """k Jacobi sweeps over the centre rows of the k-halo-padded slab
    ``[u_lo; u; u_hi]`` (ghost rows [k, N], the block [m, N], ghost rows
    [k, N]) with source ``[f_lo; f; f_hi]``, given as its three parts so
    that no padded copy is made.  Returns the [m, N] centre after k sweeps
    (into ``out`` when given).  ``frozen_top`` / ``frozen_bot`` pin that
    many leading / trailing padded rows (k at a non-periodic physical
    edge, 0 elsewhere).  Dispatch as ``jacobi_step``; a launch of the
    kernel runs ``ksweep_plan`` at k <= ``KSWEEP_MAX_K``, and a deeper k
    runs as the launches of ``ksweep_chained``."""
    _check_engine(engine)
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1; got {k}")
    m, n = u.shape
    for name, t, rows in (("u_lo", u_lo, k), ("u_hi", u_hi, k),
                          ("f_lo", f_lo, k), ("f", f, m), ("f_hi", f_hi, k)):
        if tuple(t.shape) != (rows, n):
            raise ValueError(f"{name} must be [{rows}, {n}]; got "
                             f"{tuple(t.shape)}")
    frozen_top, frozen_bot = int(frozen_top), int(frozen_bot)
    if min(frozen_top, frozen_bot) < 0:
        raise ValueError("frozen depths must be >= 0")
    if out is not None and (out.shape != u.shape or out.dtype != u.dtype):
        raise ValueError(f"out must be {tuple(u.shape)} {u.dtype}")
    if engine == "torch" or u.device.type == "cpu":
        new = jacobi_ksweep_torch(u_lo, u, u_hi, f_lo, f, f_hi, k,
                                  frozen_top, frozen_bot)
        return new if out is None else out.copy_(new)
    parts = (u_lo, u_hi, f_lo, f, f_hi)
    if instrument.is_meta(u):
        _check_operands(u, *parts, *([] if out is None else [out]))
        return instrument.meta_kernel(
            "jacobi_ksweep", (u_lo, u, u_hi, f_lo, f, f_hi),
            torch.empty_like(u) if out is None else out,
            work=lambda: stencil_work(m, n, u.element_size(), k, 2 * k,
                                      2 * k))
    _check_kernel_inputs(u, *parts, *([] if out is None else [out]))
    if out is None:
        out = torch.empty_like(u)
    elif any(out.data_ptr() == t.data_ptr() for t in (u_lo, u, u_hi)):
        raise ValueError("out must not be an input: the sweeps read them")
    if u.numel() == 0:
        return out
    if k > KSWEEP_MAX_K:
        return ksweep_chained(torch.cat([u_lo, u, u_hi]),
                              torch.cat([f_lo, f, f_hi]), k, frozen_top,
                              frozen_bot, _ksweep_launch, out=out)
    return _ksweep_launch(u_lo, u, u_hi, f_lo, f, f_hi, k, frozen_top,
                          frozen_bot, out)


def ksweep_chained(u_pad: torch.Tensor, f_pad: torch.Tensor, k: int,
                   frozen_top: int, frozen_bot: int, sweep, *,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """k sweeps of the k-halo-padded slab ``u_pad`` ([m + 2k, N]) as the
    launches of ``ksweep_chain(k)`` over that one slab: a launch of depth
    d on padded rows [o, Mp - o) returns rows [o + d, Mp - o - d) after d
    more sweeps (the trapezoid's centre shrinks by twice its depth), so
    the last returns the [m, N] centre after k.  Frozen depths are mapped
    by global padded row: padded rows [0, frozen_top) of the slab are
    rows [0, frozen_top - o) of a launch that starts at row o.

    ``sweep(u_lo, u, u_hi, f_lo, f, f_hi, d, frozen_top, frozen_bot,
    out)`` runs one launch on the parts of its slab (the kernel's
    launcher on the card; a test passes the plain decomposition)."""
    mp = u_pad.shape[0]
    chain = ksweep_chain(k)
    bufs = [torch.empty((mp - 2 * chain[0],) + tuple(u_pad.shape[1:]),
                        dtype=u_pad.dtype, device=u_pad.device)
            for _ in range(min(2, len(chain) - 1))]
    cur, o = u_pad, 0
    for i, d in enumerate(chain):
        t = mp - 2 * o                      # rows of this launch's slab
        fs = f_pad[o:mp - o]
        last = i == len(chain) - 1
        dst = out if last else bufs[i % 2][:t - 2 * d]
        cur = sweep(cur[:d], cur[d:t - d], cur[t - d:], fs[:d], fs[d:t - d],
                    fs[t - d:], d, max(0, frozen_top - o),
                    max(0, frozen_bot - o), dst)
        o += d
    return cur


def _ksweep_launch(u_lo: torch.Tensor, u: torch.Tensor, u_hi: torch.Tensor,
                   f_lo: torch.Tensor, f: torch.Tensor, f_hi: torch.Tensor,
                   k: int, frozen_top: int, frozen_bot: int,
                   out: torch.Tensor | None) -> torch.Tensor:
    """One launch of the k-sweep kernel (k <= ``KSWEEP_MAX_K``) on checked
    CUDA inputs; ``out`` None allocates the centre."""
    global KSWEEP_LAUNCHES
    _check_k(k)
    m, n = u.shape
    if out is None:
        out = torch.empty_like(u)
    plan = ksweep_plan(m, n, k, u.dtype, _sm_count(u.device.index))
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.jacobi_ksweep_launch(
            _DTYPE_CODE[u.dtype], u_lo.data_ptr(), u.data_ptr(),
            u_hi.data_ptr(), f_lo.data_ptr(), f.data_ptr(), f_hi.data_ptr(),
            out.data_ptr(), m, n, k, frozen_top, frozen_bot, plan.strip,
            stream)
    _raise_on(lib, err, "jacobi_ksweep")
    KSWEEP_LAUNCHES += 1
    instrument.note_kernel("jacobi_ksweep", (u_lo, u, u_hi, f_lo, f, f_hi),
                           (out,), work=lambda: stencil_work(
                               m, n, u.element_size(), k, u_lo.shape[0]
                               + u_hi.shape[0], f_lo.shape[0]
                               + f_hi.shape[0]))
    return out


def jacobi_ksweep(u_pad: torch.Tensor, f_pad: torch.Tensor, k: int,
                  frozen_top: int, frozen_bot: int, *,
                  engine: str = "auto") -> torch.Tensor:
    """k Jacobi sweeps over the centre rows of a k-halo-padded block
    ``u_pad`` / ``f_pad`` ([m + 2k, N]); returns the [m, N] centre (the
    reference's ``jacobi_ksweep_pallas`` contract)."""
    k = int(k)
    if u_pad.dim() != 2 or u_pad.shape[0] < 2 * k + 1:
        raise ValueError(f"u_pad must be [m + 2k, N] with m >= 1; got "
                         f"{tuple(u_pad.shape)} for k={k}")
    if f_pad.shape != u_pad.shape:
        raise ValueError(f"f_pad {tuple(f_pad.shape)} != u_pad "
                         f"{tuple(u_pad.shape)}")
    mp = u_pad.shape[0]
    return jacobi_ksweep_parts(
        u_pad[:k], u_pad[k:mp - k], u_pad[mp - k:], f_pad[:k],
        f_pad[k:mp - k], f_pad[mp - k:], k, frozen_top, frozen_bot,
        engine=engine)


def jacobi_multistep(u: torch.Tensor, f: torch.Tensor, *, k: int,
                     engine: str = "auto") -> torch.Tensor:
    """``k`` Jacobi sweeps on the interior of ``u`` ([M, N]) in one
    device-memory round trip: pad k zero rows above and below, freeze the
    padding plus the true boundary row (k + 1 rows) so the Dirichlet
    condition survives, and run the slab kernel (oracle: k x
    ``jacobi_step``)."""
    z = u.new_zeros((k, u.shape[1]))
    zf = f.new_zeros((k, f.shape[1]))
    return jacobi_ksweep_parts(z, u.contiguous(), z, zf, f.contiguous(), zf,
                               k, k + 1, k + 1, engine=engine)
