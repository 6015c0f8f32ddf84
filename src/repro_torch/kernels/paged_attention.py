"""Paged decode attention — hand-written CUDA kernels + plain PyTorch version
(port of ``repro.kernels.paged_attention``).

The serving runtime stores each sequence's KV cache as a chain of
fixed-size PAGES drawn from a shared pool ([n_pages, page, KV, hd] per
layer); a per-slot page table maps logical block i of slot b to pool page
``table[b, i]``.  Decode attention gathers K/V through the page table.

Two engines with identical math:

  * the CUDA kernels ``csrc/paged_attention.cu`` (Hopper, ``sm_90a``), in
    place of the reference's Pallas TPU kernel ``paged_attention_pallas``
    (see the source's note).  In bf16 at hd 32, 64, 128 and 192 the chain
    is cut into splits of whole pages (flash-decoding): one CTA per
    (16 query heads of a kv head, split, slot) copies its pages with
    16-byte ``cp.async`` into a ring of shared-memory stages, computes on
    the tensor cores (``mma.sync``, G padded to 16, P.V as bf16 hi + lo
    pairs), and a second kernel merges the splits' f32 partials in split
    order.  ``split_plan`` picks the pages per split on the host from the
    shapes and the SM count only, never from ``lens``, so the wrapper
    never waits for the card and can be captured in a CUDA graph.  f32
    (and bf16 at other head dims) keeps the first port's kernel: one CTA
    per (kv head, slot) with f32 tiles.  What bounds each (the bytes of
    K/V, and at the serving shapes the latency of dependent loads) and
    what is left for later: the note at the top of the source;
  * ``paged_attention_partials_torch`` — a loop over table columns that
    computes one flash partial per page and folds it with the
    ``merge_partials`` LSE combinator.  It also takes a ``pool_offset``
    for pools sharded over mesh axes: pages owned by other ranks
    contribute an empty partial, and the caller LSE-merges across ranks.

``paged_attention`` dispatches on the tensor's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
``paged_attention_partials`` does the same for a pool sharded over ranks:
the kernel (either engine) writes this rank's f32 partials, pages of other
ranks contributing nothing, for the caller's LSE merge.  ``LAUNCHES``
counts wrapper calls that launched the kernel, so a run can show that its
main path went through it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core import instrument
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (NEG_INF, Partials,
                                                 finalize_partials,
                                                 init_partials,
                                                 merge_partials)

#: kernel launches since the count was last set to 0
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of the bf16 fast path (split-KV, cp.async stages)
FAST_HEAD_DIMS = (32, 64, 128, 192)
#: query heads per CTA of the fast path (the m16n8k16 tile's rows)
ROW_TILE = 16
#: most page ids a split keeps in shared memory (kMaxSplitPages)
MAX_SPLIT_PAGES = 512
#: the split plan fills the card with at least this many CTAs per SM
#: (one: at the serving shapes a call is latency-bound, and more splits
#: cost more partials than they hide, as timed on the card) ...
FILL_CTAS_PER_SM = 1
#: ... and cuts long chains further, towards this many, while each split
#: keeps at least BALANCE_MIN_POSITIONS positions (slots of unequal length
#: then share the SMs evenly)
BALANCE_CTAS_PER_SM = 16
BALANCE_MIN_POSITIONS = 512
_ENGINE_CODE = {"simt": 0, "mma": 1}


# ---------------------------------------------------------------------------
# Plain PyTorch version: per-page partials merged with the LSE combinators
# ---------------------------------------------------------------------------


def paged_attention_partials_torch(q: torch.Tensor, k_pages: torch.Tensor,
                                   v_pages: torch.Tensor,
                                   table: torch.Tensor, lens: torch.Tensor,
                                   *, window: int = 0,
                                   pool_offset: int | torch.Tensor = 0
                                   ) -> Partials:
    """Flash partials of ``q`` [B, H, hd] against the page chains in a
    (possibly rank-local) pool.  ``pool_offset`` converts the table's
    GLOBAL page ids to local pool indices: entries outside the local pool
    contribute an empty partial, so partials from all ranks LSE-merge to
    the full attention.  Returns (m, l, acc) in the [B, 1, H] /
    [B, 1, H, hd] carry layout of kernels/flash_attention.py."""
    b, h, hd = q.shape
    n_loc, page, kvh, _ = k_pages.shape
    groups = h // kvh
    n_pages_max = table.shape[1]
    scale = 1.0 / math.sqrt(hd)
    # grouped GQA layout (q head h = kv*G + g, matching the kernel's h // G
    # mapping), accumulated in f32
    qg = (q.float() * scale).reshape(b, kvh, groups, hd)
    lens = lens.to(torch.int64)
    offsets = torch.arange(page, device=q.device)
    carry = init_partials(b, 1, h, hd, device=q.device)
    for i in range(n_pages_max):
        pid = table[:, i].to(torch.int64) - pool_offset          # [B]
        owned = (pid >= 0) & (pid < n_loc)
        safe = pid.clamp(0, n_loc - 1)
        kb = k_pages[safe]                           # [B, page, KV, hd]
        vb = v_pages[safe]
        logits = torch.einsum("bkgd,bskd->bkgs", qg, kb.float())
        kpos = i * page + offsets                                # [page]
        valid = owned[:, None] & (kpos[None, :] < lens[:, None])
        if window > 0:
            valid &= kpos[None, :] >= lens[:, None] - window
        vmask = valid[:, None, None, :]              # [B, 1, 1, page]
        logits = torch.where(vmask, logits, NEG_INF)
        m_i = logits.amax(dim=-1)                             # [B, KV, G]
        p_i = torch.exp(logits - m_i[..., None])
        p_i = torch.where(vmask, p_i, 0.0)
        l_i = p_i.sum(dim=-1)
        # p rounded to the pool's type, then an f32 product (the
        # reference's preferred_element_type=f32)
        acc_i = torch.einsum("bkgs,bskd->bkgd",
                             p_i.to(vb.dtype).float(), vb.float())
        part = (m_i.reshape(b, 1, h), l_i.reshape(b, 1, h),
                acc_i.reshape(b, 1, h, hd))
        carry = merge_partials(carry, part)
    return carry


def paged_attention_torch(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          lens: torch.Tensor, *,
                          window: int = 0) -> torch.Tensor:
    """Self-contained plain paged attention (the kernel's oracle)."""
    m, l, acc = paged_attention_partials_torch(
        q, k_pages, v_pages, table, lens, window=window)
    out, _ = finalize_partials(m, l, acc, out_dtype=q.dtype)
    return out[:, 0]


# ---------------------------------------------------------------------------
# The split plan (host side, from shapes only) and the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def split_plan(pmax: int, page: int, batch: int, kv_heads: int,
               row_tiles: int, n_sm: int) -> tuple[int, int]:
    """(pages per split, splits) for a chain of ``pmax`` table columns of
    ``page`` positions.  Every split is a run of whole columns and the
    splits cover the columns once, in order.  The CTAs of one split are
    ``batch * kv_heads * row_tiles``; the plan asks for at least
    ``FILL_CTAS_PER_SM * n_sm`` CTAs where the table has the columns, and
    cuts a long chain further (towards ``BALANCE_CTAS_PER_SM * n_sm``, each
    split keeping ``BALANCE_MIN_POSITIONS`` positions) so that slots of
    unequal length share the SMs evenly.  It never reads ``lens``: splits
    past a slot's length cost a CTA that writes an empty partial."""
    if min(pmax, page, batch, kv_heads, row_tiles, n_sm) <= 0:
        raise ValueError("split_plan takes positive sizes")
    per_split = batch * kv_heads * row_tiles
    fill = -(-FILL_CTAS_PER_SM * n_sm // per_split)
    balance = min(-(-BALANCE_CTAS_PER_SM * n_sm // per_split),
                  pmax * page // BALANCE_MIN_POSITIONS)
    want = max(1, min(pmax, max(fill, balance)))
    pps = -(-pmax // want)
    if -(-pmax // pps) * per_split < FILL_CTAS_PER_SM * n_sm:
        pps = max(1, pmax // want)   # rounding down: at least `want` splits
    pps = min(pps, MAX_SPLIT_PAGES)
    return pps, -(-pmax // pps)


def split_partials_torch(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, table: torch.Tensor,
                         lens: torch.Tensor, pages_per_split: int, *,
                         window: int = 0) -> Partials:
    """The plain partials of each split of ``pages_per_split`` table
    columns, stacked in split order: m and l [n_splits, B, H], acc
    [n_splits, B, H, hd].  A split sees its own columns only; the others
    are set to -1, outside the pool, where they contribute nothing."""
    pmax = table.shape[1]
    parts = []
    for lo in range(0, pmax, pages_per_split):
        own = torch.full_like(table, -1)
        own[:, lo:lo + pages_per_split] = table[:, lo:lo + pages_per_split]
        m, l, acc = paged_attention_partials_torch(q, k_pages, v_pages, own,
                                                   lens, window=window)
        parts.append((m[:, 0], l[:, 0], acc[:, 0]))
    return tuple(torch.stack(x) for x in zip(*parts))


class Plan(NamedTuple):
    """How one call runs on the card: the engine and the split plan."""
    engine: str              # "mma" (the bf16 fast path) or "simt" (f32)
    pages_per_split: int
    n_splits: int
    ctas: int


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(q: torch.Tensor, k_pages: torch.Tensor,
                table: torch.Tensor) -> Plan:
    """The plan the wrapper launches for these shapes on q's card."""
    b, h, hd = q.shape
    page, kvh = k_pages.shape[1], k_pages.shape[2]
    pmax = table.shape[1]
    if q.dtype != torch.bfloat16 or hd not in FAST_HEAD_DIMS:
        return Plan("simt", pmax, 1, kvh * b)
    row_tiles = -(-(h // kvh) // ROW_TILE)
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    pps, n = split_plan(pmax, page, b, kvh, row_tiles, _sm_count(index))
    return Plan("mma", pps, n, n * b * kvh * row_tiles)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                       i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_pages, v_pages, table, lens) -> None:
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"q must be [B, H, hd] and pools [n_pages, page, "
                         f"KV, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}")
    b, h, hd = q.shape
    kvh = k_pages.shape[2]
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if table.dim() != 2 or table.shape[0] != b or tuple(lens.shape) != (b,):
        raise ValueError(f"table must be [B, pmax] and lens [B] for B={b}; "
                         f"got {tuple(table.shape)}, {tuple(lens.shape)}")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("table and lens must be int32")
    devs = {t.device for t in (q, k_pages, v_pages, table, lens)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")


def paged_work(lens, window: int, h: int, kvh: int, hd: int, page: int,
               itemsize: int) -> tuple[int, int]:
    """(flops, bytes) of one call over rows of ``lens`` valid positions:
    the function's least work, however a kernel runs it.  Flops: q.k and
    p.v, 2 each per attended (position, head, hd); bytes: the attended
    K and V read once, q read and the output written once, the lengths
    and the page table read once."""
    b = len(lens)
    need = sum(min(int(n), window) if window else int(n) for n in lens)
    pmax = max(1, -(-int(max(lens, default=0)) // page))
    nbytes = (need * kvh * hd * 2 * itemsize          # K and V
              + 2 * b * h * hd * itemsize             # q in, out
              + 4 * b * (1 + pmax))                   # lens, table
    return 4 * h * hd * need, nbytes


def local_positions(table: torch.Tensor, lens: torch.Tensor, page: int,
                    n_pages: int, pool_offset: int, window: int = 0
                    ) -> list[int]:
    """The positions each row attends in a rank-local pool of ``n_pages``
    whose first page has GLOBAL id ``pool_offset``: those below its length
    (and in its window) whose page lies in this pool."""
    pos = torch.arange(table.shape[1] * page, device=table.device)
    pid = table.long()[:, pos // page] - pool_offset
    n = lens.long()[:, None]
    keep = (pos[None, :] < n) & (pid >= 0) & (pid < n_pages)
    if window > 0:
        keep &= pos[None, :] >= n - window
    return keep.sum(dim=1).tolist()


def _work(q, k_pages, table, window: int, lens=None, pool_offset=None):
    """A wrapper's launch, as the recorder reads it: ``paged_work`` over
    the lengths ``lens`` holds (of a rank's pool, only the positions whose
    page it holds: ``local_positions``), or over every row's full table
    where there are none to read (a dry run's meta tensors: the shape's
    full context)."""
    def work():
        b, h, hd = q.shape
        n_pages, page, kvh, _ = k_pages.shape
        if lens is None:
            return paged_work([table.shape[1] * page] * b, window, h, kvh,
                              hd, page, q.element_size())
        if pool_offset is None:
            return paged_work(lens.tolist(), window, h, kvh, hd, page,
                              q.element_size())
        return paged_work(local_positions(table, lens, page, n_pages,
                                          pool_offset, window), 0, h, kvh,
                          hd, page, q.element_size())
    return work


def _check_operands(q, k_pages, v_pages, table, lens) -> None:
    """What the kernels take — types, contiguity — checked on the card and
    on abstract (meta) tensors alike."""
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes f32 or bf16 q and pools of the "
                        f"same type; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, table,
                                           lens)):
        raise ValueError("the kernel takes contiguous tensors")


def _check_card(q, k_pages, v_pages, table, lens) -> Plan | None:
    """What the kernels need beyond ``_check``; the plan of the call (None
    for an empty batch)."""
    if q.device.type != "cuda":
        raise RuntimeError(f"no paged-attention kernel for {q.device}")
    _check_operands(q, k_pages, v_pages, table, lens)
    if q.shape[0] == 0:
        return None
    plan = launch_plan(q, k_pages, table)
    if plan.engine == "mma":
        bad = [name for name, t in (("q", q), ("k_pages", k_pages),
                                    ("v_pages", v_pages))
               if t.data_ptr() % 16]
        if bad:
            raise ValueError(f"the bf16 paged kernel copies 16-byte chunks: "
                             f"{', '.join(bad)} must start on a 16-byte "
                             f"boundary")
    return plan


def _launch(q, k_pages, v_pages, table, lens, window: int, plan: Plan,
            out: torch.Tensor | None, ws_acc: torch.Tensor | None,
            ws_ml: torch.Tensor | None, *, partials: Partials | None = None,
            pool_offset: int = 0) -> None:
    """Launch ``plan`` (the split kernel and, with several splits or
    ``partials``, the merge), writing ``out`` or the f32 ``partials`` (m,
    l, acc) and the splits' partials to the workspaces."""
    global LAUNCHES
    b, h, hd = q.shape
    n_pages, page, kvh, _ = k_pages.shape
    ptr = [None if t is None else t.data_ptr()
           for t in (out, ws_acc, ws_ml, *(partials or (None,) * 3))]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODE[q.dtype], _ENGINE_CODE[plan.engine], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
            lens.data_ptr(), *ptr, b, h, kvh, hd, page, table.shape[1],
            n_pages, int(pool_offset), int(window), 1.0 / math.sqrt(hd),
            plan.pages_per_split, plan.n_splits, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg}")
    LAUNCHES += 1
    instrument.note_kernel("paged_attention",
                           (q, k_pages, v_pages, table, lens),
                           partials or (out,),
                           work=_work(q, k_pages, table, window, lens,
                                      pool_offset if partials else None))


def _workspaces(q: torch.Tensor, plan: Plan, partials: bool = False):
    """The f32 partials' workspaces (acc, (m, l)) of a plan with splits,
    or of any split plan whose partials are asked for."""
    if plan.engine == "simt" or (plan.n_splits == 1 and not partials):
        return None, None
    b, h, hd = q.shape
    return (torch.empty((plan.n_splits, b, h, hd), dtype=torch.float32,
                        device=q.device),
            torch.empty((plan.n_splits, b, h, 2), dtype=torch.float32,
                        device=q.device))


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    lens: torch.Tensor, *, window: int = 0,
                    engine: str = "auto") -> torch.Tensor:
    """q: [B, H, hd]; k_pages, v_pages: [n_pages, page, KV, hd];
    table: [B, n_pages_max] int32 pool page ids (entries past
    ``ceil(lens/page)`` may hold any id); lens: [B] int32 valid lengths.
    Returns [B, H, hd] in q's dtype.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version.  ``engine="torch"`` pins the plain version on any device (a
    test-only switch that holds the kernel against it end to end).

    On the card, bf16 at hd 32, 64, 128 and 192 takes the split-KV fast
    path (``launch_plan``): its 16-byte copies need q and both pools on
    16-byte boundaries, and the wrapper raises otherwise.  The plan comes
    from the shapes and the SM count alone; the host reads nothing from
    the card, and the f32 workspaces of the splits' partials come from
    ``torch.empty``, so a call can be captured in a CUDA graph."""
    _check(q, k_pages, v_pages, table, lens)
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" or q.device.type == "cpu":
        return paged_attention_torch(q, k_pages, v_pages, table, lens,
                                     window=window)
    if instrument.is_meta(q):
        _check_operands(q, k_pages, v_pages, table, lens)
        return instrument.meta_kernel(
            "paged_attention", (q, k_pages, v_pages, table, lens),
            torch.empty_like(q), work=_work(q, k_pages, table, window))
    plan = _check_card(q, k_pages, v_pages, table, lens)
    out = torch.empty_like(q)
    if plan is None:
        return out
    _launch(q, k_pages, v_pages, table, lens, window, plan, out,
            *_workspaces(q, plan))
    return out


def split_partials(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, table: torch.Tensor,
                   lens: torch.Tensor, *, window: int = 0
                   ) -> tuple[Plan, Partials]:
    """The fast path's f32 partials of each split, read back from the
    card's workspace after one launch of the wrapper's plan, in the layout
    of ``split_partials_torch`` (m in natural-log units; a split with
    nothing to attend has m = NEG_INF, l = 0 and acc = 0).  For checks that
    hold the kernel's f32 products against the plain version at f32
    tolerances, which the bf16 output cannot show.  bf16 on a CUDA card
    only, with at least two splits."""
    _check(q, k_pages, v_pages, table, lens)
    plan = _check_card(q, k_pages, v_pages, table, lens)
    if plan is None or plan.engine != "mma" or plan.n_splits < 2:
        raise ValueError(f"split_partials needs the card's split-KV path "
                         f"with two or more splits; got {plan}")
    out = torch.empty_like(q)
    ws_acc, ws_ml = _workspaces(q, plan)
    _launch(q, k_pages, v_pages, table, lens, window, plan, out, ws_acc,
            ws_ml)
    l = ws_ml[..., 1]
    m = torch.where(l > 0, ws_ml[..., 0] * math.log(2.0), NEG_INF)
    return plan, (m, l, torch.where(l[..., None] > 0, ws_acc, 0.0))


def paged_attention_partials(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, table: torch.Tensor,
                             lens: torch.Tensor, *, window: int = 0,
                             pool_offset: int = 0,
                             engine: str = "auto") -> Partials:
    """The flash partials (m, l, acc) of ``q`` [B, H, hd] against the page
    chains in a rank-local pool, in the layout of
    ``paged_attention_partials_torch``: m in natural-log units and l
    [B, 1, H], acc [B, 1, H, hd] unnormalised, all f32.  ``table`` holds
    GLOBAL page ids: id - ``pool_offset`` indexes ``k_pages``, and an entry
    outside it (another rank's page) contributes nothing, so the partials
    of all ranks LSE-merge to the whole attention.  A CUDA tensor launches
    the kernel (the bf16 fast path through its merge, or the f32 path's
    kernel; ``launch_plan``) or raises, a CPU tensor or ``engine="torch"``
    takes the plain version, and a meta tensor under a recorder counts as
    one ``paged_attention`` launch."""
    _check(q, k_pages, v_pages, table, lens)
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" or q.device.type == "cpu":
        return paged_attention_partials_torch(q, k_pages, v_pages, table,
                                              lens, window=window,
                                              pool_offset=pool_offset)
    b, h, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    parts = (torch.empty((b, 1, h), **f32), torch.empty((b, 1, h), **f32),
             torch.empty((b, 1, h, hd), **f32))
    if instrument.is_meta(q):
        _check_operands(q, k_pages, v_pages, table, lens)
        return instrument.meta_kernel(
            "paged_attention", (q, k_pages, v_pages, table, lens), parts,
            work=_work(q, k_pages, table, window))
    plan = _check_card(q, k_pages, v_pages, table, lens)
    if plan is not None:
        _launch(q, k_pages, v_pages, table, lens, window, plan, None,
                *_workspaces(q, plan, partials=True), partials=parts,
                pool_offset=int(pool_offset))
    return parts
