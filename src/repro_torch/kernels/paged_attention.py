"""Paged decode attention — hand-written CUDA kernel + plain PyTorch version
(port of ``repro.kernels.paged_attention``).

The serving runtime stores each sequence's KV cache as a chain of
fixed-size PAGES drawn from a shared pool ([n_pages, page, KV, hd] per
layer); a per-slot page table maps logical block i of slot b to pool page
``table[b, i]``.  Decode attention gathers K/V through the page table.

Two engines with identical math:

  * the CUDA kernel ``csrc/paged_attention.cu`` (Hopper, ``sm_90a``), in
    place of the reference's Pallas TPU kernel ``paged_attention_pallas``:
    one CTA per (kv head, slot) walks only that slot's ``ceil(lens/page)``
    pages with an online softmax in f32 (see the source's note);
  * ``paged_attention_partials_torch`` — a loop over table columns that
    computes one flash partial per page and folds it with the
    ``merge_partials`` LSE combinator.  It also takes a ``pool_offset``
    for pools sharded over mesh axes: pages owned by other ranks
    contribute an empty partial, and the caller LSE-merges across ranks.

``paged_attention`` dispatches on the tensor's device: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (NEG_INF, Partials,
                                                 finalize_partials,
                                                 init_partials,
                                                 merge_partials)

#: kernel launches since the count was last set to 0
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
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
    test-only switch that holds the kernel against it end to end)."""
    global LAUNCHES
    _check(q, k_pages, v_pages, table, lens)
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch" or q.device.type == "cpu":
        return paged_attention_torch(q, k_pages, v_pages, table, lens,
                                     window=window)
    if q.device.type != "cuda":
        raise RuntimeError(f"no paged-attention kernel for {q.device}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"the kernel takes f32 or bf16 q and pools of the "
                        f"same type; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, table,
                                           lens)):
        raise ValueError("the kernel takes contiguous tensors")
    b, h, hd = q.shape
    n_pages, page, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), table.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, h, kvh, hd, page, table.shape[1], n_pages,
            int(window), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg}")
    LAUNCHES += 1
    return out
