"""Kernel entry points + dispatch policy (port of ``repro.kernels.ops``).

``flash_attention`` is a ``torch.autograd.Function`` with a FLASH
backward (the reference's ``_flash_vjp`` custom VJP): the forward saves
(q, k, v, out, lse) and the backward recomputes probabilities block by
block.  The implementation follows the tensor's device, where the
reference follows ``REPRO_PALLAS`` / the backend:

  * a CUDA tensor plays the reference's ``_pallas_mode() == "on"``: the
    forward and backward always take the CUDA kernels
    (kernels/flash_attention.py), ragged shapes included;
  * a CPU tensor follows the reference's ``"off"`` rule: the dense
    ``flash_attention_ref`` below ``DENSE_MAX_SEQ**2`` logits (with a
    dense lse for the backward), the plain blockwise forward above it,
    and the plain blockwise backward;
  * ``engine="torch"`` pins the plain blockwise forward and backward on
    any device (tests hold the kernels against it end to end).

Ring attention's two per-block work items:

  * ``flash_attention_step`` folds one kv block into an online-softmax
    carry; a CUDA tensor launches the carry kernel
    (``flash_attention.flash_attention_carry``), a CPU tensor takes the
    plain step, ``engine="torch"`` pins the plain step on any device;
  * ``flash_attention_bwd_block`` is the backward of one step, dispatched
    the same way: a CUDA tensor launches the block backward kernel (in
    bf16 the flash backward's tensor-core kernel with the offset
    difference and the caller's dsum; in f32 its SIMT kernels), a CPU
    tensor or ``engine="torch"`` takes the plain version.  The reference's
    is jnp (it reaches no TPU kernel); both compute
    ``_flash_bwd_blockwise``'s math.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import instrument
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    NEG_INF, Partials, _blk_mask, _grouped, _ungrouped, flash_attention_bwd,
    flash_attention_bwd_block_torch, flash_attention_carry,
    flash_attention_fwd, flash_attention_step_torch, flash_attention_torch,
    init_partials)
from repro_torch.kernels.flash_attention import \
    flash_attention_bwd_block as fa_bwd_block
from repro_torch.kernels.stencil import jacobi_step  # noqa: F401 (re-export)

#: sequences at or above this use a blockwise implementation
DENSE_MAX_SEQ = 2048


def flash_attention_applicable(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> bool:
    """attend() fast-path predicate: True when a blockwise implementation
    (the kernel on a card) should replace the dense reference."""
    return (q.dim() == 4 and k.dim() == 4
            and q.shape[1] * k.shape[1] >= DENSE_MAX_SEQ * DENSE_MAX_SEQ
            or instrument.on_card(q))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    engine: str = "auto") -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd] -> [B, Sq, H, hd] in q's
    type, differentiable in q, k and v.  The plain versions take kv blocks
    of 512, as the reference's blockwise engines; the CUDA kernels tile by
    64 and take any shape."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal, window, q_offset,
                                 engine)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a FLASH backward: the forward saves only
    (out, lse) beside its inputs; the backward recomputes probabilities
    block by block.  Without it, autograd through the blockwise loop would
    save an f32 probability tensor per kv block."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, engine):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_offset,
                                   engine)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, engine)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, engine = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            window=window, q_offset=q_offset, engine=engine)
        return dq, dk, dv, None, None, None, None


def _flash_fwd_impl(q, k, v, causal, window, q_offset, engine
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    if engine == "torch" or instrument.on_card(q):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, engine=engine)
    sq, skv = q.shape[1], k.shape[1]
    if sq * skv > DENSE_MAX_SEQ * DENSE_MAX_SEQ:
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    out = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    return out, _lse_dense(q, k, causal, window, q_offset)


def _lse_dense(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
               q_offset: int) -> torch.Tensor:
    """The lse residual of the dense path ([B, Sq, H] f32): the
    reference's ``_lse_blockwise`` over one block."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    logits = torch.einsum("bkgqd,bskd->bkgqs",
                          _grouped(q, kvh) * (1.0 / math.sqrt(hd)),
                          k.float())
    mask = _blk_mask(sq, skv, 0, q_offset + torch.arange(sq,
                                                         device=q.device),
                     skv, causal, window)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1) if skv else torch.full(
        logits.shape[:4], NEG_INF, device=q.device)
    l = torch.where(mask, torch.exp(logits - m[..., None]), 0.0).sum(-1)
    return _ungrouped(m + torch.log(torch.clamp(l, min=1e-30)))


def flash_attention_blockwise(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0,
                              blk_kv: int = 512) -> torch.Tensor:
    """Online-softmax flash in plain torch over kv blocks (forward only):
    the kernel's second oracle for long shapes."""
    out, _ = flash_attention_torch(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, blk_kv=blk_kv)
    return out


# ---------------------------------------------------------------------------
# Streamed flash steps (ring attention) — carry in and out, global offsets
# ---------------------------------------------------------------------------


def flash_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         carry: Partials | None = None, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0, k_offset: int = 0,
                         engine: str = "auto") -> Partials:
    """Fold one kv block into an online-softmax carry (m, l, acc — the
    public [B, Sq, H(, hd)] layout of kernels/flash_attention.py); an
    empty carry on q's device when ``carry`` is None.

    The per-arrival work item of ring attention: each ring step calls it
    on the kv block that just landed while the next block is in flight.
    ``q_offset`` / ``k_offset`` are the global positions of q[0] and k[0].
    The plain step takes kv blocks of 512, as the reference's jnp engine;
    the kernel tiles by 64 and takes any shape."""
    b, sq, h, hd = q.shape
    if carry is None:
        carry = init_partials(b, sq, h, hd, device=q.device)
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch":
        return flash_attention_step_torch(
            q, k, v, *carry, causal=causal, window=window,
            q_offset=q_offset, k_offset=k_offset)
    return flash_attention_carry(q.contiguous(), k.contiguous(),
                                 v.contiguous(), *carry, causal=causal,
                                 window=window, q_offset=q_offset,
                                 k_offset=k_offset)


def flash_attention_bwd_block(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              lse: torch.Tensor, dsum: torch.Tensor, *,
                              causal: bool, window: int = 0,
                              q_offset: int = 0, k_offset: int = 0,
                              blk_kv: int = 512, engine: str = "auto"
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Backward of one streamed flash step, recomputing p from (q, k, lse)
    (port of ``ops.flash_attention_bwd_block``).

    q, dout: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd]; lse, dsum: [B, Sq, H]
    (dsum = sum(dout * out, -1), computed once by the caller).  Returns
    f32 (dq contribution, dk, dv), so ring ranks accumulate across steps
    without dtype round trips.  A CUDA tensor launches the block backward
    kernel (``flash_attention.flash_attention_bwd_block``), a CPU tensor
    takes the plain version over kv blocks of ``blk_kv`` (memory O(Sq *
    blk_kv)); ``engine="torch"`` pins the plain version on any device."""
    if engine not in ("auto", "torch"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "torch":
        return flash_attention_bwd_block_torch(
            q, k, v, dout, lse, dsum, causal=causal, window=window,
            q_offset=q_offset, k_offset=k_offset, blk_kv=blk_kv)
    return fa_bwd_block(q.contiguous(), k.contiguous(), v.contiguous(),
                        dout.contiguous(), lse.contiguous(),
                        dsum.contiguous(), causal=causal, window=window,
                        q_offset=q_offset, k_offset=k_offset, blk_kv=blk_kv)
