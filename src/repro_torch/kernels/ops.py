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
  * ``flash_attention_bwd_block`` is the backward of one step.  It is
    plain torch on every device, as the reference's is jnp: it reaches no
    TPU kernel.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (NEG_INF, Partials,
                                                 _blk_mask, _grouped,
                                                 _pad_kv, _step_mask,
                                                 _ungrouped,
                                                 flash_attention_bwd,
                                                 flash_attention_carry,
                                                 flash_attention_fwd,
                                                 flash_attention_step_torch,
                                                 flash_attention_torch,
                                                 init_partials)
from repro_torch.kernels.stencil import jacobi_step  # noqa: F401 (re-export)

#: sequences at or above this use a blockwise implementation
DENSE_MAX_SEQ = 2048


def flash_attention_applicable(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> bool:
    """attend() fast-path predicate: True when a blockwise implementation
    (the kernel on a card) should replace the dense reference."""
    return (q.dim() == 4 and k.dim() == 4
            and q.shape[1] * k.shape[1] >= DENSE_MAX_SEQ * DENSE_MAX_SEQ
            or q.device.type == "cuda")


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
    if engine == "torch" or q.device.type == "cuda":
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
                              blk_kv: int = 512
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Backward of one streamed flash step, recomputing p from (q, k, lse)
    (port of ``ops.flash_attention_bwd_block``).

    q, dout: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd]; lse, dsum: [B, Sq, H]
    (dsum = sum(dout * out, -1), computed once by the caller).  Returns
    f32 (dq contribution, dk, dv), so ring ranks accumulate across steps
    without dtype round trips.  Memory stays O(Sq * blk_kv)."""
    b, sq, h, hd = q.shape
    k, v, skv_valid = _pad_kv(k, v, max(1, min(blk_kv, k.shape[1])))
    skv = k.shape[1]
    blk = max(1, min(blk_kv, skv))
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf = _grouped(q, kvh)                            # [b,kvh,g,sq,hd]
    do = _grouped(dout, kvh)
    lse_g = _grouped(lse, kvh)
    dsum_g = _grouped(dsum, kvh)
    qpos = q_offset + torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for ki in range(skv // blk):
        ks = k[:, ki * blk:(ki + 1) * blk].float()
        vs = v[:, ki * blk:(ki + 1) * blk].float()
        logits = torch.einsum("bkgqd,bskd->bkgqs", qf * scale, ks)
        mask = _step_mask(sq, blk, ki, qpos, k_offset, skv_valid, causal,
                          window)
        p = torch.where(mask, torch.exp(logits - lse_g[..., None]), 0.0)
        dvs.append(torch.einsum("bkgqs,bkgqd->bskd", p, do))
        dp = torch.einsum("bkgqd,bskd->bkgqs", do, vs)
        ds = p * (dp - dsum_g[..., None]) * scale
        dq = dq + torch.einsum("bkgqs,bskd->bkgqd", ds, ks)
        dks.append(torch.einsum("bkgqs,bkgqd->bskd", ds, qf))
    dk = (torch.cat(dks, dim=1) if dks
          else k.new_zeros(k.shape, dtype=torch.float32))
    dv = (torch.cat(dvs, dim=1) if dvs
          else v.new_zeros(v.shape, dtype=torch.float32))
    return _ungrouped(dq), dk[:, :skv_valid], dv[:, :skv_valid]
