"""Online-softmax partials: init / merge / finalize (port of the plain
combinators of ``repro.kernels.flash_attention``).

Public carry layout (matches q): m, l: [B, Sq, H] f32; acc: [B, Sq, H, hd]
f32.  ``out = acc / l`` and ``lse = m + log(l)`` only at finalize — every
intermediate stays unnormalised so partials from disjoint KV ranges
combine with one LSE merge.  ``NEG_INF`` is finite, so fully masked rows
give zeros, not NaN.

The flash-attention kernel itself (``flash_attention_pallas`` in the
reference) is ported with the training slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

Partials = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def init_partials(b: int, sq: int, h: int, hd: int,
                  device: torch.device | str = "cpu") -> Partials:
    """Empty carry: max = -inf (finite sentinel), sum = 0, acc = 0."""
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=device)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=device)
    acc = torch.zeros((b, sq, h, hd), dtype=torch.float32, device=device)
    return m, l, acc


def merge_partials(p1: Partials, p2: Partials) -> Partials:
    """LSE-merge two flash partials over disjoint KV ranges.  Commutative
    and associative up to float rounding; an empty carry (init_partials)
    is the identity."""
    m1, l1, a1 = p1
    m2, l2, a2 = p2
    m = torch.maximum(m1, m2)
    w1 = torch.exp(m1 - m)
    w2 = torch.exp(m2 - m)
    l = w1 * l1 + w2 * l2
    acc = w1[..., None] * a1 + w2[..., None] * a2
    return m, l, acc


def finalize_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, l, acc) -> (out [B, Sq, H, hd], lse [B, Sq, H])."""
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).to(out_dtype)
    lse = m + torch.log(l_safe)
    return out, lse
