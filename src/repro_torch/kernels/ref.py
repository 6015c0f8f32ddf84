"""Plain oracles for the kernels (port of ``repro.kernels.ref``)."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import NEG_INF


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Dense attention oracle.  q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd]
    (GQA: head h attends kv head h * KV // H)."""
    b, sq, h, hd = q.shape
    _, skv, kvh, _ = k.shape
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(hd)
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def jacobi_step_ref(u: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """5-point Jacobi sweep on the interior of u ([M, N], Dirichlet
    boundary rows/cols held fixed), in u's type."""
    new = 0.25 * (u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
                  - f[1:-1, 1:-1])
    out = u.clone()
    out[1:-1, 1:-1] = new.to(u.dtype)
    return out


def jacobi_multistep_ref(u: torch.Tensor, f: torch.Tensor,
                         k: int) -> torch.Tensor:
    """k unit Jacobi sweeps — the bulk oracle for the temporally-blocked
    kernel (kernels/stencil.py::jacobi_multistep)."""
    for _ in range(k):
        u = jacobi_step_ref(u, f)
    return u
