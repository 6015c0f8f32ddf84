"""Shared layers — norms, MLPs, embeddings, RoPE — for the decode flow
(port of the decode half of ``repro.models.layers``).

Decode flow ("TP-2D"): the residual is [B, D_loc(data)], the batch is
replicated, and the feature/vocab contractions close with managed
all-reduces over ``data`` / ``model``.  At axis size 1 those are the
identity (core/managed.py), so each function below is the plain
one-device computation.  The SP-flow (training/prefill) layers come with
the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed
from repro_torch.parallel.sharding import MeshCtx

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rms_norm_sharded(x: torch.Tensor, scale_loc: torch.Tensor, eps: float,
                     axis_name: str, ctx: MeshCtx) -> torch.Tensor:
    """RMSNorm over a feature dim sharded across ``axis_name`` (decode
    flow): only the scalar sum-of-squares crosses the link."""
    xf = x.float()
    ssq = (xf * xf).sum(dim=-1, keepdim=True)
    d_total = x.shape[-1] * ctx.axis_sizes.get(axis_name, 1)
    var = managed.managed_all_reduce(ssq, axis_name, ctx) / d_total
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale_loc.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def activation(name: str, u: torch.Tensor,
               g: torch.Tensor | None) -> torch.Tensor:
    """Gated (u = gate, g = linear) or plain activation.  GELU is the tanh
    approximation, jax.nn.gelu's default."""
    if name == "swiglu":
        return F.silu(u) * g
    if name == "geglu":
        return F.gelu(u, approximate="tanh") * g
    if name == "relu2":
        r = F.relu(u)
        return r * r
    if name == "gelu":
        return F.gelu(u, approximate="tanh")
    raise ValueError(name)


def gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


def mlp_block_decode(x: torch.Tensor, params: dict, cfg: ModelConfig,
                     ctx: MeshCtx) -> torch.Tensor:
    """Dense MLP, decode flow: x [B, D_loc(data)] -> same.
    Weight-stationary: contract the FSDP dim with psum('data'), come back
    with psum('model')."""
    if gated(cfg.mlp):
        ug = managed.managed_all_reduce(
            torch.cat([x @ params["w_up"], x @ params["w_gate"]], dim=-1),
            "data", ctx, mode=ctx.mdmp_mode)
        uu, g = ug.chunk(2, dim=-1)
        h = activation(cfg.mlp, uu, g)
    else:
        u = managed.managed_all_reduce(x @ params["w_up"], "data", ctx,
                                       mode=ctx.mdmp_mode)
        h = activation(cfg.mlp, u, None)
    y = managed.managed_all_reduce(h @ params["w_down"], "model", ctx,
                                   mode=ctx.mdmp_mode)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / logits / sampling
# ---------------------------------------------------------------------------


def embed_decode(tokens: torch.Tensor, table_loc: torch.Tensor,
                 cfg: ModelConfig, ctx: MeshCtx) -> torch.Tensor:
    """Decode-flow lookup: tokens [B] -> x [B, D_loc(data)].  The reference
    contracts a one-hot over the vocab; at tp=1 the row lookup gives the
    identical values without the [B, V] one-hot.  A token outside the
    table embeds to zeros, as its all-zero one-hot does (and an
    out-of-range index would be a device-side assert on CUDA)."""
    if ctx.tp != 1:
        raise NotImplementedError(
            "vocab-parallel embed_decode comes with ROADMAP Queue 1 slice 4")
    v = table_loc.shape[0]
    tok = tokens.long()
    inside = (tok >= 0) & (tok < v)
    return table_loc[tok.clamp(0, v - 1)] * inside[:, None].to(
        table_loc.dtype)


def logits_decode(x: torch.Tensor, unembed_loc: torch.Tensor,
                  ctx: MeshCtx) -> torch.Tensor:
    """Decode-flow logits: x [B, D_loc(data)] @ W_un [D_loc, V_loc(model)]
    -> psum('data') -> [B, V_loc(model)]."""
    return managed.managed_all_reduce(x @ unembed_loc, "data", ctx,
                                      mode=ctx.mdmp_mode)


def greedy_sample(logits_loc: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """Greedy decode over [B, V] logits: the lowest index among the maxima
    (``torch.argmax`` returns the first maximum), int32, on the device."""
    if ctx.tp != 1:
        raise NotImplementedError(
            "vocab-parallel greedy_sample comes with ROADMAP Queue 1 slice 4")
    return torch.argmax(logits_loc, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [S] (global positions).  Rotate-half
    (not interleaved), computed in f32 and cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[:, None].float() * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]               # [1, S, 1, hd/2]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope_slots(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """Per-slot RoPE for the serving decode flow: every batch row sits at
    its OWN position.  x: [B, H, hd]; positions: [B].  The batch axis
    plays apply_rope's position axis — the same rotation."""
    return apply_rope(x[None], positions, theta)[0]
