"""Block assembly over layers (port of ``repro.models.transformer``).

SP-flow blocks (train / prefill) take and return [B, S_loc, D]; decode
blocks [B, D_loc(data)].  Layer weights are stacked on a leading
``layers`` dim as in the reference; the reference scans over them with
``lax.scan`` (with ``jax.checkpoint`` around the block for training
remat), the port loops in Python over per-layer views, with
``torch.utils.checkpoint`` in place of ``jax.checkpoint``.  The dense and
MoE families are ported; the others raise and name the ROADMAP slice that
brings them.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe
from repro_torch.parallel.sharding import MeshCtx

#: family -> the ROADMAP Queue 1 slice that ports its blocks
FAMILY_SLICE = {"ssm": 8, "hybrid": 8, "audio": 8, "vlm": 8}
PORTED_FAMILIES = ("dense", "moe")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family comes with ROADMAP "
            f"Queue 1 slice {FAMILY_SLICE.get(cfg.family, '?')}; the port "
            "has the dense and MoE families")


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Static per-layer window (0 = full attention)."""
    if cfg.sliding_window and cfg.family == "hybrid":
        return 0 if i in cfg.full_attn_layers else cfg.sliding_window
    return cfg.sliding_window


def _layer_views(stacked: dict) -> list[dict]:
    """Per-layer views of stacked [L, ...] weights.  One ``unbind`` per
    weight: its backward stacks the L layer gradients once, where L
    separate ``w[i]`` selects would each add a zero-filled [L, ...]
    gradient."""
    cols = {k: torch.unbind(w, 0) for k, w in stacked.items()}
    n = len(next(iter(cols.values()))) if cols else 0
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# SP-flow blocks (train / prefill)
# ---------------------------------------------------------------------------


#: cfg.attn_impl -> SP attention (anything else is megatron's)
ATTN_IMPLS = {
    "ulysses": attention.attention_sp_ulysses,
    "ring": attention.attention_sp_ring,
    "auto": attention.attention_sp_auto,   # cost-model-chosen schedule
}


def block_sp(x: torch.Tensor, p: dict, cfg: ModelConfig, ctx: MeshCtx, *,
             causal: bool, window: int, collect_kv: bool,
             engine: str = "auto", moe_dispatch: moe.Dispatch | None = None,
             moe_engine: str = "auto",
             sp_plan: attention.SPPlan | None = None) -> tuple:
    """One decoder block.  Returns (x, aux_loss, (k, v) | None); the aux
    loss is the MoE load-balance term (0 for the dense family).  The SSM
    state the reference also returns comes with slice 8.  ``sp_plan`` is
    the attention decision every layer shares (``cfg.attn_impl`` resolves
    its own when None)."""
    require_ported(cfg)
    if sp_plan is not None:
        attn_fn = functools.partial(attention.attention_sp_auto,
                                    plan=sp_plan)
    else:
        attn_fn = ATTN_IMPLS.get(cfg.attn_impl, attention.attention_sp)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    att = attn_fn(h, p, cfg, ctx, causal=causal, window=window,
                  return_kv=collect_kv, engine=engine)
    kv = None
    if collect_kv:
        att, kv = att
    x = x + att
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe.moe_block(h2, p, cfg, ctx, dispatch=moe_dispatch,
                               engine=moe_engine)
    else:
        y = layers.mlp_block_sp(h2, p, cfg, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux, kv


def stack_sp(x: torch.Tensor, stacked: dict, cfg: ModelConfig,
             ctx: MeshCtx, *, causal: bool = True, collect_kv: bool = False,
             remat: bool | None = None, engine: str = "auto",
             moe_dispatch: moe.Dispatch | None = None,
             moe_engine: str = "auto",
             sp_plan: attention.SPPlan | None = None) -> tuple:
    """Run the block over the stacked layers.  With ``remat`` (default
    ``cfg.remat``) each block runs under a non-reentrant
    ``torch.utils.checkpoint``: only its input is saved and the backward
    recomputes it.  ``moe_dispatch`` / ``sp_plan`` are the resolved MoE
    dispatch and SP attention every layer shares (each layer resolves its
    own when None).  Returns (x, the aux loss summed over layers, (k [L,
    B, S_loc, KV, hd], v) | None)."""
    require_ported(cfg)
    remat = cfg.remat if remat is None else remat
    window = cfg.sliding_window   # uniform across stacked layers
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for p in _layer_views(stacked):
        kw = dict(causal=causal, window=window, collect_kv=collect_kv,
                  engine=engine, moe_dispatch=moe_dispatch,
                  moe_engine=moe_engine, sp_plan=sp_plan)
        if remat:
            x, a, kv = checkpoint(block_sp, x, p, cfg, ctx,
                                  use_reentrant=False, **kw)
        else:
            x, a, kv = block_sp(x, p, cfg, ctx, **kw)
        aux = aux + a
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
                    else None)


# ---------------------------------------------------------------------------
# Decode-flow blocks
# ---------------------------------------------------------------------------


def _ln_loc(scale: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """Replicated [D] norm scale -> this data-rank's [D_loc] slice."""
    d_loc = scale.shape[0] // ctx.dp
    r = ctx.axis_index("data")
    return scale[r * d_loc:(r + 1) * d_loc]


def _mlp_decode(h2: torch.Tensor, p: dict, cfg: ModelConfig,
                ctx: MeshCtx) -> torch.Tensor:
    if cfg.family == "moe":
        return moe.moe_block_decode(h2, p, cfg, ctx)
    return layers.mlp_block_decode(h2, p, cfg, ctx)


def block_decode(x: torch.Tensor, p: dict, state: dict, pos: int,
                 cfg: ModelConfig, ctx: MeshCtx, *,
                 window: int) -> tuple[torch.Tensor, dict]:
    """One-token decode block against the CONTIGUOUS cache.  ``state``
    holds this layer's ("k", "v") slabs (written in place).  Returns (x,
    new_state)."""
    require_ported(cfg)
    h = layers.rms_norm_sharded(x, _ln_loc(p["ln1"], ctx), cfg.norm_eps,
                                "data", ctx)
    att, (k_c, v_c) = attention.attention_decode(
        h, (state["k"], state["v"]), pos, p, cfg, ctx, window=window)
    x = x + att
    h2 = layers.rms_norm_sharded(x, _ln_loc(p["ln2"], ctx), cfg.norm_eps,
                                 "data", ctx)
    y = _mlp_decode(h2, p, cfg, ctx)
    return x + y, {"k": k_c, "v": v_c}


def stack_decode(x: torch.Tensor, stacked: dict, cache: dict, pos: int,
                 cfg: ModelConfig, ctx: MeshCtx) -> tuple[torch.Tensor, Any]:
    """Contiguous-cache decode over layers: ``stacked`` and ``cache``
    leaves carry a leading [L]; each layer works on views, so the cache is
    updated in place and returned as is."""
    require_ported(cfg)
    window = cfg.sliding_window   # uniform across stacked layers
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in stacked.items()}
        state = {k: v[i] for k, v in cache.items()}
        x, _ = block_decode(x, p, state, pos, cfg, ctx, window=window)
    return x, cache


def block_decode_paged(x: torch.Tensor, p: dict, state: dict,
                       table: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, cfg: ModelConfig,
                       ctx: MeshCtx, *, window: int,
                       engine: str = "auto") -> tuple[torch.Tensor, dict]:
    """One-token decode block against the PAGED cache.  ``state`` holds
    this layer's ("kp", "vp") page pools (written in place);
    ``pos``/``active`` are per-slot [B].  Returns (x, new_state)."""
    require_ported(cfg)
    h = layers.rms_norm_sharded(x, _ln_loc(p["ln1"], ctx), cfg.norm_eps,
                                "data", ctx)
    att, (kp, vp) = attention.attention_decode_paged(
        h, (state["kp"], state["vp"]), table, pos, active, p, cfg, ctx,
        window=window, engine=engine)
    x = x + att
    h2 = layers.rms_norm_sharded(x, _ln_loc(p["ln2"], ctx), cfg.norm_eps,
                                 "data", ctx)
    y = _mlp_decode(h2, p, cfg, ctx)
    return x + y, {"kp": kp, "vp": vp}


def stack_decode_paged(x: torch.Tensor, stacked: dict, cache: dict,
                       table: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, cfg: ModelConfig,
                       ctx: MeshCtx, *, engine: str = "auto"
                       ) -> tuple[torch.Tensor, Any]:
    """Paged-cache decode over layers: ``stacked`` and ``cache`` leaves
    carry a leading [L]; each layer works on views, so the cache is
    updated in place and returned as is."""
    require_ported(cfg)
    window = cfg.sliding_window   # uniform across stacked layers
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in stacked.items()}
        state = {k: v[i] for k, v in cache.items()}
        x, _ = block_decode_paged(x, p, state, table, pos, active, cfg,
                                  ctx, window=window, engine=engine)
    return x, cache
