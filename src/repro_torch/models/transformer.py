"""Block assembly over layers for the paged decode flow (port of the
serving half of ``repro.models.transformer``).

Layer weights are stacked on a leading ``layers`` dim as in the reference;
the reference scans over them with ``lax.scan``, the port loops in Python
over views of the stacked tensors.  This slice ports the dense family;
the others raise and name the ROADMAP slice that brings them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.parallel.sharding import MeshCtx

#: family -> the ROADMAP Queue 1 slice that ports its decode blocks
FAMILY_SLICE = {"moe": 7, "ssm": 8, "hybrid": 8, "audio": 8, "vlm": 8}


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family comes with ROADMAP "
            f"Queue 1 slice {FAMILY_SLICE.get(cfg.family, '?')}; this "
            "slice ports the dense family")


def layer_window(cfg: ModelConfig, i: int) -> int:
    """Static per-layer window (0 = full attention)."""
    if cfg.sliding_window and cfg.family == "hybrid":
        return 0 if i in cfg.full_attn_layers else cfg.sliding_window
    return cfg.sliding_window


def _ln_loc(scale: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """Replicated [D] norm scale -> this data-rank's [D_loc] slice (the
    whole scale at dp=1, the only data-axis size this slice runs)."""
    if ctx.dp != 1:
        raise NotImplementedError(
            "a data axis above 1 comes with ROADMAP Queue 1 slice 4")
    return scale


def block_decode_paged(x: torch.Tensor, p: dict, state: dict,
                       table: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, cfg: ModelConfig,
                       ctx: MeshCtx, *, window: int,
                       engine: str = "auto") -> tuple[torch.Tensor, dict]:
    """One-token decode block against the PAGED cache.  ``state`` holds
    this layer's ("kp", "vp") page pools (written in place);
    ``pos``/``active`` are per-slot [B].  Returns (x, new_state)."""
    require_dense(cfg)
    h = layers.rms_norm_sharded(x, _ln_loc(p["ln1"], ctx), cfg.norm_eps,
                                "data", ctx)
    att, (kp, vp) = attention.attention_decode_paged(
        h, (state["kp"], state["vp"]), table, pos, active, p, cfg, ctx,
        window=window, engine=engine)
    x = x + att
    h2 = layers.rms_norm_sharded(x, _ln_loc(p["ln2"], ctx), cfg.norm_eps,
                                 "data", ctx)
    y = layers.mlp_block_decode(h2, p, cfg, ctx)
    return x + y, {"kp": kp, "vp": vp}


def stack_decode_paged(x: torch.Tensor, stacked: dict, cache: dict,
                       table: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, cfg: ModelConfig,
                       ctx: MeshCtx, *, engine: str = "auto"
                       ) -> tuple[torch.Tensor, Any]:
    """Paged-cache decode over layers: ``stacked`` and ``cache`` leaves
    carry a leading [L]; each layer works on views, so the cache is
    updated in place and returned as is."""
    require_dense(cfg)
    window = cfg.sliding_window   # uniform across stacked layers
    for i in range(cfg.n_layers):
        p = {k: v[i] for k, v in stacked.items()}
        state = {k: v[i] for k, v in cache.items()}
        x, _ = block_decode_paged(x, p, state, table, pos, active, cfg,
                                  ctx, window=window, engine=engine)
    return x, cache
