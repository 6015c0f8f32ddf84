"""Model: ModelConfig -> parameter specs, init, and the paged decode step
(port of the serving half of ``repro.models.model``).

``Model`` is an ``nn.Module`` holding its parameters in the reference's
layout: weights are used as ``x @ w`` (``w_q`` is [D, Hp*hd]) and layer
weights are stacked [L, ...] exactly as ``param_specs`` says, so
``bridge.params_from_numpy`` is a plain copy of the reference's tree.
Parameters live on the model's device (``cuda`` unless the caller asks
for the CPU) and carry no gradients: this slice serves.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, transformer
from repro_torch.parallel.sharding import MeshCtx, ParamSpec

PS = ParamSpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _gated_mult(cfg: ModelConfig) -> int:
    return 2 if layers.gated(cfg.mlp) else 1


def flatten_specs(tree: dict, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> {"a/b": leaf} in sorted key order."""
    out: dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, ctx: MeshCtx | None = None, *,
                 device: str | torch.device | None = None,
                 paged_engine: str = "auto"):
        """``paged_engine="torch"`` pins the plain paged attention on any
        device (tests hold the kernel against it end to end)."""
        super().__init__()
        transformer.require_dense(cfg)
        self.cfg = cfg
        self.ctx = ctx if ctx is not None else MeshCtx()
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.paged_engine = paged_engine
        specs = self.param_specs()
        self.top = nn.ParameterDict({
            k: self._empty(s) for k, s in specs.items() if k != "layers"})
        self.layers = nn.ParameterDict({
            k: self._empty(s) for k, s in specs["layers"].items()})

    def _empty(self, spec: ParamSpec) -> nn.Parameter:
        return nn.Parameter(
            torch.empty(spec.local_shape(self.ctx),
                        dtype=DTYPES.get(spec.dtype, self.dtype),
                        device=self.device),
            requires_grad=False)

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------

    def _attn_specs(self) -> dict:
        cfg = self.cfg
        hd = cfg.head_dim
        hp = cfg.padded_heads
        kvp = attention.padded_kv_heads(cfg)
        d = cfg.d_model
        return {
            "w_q": PS((d, hp * hd), ("embed", "heads")),
            "w_kv": PS((d, 2 * kvp * hd), ("embed", "null")),
            "w_o": PS((hp * hd, d), ("heads", "embed")),
        }

    def _mlp_specs(self) -> dict:
        cfg = self.cfg
        d, ff = cfg.d_model, cfg.padded_ff
        specs = {
            "w_up": PS((d, ff), ("embed", "ff")),
            "w_down": PS((ff, d), ("ff", "embed")),
        }
        if _gated_mult(cfg) == 2:
            specs["w_gate"] = PS((d, ff), ("embed", "ff"))
        return specs

    def _layer_specs(self) -> dict:
        d = self.cfg.d_model
        return {"ln1": PS((d,), ("embed_nofsdp",)),
                "ln2": PS((d,), ("embed_nofsdp",)),
                **self._attn_specs(), **self._mlp_specs()}

    def param_specs(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        v = cfg.padded_vocab
        specs: dict[str, Any] = {
            "embed": PS((v, d), ("vocab", "embed")),
            "final_ln": PS((d,), ("embed_nofsdp",)),
        }
        if not cfg.tie_embeddings:
            specs["unembed"] = PS((d, v), ("embed", "vocab"))
        specs["layers"] = {
            k: PS((cfg.n_layers,) + s.shape, ("layers",) + s.logical)
            for k, s in self._layer_specs().items()}
        return specs

    def params(self) -> dict:
        """The parameter tree in the reference's structure."""
        tree: dict[str, Any] = dict(self.top.items())
        tree["layers"] = dict(self.layers.items())
        return tree

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights from ``generator`` (on the model's device), the
        reference's scheme: matrices ~ N(0, 1/fan_in) drawn in f32 and
        cast, norm scales zero.  The numbers differ from the reference's
        jax.random draw; tests carry the reference's weights across with
        bridge.params_from_numpy instead."""
        params = flatten_specs(self.params())
        for name, spec in flatten_specs(self.param_specs()).items():
            dst = params[name]
            non_layer = [l for l in spec.logical if l != "layers"]
            if len(non_layer) <= 1:
                dst.zero_()
                continue
            scale = 1.0 / math.sqrt(max(spec.shape[-2], 1))
            w = torch.randn(dst.shape, generator=generator,
                            dtype=torch.float32, device=dst.device)
            dst.copy_(w.mul_(scale))
            del w
        return self

    # ------------------------------------------------------------------
    # Decode (paged serving flow)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def decode_logits_paged(self, cache: dict, table: torch.Tensor,
                            token: torch.Tensor, pos: torch.Tensor,
                            active: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
        """Logits [B, V] of one decode step against the PAGED cache.
        token: [B] int32; table: [B, Pmax] int32 page ids; pos: [B] int32
        per-slot positions; active: [B] bool.  The cache is written in
        place; rows of inactive slots are garbage the engine discards."""
        cfg, ctx = self.cfg, self.ctx
        p = self.params()
        x = layers.embed_decode(token, p["embed"], cfg, ctx)
        x, cache = transformer.stack_decode_paged(
            x, p["layers"], cache, table, pos, active, cfg, ctx,
            engine=self.paged_engine)
        x = layers.rms_norm_sharded(x, transformer._ln_loc(p["final_ln"],
                                                           ctx),
                                    cfg.norm_eps, "data", ctx)
        if cfg.tie_embeddings:
            logits = managed.managed_all_reduce(
                x @ p["embed"].T, "data", ctx, mode=ctx.mdmp_mode)
        else:
            logits = layers.logits_decode(x, p["unembed"], ctx)
        return logits, cache

    def decode_step_paged(self, cache: dict, table: torch.Tensor,
                          token: torch.Tensor, pos: torch.Tensor,
                          active: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One greedy decode step against the PAGED cache: (next_token [B]
        int32, cache).  Outputs of inactive slots are garbage the engine
        discards, and their cache state does not advance."""
        logits, cache = self.decode_logits_paged(cache, table, token, pos,
                                                 active)
        return layers.greedy_sample(logits, self.ctx), cache

    # ------------------------------------------------------------------
    # Paged-cache construction (serving runtime; serve/)
    # ------------------------------------------------------------------

    def paged_cache_specs(self, slots: int, n_pages: int, page_size: int
                          ) -> dict[str, tuple[tuple[int, ...],
                                               torch.dtype]]:
        """{"kp"|"vp": (shape, dtype)} of the paged serving cache: per-layer
        page POOLS stacked [L, n_pages + 1, page, KV, hd].  Pages
        0..n_pages-1 are the page table's; the trailing page takes the
        cache writes of inactive slots (the reference drops them with a
        drop-mode scatter, which torch lacks) and is never read.  Nothing
        scales with max_seq: completed sequences recycle their pages
        through the free list (serve/kv_cache.py)."""
        cfg, ctx = self.cfg, self.ctx
        n_sh = attention.cache_shards(ctx)
        if n_pages % n_sh:
            raise ValueError(f"{n_pages} pages over {n_sh} cache shards")
        shape = (cfg.n_layers, n_pages + 1, page_size,
                 attention.padded_kv_heads(cfg), cfg.head_dim)
        return {"kp": (shape, self.dtype), "vp": (shape, self.dtype)}
