"""Model: ModelConfig -> parameter specs, init, and the entry points (port
of ``repro.models.model``, dense and MoE families):

  * ``loss_sp(batch)``                    training loss (SP flow)
  * ``prefill_sp(batch)``                 prefill -> (last-token logits,
                                          cache)
  * ``decode_step(cache, token, pos)``    one-token decode, contiguous
                                          cache
  * ``decode_step_paged(...)``            one-token decode, paged cache

``Model`` is an ``nn.Module`` holding its parameters in the reference's
layout: weights are used as ``x @ w`` (``w_q`` is [D, Hp*hd]) and layer
weights are stacked [L, ...] exactly as ``param_specs`` says, so
``bridge.params_from_numpy`` is a plain copy of the reference's tree.
The entry points read the module's own parameters (the reference passes
the tree in).  Parameters live on the model's device (``cuda`` unless the
caller asks for the CPU) and require gradients for training; serving
runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import managed
from repro_torch.core.overlap import fsdp_gather
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, moe, transformer
from repro_torch.parallel.sharding import MeshCtx, ParamSpec, pad_to_multiple

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


def unflatten_specs(flat: dict[str, Any]) -> dict:
    """{"a/b": leaf} -> nested dict (the inverse of ``flatten_specs``)."""
    out: dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, ctx: MeshCtx | None = None, *,
                 device: str | torch.device | None = None,
                 paged_engine: str = "auto", attn_engine: str = "auto",
                 moe_engine: str = "auto"):
        """``paged_engine="torch"`` / ``attn_engine="torch"`` /
        ``moe_engine="torch"`` pin the plain paged attention / flash
        attention / grouped-expert FFN on any device (tests hold the
        kernels against them end to end)."""
        super().__init__()
        transformer.require_ported(cfg)
        self.cfg = cfg
        self.ctx = ctx if ctx is not None else MeshCtx()
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.paged_engine = paged_engine
        self.attn_engine = attn_engine
        self.moe_engine = moe_engine
        #: resolved MoE dispatch per (token count, managed mode and
        #: machine model, plan)
        self._moe_dispatch: dict[tuple, moe.Dispatch] = {}
        #: resolved SP attention per (attn_impl, B, S_loc, managed mode
        #: and machine model, plan)
        self._sp_plan: dict[tuple, attention.SPPlan] = {}
        specs = self.param_specs()
        self.top = nn.ParameterDict({
            k: self._empty(s) for k, s in specs.items() if k != "layers"})
        self.layers = nn.ParameterDict({
            k: self._empty(s) for k, s in specs["layers"].items()})

    def _empty(self, spec: ParamSpec) -> nn.Parameter:
        return nn.Parameter(
            torch.empty(spec.local_shape(self.ctx),
                        dtype=DTYPES.get(spec.dtype, self.dtype),
                        device=self.device))

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

    def _moe_specs(self) -> dict:
        cfg = self.cfg
        e = cfg.moe
        d, f = cfg.d_model, e.d_ff_expert
        ep = moe.moe_layout(cfg, self.ctx) == "ep_a2a"
        e_ax = "experts" if ep else "null"
        f_ax = "expert_ff" if ep else "ff"
        specs = {
            "w_router": PS((d, e.n_experts), ("embed_nofsdp", "null")),
            "w1": PS((e.n_experts, d, f), (e_ax, "embed", f_ax)),
            "w2": PS((e.n_experts, f, d), (e_ax, f_ax, "embed")),
        }
        if _gated_mult(cfg) == 2:
            specs["w1_gate"] = PS((e.n_experts, d, f),
                                  (e_ax, "embed", f_ax))
        return specs

    def _layer_specs(self) -> dict:
        d = self.cfg.d_model
        ffn = (self._moe_specs() if self.cfg.family == "moe"
               else self._mlp_specs())
        return {"ln1": PS((d,), ("embed_nofsdp",)),
                "ln2": PS((d,), ("embed_nofsdp",)),
                **self._attn_specs(), **ffn}

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
        cast, norm scales zero.  A stacked [L, ...] leaf is drawn one layer
        at a time, so the f32 temporary is one layer's (a whole stacked
        expert weight of moonshot-v1-16b-a3b would be 35 GB in f32).  The
        numbers differ from the reference's jax.random draw; tests carry
        the reference's weights across with bridge.params_from_numpy
        instead."""
        params = flatten_specs(self.params())
        for name, spec in flatten_specs(self.param_specs()).items():
            dst = params[name]
            non_layer = [l for l in spec.logical if l != "layers"]
            if len(non_layer) <= 1:
                dst.zero_()
                continue
            scale = 1.0 / math.sqrt(max(spec.shape[-2], 1))
            parts = dst.unbind(0) if spec.logical[0] == "layers" else [dst]
            for part in parts:
                w = torch.randn(part.shape, generator=generator,
                                dtype=torch.float32, device=dst.device)
                part.copy_(w.mul_(scale))
                del w
        return self

    # ------------------------------------------------------------------
    # Forward (SP flow)
    # ------------------------------------------------------------------

    def _assemble_input_sp(self, batch: dict) -> torch.Tensor:
        """Embed tokens [B, S] -> x [B, S_loc, D]."""
        return layers.embed_sp(batch["tokens"], self.top["embed"], self.cfg,
                               self.ctx)

    def _unembed(self) -> torch.Tensor:
        """[D, V]: the transposed embedding when tied."""
        if self.cfg.tie_embeddings:
            return self.top["embed"].T
        return self.top["unembed"]

    def _stack_kw(self, x: torch.Tensor) -> dict:
        """stack_sp's engine pins and the decisions of this shape: the SP
        attention of ``attn_impl`` "ring" and "auto" (the ring's mode and
        the auto schedule) and, for the MoE family, the dispatch.  Each is
        resolved (and logged) once per shape, managed mode, machine model
        and plan, as the reference logs it once per traced call site; the
        port runs eagerly and would otherwise log it per layer per
        step."""
        kw = dict(engine=self.attn_engine, moe_engine=self.moe_engine)
        mdmp = managed.get_config()
        plan_id = id(managed.active_plan())
        if self.cfg.attn_impl in ("ring", "auto"):
            b, s_loc = x.shape[:2]
            key = (self.cfg.attn_impl, b, s_loc, mdmp.mode, mdmp.hw,
                   plan_id)
            if key not in self._sp_plan:
                self._sp_plan[key] = attention.resolve_sp_plan(
                    self.cfg, self.ctx, b, s_loc)
            kw["sp_plan"] = self._sp_plan[key]
        if self.cfg.family == "moe":
            tokens = x.shape[0] * x.shape[1]
            key = (tokens, mdmp.mode, mdmp.hw, plan_id)
            if key not in self._moe_dispatch:
                self._moe_dispatch[key] = moe.resolve_dispatch(
                    self.cfg, self.ctx, tokens,
                    moe.moe_layout(self.cfg, self.ctx))
            kw["moe_dispatch"] = self._moe_dispatch[key]
        return kw

    def loss_sp(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Training loss.  batch: this rank's rows, tokens [B_loc, S] and
        labels [B_loc, S] (labels < 0 are ignored; ``ctx.shard_batch``
        cuts them from the global batch).  Returns (loss, metrics) — the
        loss summed over the mesh, the same on every rank; the MoE family
        adds ``0.01 * aux / n_layers`` of its load-balance loss."""
        cfg, ctx = self.cfg, self.ctx
        x = self._assemble_input_sp(batch)
        x, aux, _ = transformer.stack_sp(x, dict(self.layers.items()), cfg,
                                         ctx, causal=True,
                                         **self._stack_kw(x))
        x = layers.rms_norm(x, self.top["final_ln"], cfg.norm_eps)
        loss_sum, count = layers.lm_loss_sp(x, self._unembed(),
                                            batch["labels"], cfg, ctx)
        for ax in ctx.all_axes:
            loss_sum = managed.managed_all_reduce(loss_sum, ax, ctx)
            count = managed.managed_all_reduce(count, ax, ctx)
        loss = loss_sum / torch.clamp(count, min=1.0)
        if cfg.moe is not None:
            # aux is a local-token mean: averaged across ranks
            n_dev = 1
            for ax in ctx.all_axes:
                aux = managed.managed_all_reduce(aux, ax, ctx)
                n_dev *= ctx.axis_sizes[ax]
            loss = loss + 0.01 * (aux / n_dev) / cfg.n_layers
        return loss, {"loss": loss, "tokens": count}

    # ------------------------------------------------------------------
    # Prefill (SP flow, collects the cache in prefill layout)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def prefill_sp(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Prefill of this rank's batch rows: (logits of the LAST position
        [B_loc, V_loc(model)] f32, cache in prefill layout {"kv": (k, v)
        each [L, B_loc, S_loc, KV, hd]})."""
        cfg, ctx = self.cfg, self.ctx
        x = self._assemble_input_sp(batch)
        x, _, kvs = transformer.stack_sp(
            x, dict(self.layers.items()), cfg, ctx, causal=True,
            collect_kv=True, remat=False, **self._stack_kw(x))
        x = layers.rms_norm(x, self.top["final_ln"], cfg.norm_eps)
        # the final position lives on the last model rank's shard: the
        # masked all-reduce broadcasts it to every rank
        is_last = float(ctx.axis_index("model") == ctx.tp - 1)
        last = managed.managed_all_reduce(x[:, -1, :].float() * is_last,
                                          "model", ctx)
        wg = fsdp_gather(self._unembed(), "data", ctx, axis=0,
                         mode=ctx.mdmp_mode)
        logits = last @ wg.float()
        return logits, {"kv": kvs}

    # ------------------------------------------------------------------
    # Decode (contiguous cache and paged serving flow)
    # ------------------------------------------------------------------

    def _logits_decode(self, x: torch.Tensor) -> torch.Tensor:
        cfg, ctx = self.cfg, self.ctx
        x = layers.rms_norm_sharded(
            x, transformer._ln_loc(self.top["final_ln"], ctx), cfg.norm_eps,
            "data", ctx)
        if cfg.tie_embeddings:
            return managed.managed_all_reduce(
                x @ self.top["embed"].T, "data", ctx, mode=ctx.mdmp_mode)
        return layers.logits_decode(x, self.top["unembed"], ctx)

    @torch.no_grad()
    def decode_step(self, cache: dict, token: torch.Tensor, pos: int
                    ) -> tuple[torch.Tensor, dict]:
        """One greedy decode step against the CONTIGUOUS cache.  token: [B]
        int32; pos: the position written and attended.  Returns
        (next_token [B] int32, cache), the cache written in place."""
        x = layers.embed_decode(token, self.top["embed"], self.cfg,
                                self.ctx)
        x, cache = transformer.stack_decode(x, dict(self.layers.items()),
                                            cache, pos, self.cfg, self.ctx)
        return layers.greedy_sample(self._logits_decode(x), self.ctx), cache

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
        x = layers.embed_decode(token, self.top["embed"], cfg, ctx)
        x, cache = transformer.stack_decode_paged(
            x, dict(self.layers.items()), cache, table, pos, active, cfg,
            ctx, engine=self.paged_engine)
        return self._logits_decode(x), cache

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
    # Cache construction
    # ------------------------------------------------------------------

    def decode_cache_specs(self, shape: ShapeConfig
                           ) -> dict[str, tuple[tuple[int, ...],
                                                torch.dtype]]:
        """{"k"|"v": (shape, dtype)} of this rank's contiguous decode
        cache: [L, B, S_shard, KV, hd] stacked over layers, S covering the
        sequence (or the sliding window, as a ring buffer) padded to the
        cache shards and sharded over them."""
        cfg, ctx = self.cfg, self.ctx
        n_sh = attention.cache_shards(ctx)
        w = transformer.layer_window(cfg, 0)
        s_total = min(shape.seq_len, w) if w else shape.seq_len
        s_pad = pad_to_multiple(max(s_total, n_sh), n_sh)
        kv = ((cfg.n_layers, shape.global_batch, s_pad // n_sh,
               attention.padded_kv_heads(cfg), cfg.head_dim), self.dtype)
        return {"k": kv, "v": kv}

    # ------------------------------------------------------------------

    def paged_cache_specs(self, slots: int, n_pages: int, page_size: int
                          ) -> dict[str, tuple[tuple[int, ...],
                                               torch.dtype]]:
        """{"kp"|"vp": (shape, dtype)} of this rank's paged serving
        cache: per-layer page POOLS stacked [L, Np_loc + 1, page, KV, hd],
        the page dim sharded over the cache axes (cache rank r owns global
        page ids [r*Np_loc, (r+1)*Np_loc), Np_loc = n_pages / shards).
        The trailing page takes the cache writes this rank must not make
        (inactive slots, other shards' pages; the reference drops them
        with a drop-mode scatter, which torch lacks) and is never read.
        Nothing scales with max_seq: completed sequences recycle their
        pages through the free list (serve/kv_cache.py)."""
        cfg, ctx = self.cfg, self.ctx
        n_sh = attention.cache_shards(ctx)
        if n_pages % n_sh:
            raise ValueError(f"{n_pages} pages over {n_sh} cache shards")
        shape = (cfg.n_layers, n_pages // n_sh + 1, page_size,
                 attention.padded_kv_heads(cfg), cfg.head_dim)
        return {"kp": (shape, self.dtype), "vp": (shape, self.dtype)}
