"""Model: ModelConfig -> parameter specs, init, and the entry points (port
of ``repro.models.model``, every family):

  * ``loss_sp(batch)``                    training loss (SP flow)
  * ``prefill_sp(batch)``                 prefill -> (last-token logits,
                                          cache)
  * ``decode_step(cache, token, pos)``    one-token decode, contiguous
                                          cache (``pos`` a 0-d device
                                          tensor)
  * ``decode_step_paged(...)``            one-token decode, paged cache

``Model`` is an ``nn.Module`` holding its parameters in the reference's
layout: weights are used as ``x @ w`` (``w_q`` is [D, Hp*hd]) and layer
weights are stacked [L, ...] (a per-layer list for the hybrid family)
exactly as ``param_specs`` says, so ``bridge.params_from_numpy`` is a
plain copy of the reference's tree.
The entry points read the module's own parameters (the reference passes
the tree in).  Parameters live on the model's device (``cuda`` unless the
caller asks for the CPU) and require gradients for training; serving
runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
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


#: the SSM per-head scalars' fixed initial values (the reference's fix_ssm)
SSM_INIT = {"a_log": 0.5, "dt_bias": 0.1, "d_skip": 1.0}


def _gated_mult(cfg: ModelConfig) -> int:
    return 2 if layers.gated(cfg.mlp) else 1


def flatten_specs(tree: dict | list, prefix: str = "") -> dict[str, Any]:
    """Nested dicts (sorted keys) and lists (in order) -> {"a/0/b": leaf}:
    jax's tree order."""
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else ((k, tree[k]) for k in sorted(tree)))
    out: dict[str, Any] = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _lists(node: Any) -> Any:
    """Nodes keyed 0..n-1 back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def unflatten_specs(flat: dict[str, Any]) -> dict:
    """{"a/0/b": leaf} -> nested dicts and lists (the inverse of
    ``flatten_specs``)."""
    out: dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _lists(out)


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
        #: every parameter under its flattened name ("layers/w_q",
        #: "encoder/layers/ln1", "layers/0/ssm/w_z" for the hybrid list)
        self.flat = nn.ParameterDict({
            k: self._empty(s)
            for k, s in flatten_specs(self.param_specs()).items()})

    def _empty(self, spec: ParamSpec) -> nn.Parameter:
        return nn.Parameter(
            torch.empty(spec.local_shape(self.ctx),
                        dtype=DTYPES.get(spec.dtype, self.dtype),
                        device=self.device))

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------

    def _attn_specs(self, cross: bool = False) -> dict:
        cfg = self.cfg
        hd = cfg.head_dim
        hp = cfg.padded_heads
        kvp = attention.padded_kv_heads(cfg)
        sfx = "_x" if cross else ""
        d = cfg.d_model
        return {
            f"w_q{sfx}": PS((d, hp * hd), ("embed", "heads")),
            f"w_kv{sfx}": PS((d, 2 * kvp * hd), ("embed", "null")),
            f"w_o{sfx}": PS((hp * hd, d), ("heads", "embed")),
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

    def _ssm_specs(self) -> dict:
        cfg = self.cfg
        s = cfg.ssm
        d = cfg.d_model
        h = cfg.ssm_heads
        di = h * s.headdim
        n = s.d_state
        return {
            "w_z": PS((d, di), ("embed", "inner")),
            "w_x": PS((d, di), ("embed", "inner")),
            "w_bc": PS((d, 2 * n), ("embed", "null")),
            "w_dt": PS((d, h), ("embed", "ssm_heads")),
            "conv_x": PS((s.d_conv, di), ("conv", "inner")),
            "conv_bc": PS((s.d_conv, 2 * n), ("conv", "null")),
            "a_log": PS((h,), ("ssm_heads",)),
            "dt_bias": PS((h,), ("ssm_heads",)),
            "d_skip": PS((h,), ("ssm_heads",)),
            "norm_w": PS((di,), ("inner",)),
            "w_out": PS((di, d), ("inner", "embed")),
        }

    def _layer_specs(self) -> dict:
        cfg = self.cfg
        ln = lambda: PS((cfg.d_model,), ("embed_nofsdp",))  # noqa: E731
        if cfg.family == "ssm":
            return {"ln1": ln(), **self._ssm_specs()}
        specs = {"ln1": ln(), "ln2": ln(), **self._attn_specs()}
        specs.update(self._moe_specs() if cfg.family == "moe"
                     else self._mlp_specs())
        if cfg.family == "hybrid":
            specs["ssm"] = self._ssm_specs()
        if cfg.encoder is not None:
            specs["ln_x"] = ln()
            specs.update(self._attn_specs(cross=True))
        return specs

    @staticmethod
    def _stacked(layer: dict, n: int) -> dict:
        return {k: PS((n,) + s.shape, ("layers",) + s.logical)
                for k, s in layer.items()}

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
        layer = self._layer_specs()
        if self.scan_layers:
            specs["layers"] = self._stacked(layer, cfg.n_layers)
        else:
            specs["layers"] = [dict(layer) for _ in range(cfg.n_layers)]
        if cfg.encoder is not None:
            enc_layer = {"ln1": PS((d,), ("embed_nofsdp",)),
                         "ln2": PS((d,), ("embed_nofsdp",)),
                         **self._attn_specs(), **self._mlp_specs()}
            specs["encoder"] = {
                "layers": self._stacked(enc_layer, cfg.encoder.n_layers),
                "final_ln": PS((d,), ("embed_nofsdp",)),
            }
        if cfg.vision is not None:
            specs["vision_adapter"] = PS((d, d), ("embed_nofsdp", "null"))
        return specs

    @property
    def scan_layers(self) -> bool:
        """Layers stacked [L, ...] (all but the hybrid family, whose
        per-layer windows the reference unrolls over a list)."""
        return self.cfg.family != "hybrid"

    def params(self) -> dict:
        """The parameter tree in the reference's structure."""
        return unflatten_specs(dict(self.flat.items()))

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
        # the SSM scalars' fixed inits (A in [1, e], dt_bias ~
        # softplus-inv), as the reference's fix_ssm
        for name, value in flatten_specs(self.params()).items():
            leaf = name.rsplit("/", 1)[-1]
            if leaf in SSM_INIT:
                value.fill_(SSM_INIT[leaf])
        return self

    # ------------------------------------------------------------------
    # Forward (SP flow)
    # ------------------------------------------------------------------

    def _assemble_input_sp(self, tree: dict, batch: dict) -> torch.Tensor:
        """Embed tokens [B, S] -> x [B, S_loc, D], splicing the projected
        patch embeddings [B, P, D] (``batch["patches"]``, vision models)
        into positions [0, P)."""
        cfg, ctx = self.cfg, self.ctx
        x = layers.embed_sp(batch["tokens"], tree["embed"], cfg, ctx)
        if cfg.vision is not None and "patches" in batch:
            patches = batch["patches"]
            b, s_loc, d = x.shape
            s = batch["tokens"].shape[1]
            n_p = patches.shape[1]
            # the reference's f32 patches against the adapter: a promoted
            # product, cast to the residual's type
            proj = (patches.float() @ tree["vision_adapter"].float()
                    ).to(x.dtype)
            patch_full = F.pad(proj, (0, 0, 0, s - n_p))
            r = ctx.axis_index("model")
            mine = patch_full[:, r * s_loc:(r + 1) * s_loc]
            pos = r * s_loc + torch.arange(s_loc, device=x.device)
            x = torch.where((pos < n_p)[None, :, None], mine, x)
        return x

    def _encoder_sp(self, tree: dict, frames: torch.Tensor) -> torch.Tensor:
        """Whisper encoder on stub frame embeddings [B, F, D] -> enc_out
        [B, F_loc, D]: sinusoidal positions, the frames padded to a TP
        multiple and sharded over 'model', non-causal blocks.  The frames
        are cast to the model's type (the reference promotes its f32
        stubs through a bf16 encoder; in f32 the two are one)."""
        cfg, ctx = self.cfg, self.ctx
        b, f, d = frames.shape
        pos = torch.arange(f, device=frames.device)
        x = (frames + _sinusoidal(pos, d)[None].to(frames.dtype)
             ).to(self.dtype)
        f_pad = pad_to_multiple(f, ctx.tp)
        if f_pad != f:
            x = F.pad(x, (0, 0, 0, f_pad - f))
        r = ctx.axis_index("model")
        f_loc = f_pad // ctx.tp
        x = x[:, r * f_loc:(r + 1) * f_loc]
        enc = tree["encoder"]
        x, _, _, _ = transformer.stack_sp(x, enc["layers"], cfg, ctx,
                                          causal=False,
                                          engine=self.attn_engine)
        return layers.rms_norm(x, enc["final_ln"], cfg.norm_eps)

    def _unembed(self, tree: dict) -> torch.Tensor:
        """[D, V]: the transposed embedding when tied."""
        if self.cfg.tie_embeddings:
            return tree["embed"].T
        return tree["unembed"]

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
        if self.cfg.attn_impl in ("ring", "auto") and self.cfg.n_heads:
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

    def _forward_sp(self, tree: dict, batch: dict, *, collect_kv: bool,
                    remat: bool | None = None) -> tuple:
        """Embedding (and encoder) -> blocks -> final norm: (x, aux, kv,
        SSM states, enc_out)."""
        cfg = self.cfg
        x = self._assemble_input_sp(tree, batch)
        enc_out = (self._encoder_sp(tree, batch["frames"])
                   if cfg.encoder is not None else None)
        x, aux, kvs, states = transformer.stack_sp(
            x, tree["layers"], cfg, self.ctx, causal=True,
            collect_kv=collect_kv, enc_out=enc_out, remat=remat,
            **self._stack_kw(x))
        x = layers.rms_norm(x, tree["final_ln"], cfg.norm_eps)
        return x, aux, kvs, states, enc_out

    def loss_sp(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Training loss.  batch: this rank's rows, tokens [B_loc, S] and
        labels [B_loc, S] (labels < 0 are ignored), plus the stub
        ``frames`` [B_loc, F, D] (audio) or ``patches`` [B_loc, P, D]
        (vision); ``ctx.shard_batch`` cuts them from the global batch.
        Returns (loss, metrics) — the loss summed over the mesh, the same
        on every rank; the MoE family adds ``0.01 * aux / n_layers`` of
        its load-balance loss."""
        cfg, ctx = self.cfg, self.ctx
        tree = self.params()
        x, aux, _, _, _ = self._forward_sp(tree, batch, collect_kv=False)
        loss_sum, count = layers.lm_loss_sp(x, self._unembed(tree),
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
        """Prefill of this rank's batch rows (tokens, and ``frames`` or
        ``patches`` as ``loss_sp``): (logits of the LAST position [B_loc,
        V_loc(model)] f32, cache in prefill layout {"kv": (k, v) each [L,
        B_loc, S_loc, KV, hd] | None, "ssm": (state [L, B_loc, H_loc, P,
        N] f32, conv tail [L, B_loc, K-1, C]) | None, "enc_out": [B_loc,
        F_loc, D] | None})."""
        cfg, ctx = self.cfg, self.ctx
        tree = self.params()
        x, _, kvs, states, enc_out = self._forward_sp(tree, batch,
                                                      collect_kv=True,
                                                      remat=False)
        # the final position lives on the last model rank's shard: the
        # masked all-reduce broadcasts it to every rank
        is_last = float(ctx.axis_index("model") == ctx.tp - 1)
        last = managed.managed_all_reduce(x[:, -1, :].float() * is_last,
                                          "model", ctx)
        wg = fsdp_gather(self._unembed(tree), "data", ctx, axis=0,
                         mode=ctx.mdmp_mode)
        logits = last @ wg.float()
        return logits, {"kv": kvs, "ssm": states, "enc_out": enc_out}

    @torch.no_grad()
    def encoder_kv(self, enc_out: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The decoder's cross-attention K/V of every layer from the
        encoder output (one cache shard): (xk, xv) each [L, B, F, KV, hd]
        in the model's type, the rows the contiguous cache's "xk"/"xv"
        take."""
        cfg = self.cfg
        if attention.cache_shards(self.ctx) != 1:
            raise ValueError("encoder_kv fills one cache shard")
        b, f, _ = enc_out.shape
        kvh, hd = attention.padded_kv_heads(cfg), cfg.head_dim
        ks, vs = [], []
        for p in transformer.per_layer(self.params()["layers"]):
            k, v = (enc_out @ p["w_kv_x"]).chunk(2, dim=-1)
            ks.append(k.reshape(b, f, kvh, hd))
            vs.append(v.reshape(b, f, kvh, hd))
        return torch.stack(ks).to(self.dtype), torch.stack(vs).to(self.dtype)

    # ------------------------------------------------------------------
    # Decode (contiguous cache and paged serving flow)
    # ------------------------------------------------------------------

    def _logits_decode(self, tree: dict, x: torch.Tensor) -> torch.Tensor:
        cfg, ctx = self.cfg, self.ctx
        x = layers.rms_norm_sharded(
            x, transformer._ln_loc(tree["final_ln"], ctx), cfg.norm_eps,
            "data", ctx)
        if cfg.tie_embeddings:
            return managed.managed_all_reduce(
                x @ tree["embed"].T, "data", ctx, mode=ctx.mdmp_mode)
        return layers.logits_decode(x, tree["unembed"], ctx)

    @torch.no_grad()
    def decode_step(self, cache: dict | list, token: torch.Tensor,
                    pos: torch.Tensor | int
                    ) -> tuple[torch.Tensor, dict | list]:
        """One greedy decode step against the CONTIGUOUS cache.  token: [B]
        int32; pos: the position written and attended, [] int32 on the
        model's device as the reference's (an int becomes one here, and
        only here).  Nothing below reads a device value on the host, so
        the step can be captured in a CUDA graph.  Returns (next_token
        [B] int32, cache), the cache written in place."""
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int32, device=self.device)
        tree = self.params()
        x = layers.embed_decode(token, tree["embed"], self.cfg, self.ctx)
        x, cache = transformer.stack_decode(x, tree["layers"], cache, pos,
                                            self.cfg, self.ctx)
        return (layers.greedy_sample(self._logits_decode(tree, x),
                                     self.ctx), cache)

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
        tree = self.params()
        x = layers.embed_decode(token, tree["embed"], cfg, ctx)
        x, cache = transformer.stack_decode_paged(
            x, tree["layers"], cache, table, pos, active, cfg, ctx,
            engine=self.paged_engine)
        return self._logits_decode(tree, x), cache

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

    def _ssm_entries(self, rows: int) -> dict[str, tuple]:
        """This rank's SSM state of ``rows`` batch rows or slots: the f32
        state [rows, H_loc, P, N] and the conv ring's x part [rows, K-1,
        di_loc] (heads sharded over 'model') and B|C part [rows, K-1, 2N]
        (replicated)."""
        s, tp = self.cfg.ssm, self.ctx.tp
        h_loc = self.cfg.ssm_heads // tp
        return {"ssm_h": ((rows, h_loc, s.headdim, s.d_state),
                          torch.float32),
                "ssm_conv_x": ((rows, s.d_conv - 1, h_loc * s.headdim),
                               self.dtype),
                "ssm_conv_bc": ((rows, s.d_conv - 1, 2 * s.d_state),
                                self.dtype)}

    def decode_cache_specs(self, shape: ShapeConfig
                           ) -> dict[str, tuple] | list[dict[str, tuple]]:
        """{name: (shape, dtype)} of this rank's contiguous decode cache,
        stacked [L, ...] over layers (a per-layer list for the hybrid
        family): "k"/"v" [B, S_shard, KV, hd] covering the sequence (or
        the layer's sliding window, as a ring buffer) padded to the cache
        shards and sharded over them; the SSM state and conv ring (ssm,
        hybrid); the encoder's "xk"/"xv" over the padded frames
        (audio)."""
        cfg, ctx = self.cfg, self.ctx
        n_sh = attention.cache_shards(ctx)
        b = shape.global_batch

        def kv_entry(s_total):
            s_pad = pad_to_multiple(s_total, n_sh)
            return ((b, s_pad // n_sh, attention.padded_kv_heads(cfg),
                     cfg.head_dim), self.dtype)

        def layer_entry(i):
            entry = {}
            if cfg.family != "ssm" and cfg.n_heads:
                w = transformer.layer_window(cfg, i)
                s_total = min(shape.seq_len, w) if w else shape.seq_len
                entry["k"] = entry["v"] = kv_entry(max(s_total, n_sh))
            if cfg.family in ("ssm", "hybrid"):
                entry.update(self._ssm_entries(b))
            if cfg.encoder is not None:
                entry["xk"] = entry["xv"] = kv_entry(
                    pad_to_multiple(cfg.encoder.n_frames, n_sh))
            return entry
        if not self.scan_layers:
            return [layer_entry(i) for i in range(cfg.n_layers)]
        return {k: ((cfg.n_layers,) + shp, dt)
                for k, (shp, dt) in layer_entry(0).items()}

    def paged_cache_specs(self, slots: int, n_pages: int, page_size: int
                          ) -> dict[str, tuple[tuple[int, ...],
                                               torch.dtype]]:
        """{name: (shape, dtype)} of this rank's paged serving cache,
        stacked [L, ...] over layers (every family: its pools and states
        have one shape in every layer): the page POOLS "kp"/"vp" [Np_loc +
        1, page, KV, hd], the page dim sharded over the cache axes (cache
        rank r owns global page ids [r*Np_loc, (r+1)*Np_loc), Np_loc =
        n_pages / shards), and the slot-indexed SSM state [slots, ...]
        (ssm, hybrid).  The trailing page takes the cache writes this rank
        must not make (inactive slots, other shards' pages; the reference
        drops them with a drop-mode scatter, which torch lacks) and is
        never read.  Nothing scales with max_seq: completed sequences
        recycle their pages through the free list (serve/kv_cache.py).
        Token-only decoders only, as the reference."""
        cfg, ctx = self.cfg, self.ctx
        if cfg.encoder is not None or cfg.vision is not None:
            raise ValueError("paged serving supports token-only decoders; "
                             f"{cfg.name} has an encoder or vision input")
        n_sh = attention.cache_shards(ctx)
        if n_pages % n_sh:
            raise ValueError(f"{n_pages} pages over {n_sh} cache shards")
        entry: dict[str, tuple] = {}
        if cfg.family != "ssm" and cfg.n_heads:
            pool = ((n_pages // n_sh + 1, page_size,
                     attention.padded_kv_heads(cfg), cfg.head_dim),
                    self.dtype)
            entry["kp"] = entry["vp"] = pool
        if cfg.family in ("ssm", "hybrid"):
            entry.update(self._ssm_entries(slots))
        return {k: ((cfg.n_layers,) + shp, dt)
                for k, (shp, dt) in entry.items()}


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions[:, None].float() * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
