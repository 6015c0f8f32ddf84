"""Block assembly over layers for every family (port of
``repro.models.transformer``).

SP-flow blocks (train / prefill) take and return [B, S_loc, D]; decode
blocks [B, D_loc(data)].  Layer weights are stacked on a leading
``layers`` dim as in the reference, except for the hybrid family, whose
layers are a per-layer list (their static windows differ), as the
reference unrolls them.  The reference scans over stacked layers with
``lax.scan`` (with ``jax.checkpoint`` around the block for training
remat); the port loops in Python over per-layer views either way, with
``torch.utils.checkpoint`` in place of ``jax.checkpoint``.

Families: dense and MoE decoders; ``ssm`` (a Mamba-2 mixer per layer,
models/ssm.py); ``hybrid`` (attention and the mixer in parallel on the
same normed input, ``x + 0.5 * (att + y_ssm)``); ``audio`` (whisper: a
decoder block plus a cross-attention sub-block over the encoder output);
``vlm`` (a dense decoder whose input splices projected patches,
models/model.py).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed
from repro_torch.core.overlap import fsdp_gather
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.parallel.sharding import MeshCtx


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


def per_layer(stacked: dict | list) -> list[dict]:
    """The layers' weights one dict per layer: the hybrid family's list as
    it is, stacked leaves as per-layer views."""
    if isinstance(stacked, (list, tuple)):
        return list(stacked)
    return _layer_views(stacked)


def _cache_layer(cache: dict | list, i: int) -> dict:
    """Layer i's state of a decode cache: the list's entry (hybrid), or
    views of the stacked [L, ...] leaves (written in place either way)."""
    if isinstance(cache, (list, tuple)):
        return cache[i]
    return {k: v[i] for k, v in cache.items()}


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
    """One decoder block.  Returns (x, aux_loss, (k, v) | None, (SSM
    state, conv tail) | None); the aux loss is the MoE load-balance term
    (0 for the other families), the kv and SSM state come with
    ``collect_kv`` (prefill).  ``sp_plan`` is the attention decision every
    layer shares (``cfg.attn_impl`` resolves its own when None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = sstate = None

    if cfg.family == "ssm":
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        y = ssm.mamba_mixer_sp(h, p, cfg, ctx, return_state=collect_kv)
        if collect_kv:
            y, sstate = y
        return x + y, aux, kv, sstate

    if sp_plan is not None:
        attn_fn = functools.partial(attention.attention_sp_auto,
                                    plan=sp_plan)
    else:
        attn_fn = ATTN_IMPLS.get(cfg.attn_impl, attention.attention_sp)
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    att = attn_fn(h, p, cfg, ctx, causal=causal, window=window,
                  return_kv=collect_kv, engine=engine)
    if collect_kv:
        att, kv = att
    if cfg.family == "hybrid":
        y_ssm = ssm.mamba_mixer_sp(h, p["ssm"], cfg, ctx,
                                   return_state=collect_kv)
        if collect_kv:
            y_ssm, sstate = y_ssm
        x = x + 0.5 * (att + y_ssm)
    else:
        x = x + att

    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe.moe_block(h2, p, cfg, ctx, dispatch=moe_dispatch,
                               engine=moe_engine)
    else:
        y = layers.mlp_block_sp(h2, p, cfg, ctx)
    return x + y, aux, kv, sstate


def cross_block_sp(x: torch.Tensor, p: dict, enc_out: torch.Tensor,
                   cfg: ModelConfig, ctx: MeshCtx, *,
                   engine: str = "auto") -> torch.Tensor:
    """Whisper decoder cross-attention sub-block.  enc_out: [B, F_loc, D]
    (frame-sharded over 'model'); non-causal attention of the gathered
    decoder positions over the gathered frames (the flash kernel on a
    card, Sq != Skv)."""
    b = x.shape[0]
    h = layers.rms_norm(x, p["ln_x"], cfg.norm_eps)
    h_loc = cfg.padded_heads // ctx.tp
    kvh = attention.padded_kv_heads(cfg)
    hd = cfg.head_dim
    mode = ctx.mdmp_mode

    wq = fsdp_gather(p["w_q_x"], "data", ctx, mode=mode)
    wkv = fsdp_gather(p["w_kv_x"], "data", ctx, mode=mode)
    wo = fsdp_gather(p["w_o_x"], "data", ctx, axis=1, mode=mode)

    q2 = managed.all_gather_matmul(layers.to_ring(h), wq, "model", ctx,
                                   mode=mode)
    kv2 = managed.all_gather_matmul(layers.to_ring(enc_out), wkv, "model",
                                    ctx, mode=mode)
    s_full = q2.shape[0] // b
    f_full = kv2.shape[0] // b
    q = layers.from_ring(q2, b).reshape(b, s_full, h_loc, hd)
    k, v = layers.from_ring(kv2, b).chunk(2, dim=-1)
    k = k.reshape(b, f_full, kvh, hd)
    v = v.reshape(b, f_full, kvh, hd)
    k, v, _ = attention._local_kv_slice(k, v, cfg, ctx)
    o = attention.attend(q, k, v, causal=False, engine=engine)
    y2 = managed.matmul_reduce_scatter(
        layers.to_ring(o.reshape(b, s_full, h_loc * hd)), wo, "model", ctx,
        mode=mode)
    return x + layers.from_ring(y2.to(x.dtype), b)


def _block_with_cross(x, p, cfg, ctx, enc_out, **kw):
    """block_sp, then (whisper's decoder) the cross-attention sub-block."""
    x, aux, kv, st = block_sp(x, p, cfg, ctx, **kw)
    if enc_out is not None:
        x = cross_block_sp(x, p, enc_out, cfg, ctx, engine=kw["engine"])
    return x, aux, kv, st


def stack_sp(x: torch.Tensor, stacked: dict | list, cfg: ModelConfig,
             ctx: MeshCtx, *, causal: bool = True, collect_kv: bool = False,
             enc_out: torch.Tensor | None = None,
             remat: bool | None = None, engine: str = "auto",
             moe_dispatch: moe.Dispatch | None = None,
             moe_engine: str = "auto",
             sp_plan: attention.SPPlan | None = None) -> tuple:
    """Run the block over the layers (stacked leaves, or the hybrid
    family's per-layer list, whose windows come from ``layer_window``).
    With ``remat`` (default ``cfg.remat``) each block runs under a
    non-reentrant ``torch.utils.checkpoint``: only its input is saved and
    the backward recomputes it.  ``enc_out`` adds whisper's
    cross-attention after each block.  ``moe_dispatch`` / ``sp_plan`` are
    the resolved MoE dispatch and SP attention every layer shares.
    Returns (x, the aux loss summed over layers, (k [L, B, S_loc, KV, hd],
    v) | None, (SSM state [L, B, H_loc, P, N], conv tail [L, B, K-1, C]) |
    None); the last two with ``collect_kv``, for the families that have
    them."""
    remat = cfg.remat if remat is None else remat
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs, states = [], []
    for i, p in enumerate(per_layer(stacked)):
        kw = dict(causal=causal, window=layer_window(cfg, i),
                  collect_kv=collect_kv, engine=engine,
                  moe_dispatch=moe_dispatch, moe_engine=moe_engine,
                  sp_plan=sp_plan)
        if remat:
            x, a, kv, st = checkpoint(_block_with_cross, x, p, cfg, ctx,
                                      enc_out, use_reentrant=False, **kw)
        else:
            x, a, kv, st = _block_with_cross(x, p, cfg, ctx, enc_out, **kw)
        aux = aux + a
        if kv is not None:
            kvs.append(kv)
        if st is not None:
            states.append(st)

    def stacked_pairs(pairs):
        if not pairs:
            return None
        return (torch.stack([a for a, _ in pairs]),
                torch.stack([b for _, b in pairs]))
    return x, aux, stacked_pairs(kvs), stacked_pairs(states)


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


_SSM_KEYS = ("ssm_h", "ssm_conv_x", "ssm_conv_bc")


def _ssm_decode(x: torch.Tensor, p: dict, state: dict, cfg: ModelConfig,
                ctx: MeshCtx) -> tuple[torch.Tensor, dict]:
    """The mixer's decode step from ``state``'s SSM leaves: (y, the new
    {"ssm_h", "ssm_conv_x", "ssm_conv_bc"})."""
    cs = torch.cat([state["ssm_conv_x"], state["ssm_conv_bc"]], dim=-1)
    y, (hs, cs2) = ssm.mamba_mixer_decode(x, (state["ssm_h"], cs), p, cfg,
                                          ctx)
    di = state["ssm_conv_x"].shape[-1]
    return y, {"ssm_h": hs, "ssm_conv_x": cs2[..., :di],
               "ssm_conv_bc": cs2[..., di:]}


def _write(state: dict, new: dict) -> None:
    """Write ``new`` leaves into the cache views of ``state`` in place."""
    for k, v in new.items():
        state[k].copy_(v.to(state[k].dtype))


def block_decode(x: torch.Tensor, p: dict, state: dict,
                 pos: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx, *,
                 window: int) -> tuple[torch.Tensor, dict]:
    """One-token decode block against the CONTIGUOUS cache at ``pos`` ([]
    int32 on the device).  ``state`` holds this layer's cache views,
    written in place: ("k", "v") slabs, the SSM state and conv ring (ssm,
    hybrid), and the encoder's ("xk", "xv") (audio, read only).  Returns
    (x, state)."""
    h = layers.rms_norm_sharded(x, _ln_loc(p["ln1"], ctx), cfg.norm_eps,
                                "data", ctx)
    if cfg.family == "ssm":
        y, new = _ssm_decode(h, p, state, cfg, ctx)
        _write(state, new)
        return x + y, state

    att, _ = attention.attention_decode(
        h, (state["k"], state["v"]), pos, p, cfg, ctx, window=window)
    if cfg.family == "hybrid":
        y_ssm, new = _ssm_decode(h, p["ssm"], state, cfg, ctx)
        _write(state, new)
        x = x + 0.5 * (att + y_ssm)
    else:
        x = x + att

    if cfg.encoder is not None:
        x = cross_block_decode(x, p, (state["xk"], state["xv"]), cfg, ctx)

    h2 = layers.rms_norm_sharded(x, _ln_loc(p["ln2"], ctx), cfg.norm_eps,
                                 "data", ctx)
    return x + _mlp_decode(h2, p, cfg, ctx), state


def cross_block_decode(x: torch.Tensor, p: dict,
                       enc_kv: tuple[torch.Tensor, torch.Tensor],
                       cfg: ModelConfig, ctx: MeshCtx) -> torch.Tensor:
    """Whisper decode cross-attention against the precomputed encoder KV
    [B, F_shard, KV, hd] (frame-sharded over the cache axes; LSE merge, no
    cache write)."""
    b = x.shape[0]
    h_ = cfg.padded_heads
    h_loc = h_ // ctx.tp
    kvh = attention.padded_kv_heads(cfg)
    hd = cfg.head_dim
    k_enc, v_enc = enc_kv
    mode = ctx.mdmp_mode

    hx = layers.rms_norm_sharded(x, _ln_loc(p["ln_x"], ctx), cfg.norm_eps,
                                 "data", ctx)
    q = managed.managed_all_reduce(hx @ p["w_q_x"], "data", ctx, mode=mode)
    q_all = attention._all_heads(q.reshape(b, h_loc, hd), ctx)
    qg = q_all.reshape(b, kvh, h_ // kvh, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_enc.float()) / math.sqrt(hd)
    axes = attention.cache_axes(ctx)
    m_glob = managed.all_reduce_max(logits.amax(dim=-1), axes, ctx)
    pr = torch.exp(logits - m_glob[..., None])
    l_g = pr.sum(dim=-1)
    o_g = torch.einsum("bkgs,bskd->bkgd", pr.to(v_enc.dtype).float(),
                       v_enc.float())
    for ax in axes:
        l_g = managed.managed_all_reduce(l_g, ax, ctx)
        o_g = managed.managed_all_reduce(o_g, ax, ctx)
    o = (o_g / torch.clamp(l_g[..., None], min=1e-30)).reshape(b, h_, hd)
    r_m = ctx.axis_index("model")
    o_my = o.to(x.dtype)[:, r_m * h_loc:(r_m + 1) * h_loc]
    y = managed.managed_all_reduce(o_my.reshape(b, h_loc * hd) @ p["w_o_x"],
                                   "model", ctx, mode=mode)
    return x + y.to(x.dtype)


def stack_decode(x: torch.Tensor, stacked: dict | list, cache: dict | list,
                 pos: torch.Tensor, cfg: ModelConfig, ctx: MeshCtx
                 ) -> tuple[torch.Tensor, Any]:
    """Contiguous-cache decode over layers at ``pos`` ([] int32 on the
    device): each layer works on views of its cache (stacked [L, ...]
    leaves, or the hybrid family's per-layer list), so the cache is
    updated in place and returned as is."""
    for i, p in enumerate(per_layer(stacked)):
        x, _ = block_decode(x, p, _cache_layer(cache, i), pos, cfg, ctx,
                            window=layer_window(cfg, i))
    return x, cache


def _mask_state(new: dict, old: dict, active: torch.Tensor) -> dict:
    """Keep ``old`` state leaves for inactive slots (leading dim = B)."""
    def sel(n, o):
        act = active.reshape((-1,) + (1,) * (n.dim() - 1))
        return torch.where(act, n.to(o.dtype), o)
    return {k: sel(new[k], old[k]) for k in new}


def _ssm_state_paged(state: dict, pos: torch.Tensor,
                     active: torch.Tensor) -> dict:
    """Slot-reuse hygiene: a slot stepping at pos 0 starts a NEW request,
    so its carried SSM state (from the slot's previous occupant) is
    replaced with the zero init.  KV pages need no reset — attention masks
    every position beyond the slot's length."""
    fresh = active & (pos == 0)

    def z(leaf):
        f = fresh.reshape((-1,) + (1,) * (leaf.dim() - 1))
        return torch.where(f, torch.zeros_like(leaf), leaf)
    return {k: z(state[k]) for k in _SSM_KEYS}


def _ssm_decode_paged(h: torch.Tensor, p: dict, state: dict,
                      pos: torch.Tensor, active: torch.Tensor,
                      cfg: ModelConfig, ctx: MeshCtx) -> torch.Tensor:
    """The mixer's decode step on slot-indexed SSM state: reused slots
    start from zeros, inactive slots keep their state (written in
    place)."""
    ssm_in = _ssm_state_paged(state, pos, active)
    y, new = _ssm_decode(h, p, ssm_in, cfg, ctx)
    _write(state, _mask_state(new, {k: state[k] for k in _SSM_KEYS},
                              active))
    return y


def block_decode_paged(x: torch.Tensor, p: dict, state: dict,
                       table: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, cfg: ModelConfig,
                       ctx: MeshCtx, *, window: int,
                       engine: str = "auto") -> tuple[torch.Tensor, dict]:
    """One-token decode block against the PAGED cache.  ``state`` holds
    this layer's ("kp", "vp") page pools and slot-indexed SSM state
    (written in place); ``pos``/``active`` are per-slot [B].  Returns (x,
    state)."""
    h = layers.rms_norm_sharded(x, _ln_loc(p["ln1"], ctx), cfg.norm_eps,
                                "data", ctx)
    if cfg.family == "ssm":
        return x + _ssm_decode_paged(h, p, state, pos, active, cfg,
                                     ctx), state

    att, _ = attention.attention_decode_paged(
        h, (state["kp"], state["vp"]), table, pos, active, p, cfg, ctx,
        window=window, engine=engine)
    if cfg.family == "hybrid":
        y_ssm = _ssm_decode_paged(h, p["ssm"], state, pos, active, cfg, ctx)
        x = x + 0.5 * (att + y_ssm)
    else:
        x = x + att
    h2 = layers.rms_norm_sharded(x, _ln_loc(p["ln2"], ctx), cfg.norm_eps,
                                 "data", ctx)
    return x + _mlp_decode(h2, p, cfg, ctx), state


def stack_decode_paged(x: torch.Tensor, stacked: dict | list, cache: dict,
                       table: torch.Tensor, pos: torch.Tensor,
                       active: torch.Tensor, cfg: ModelConfig,
                       ctx: MeshCtx, *, engine: str = "auto"
                       ) -> tuple[torch.Tensor, Any]:
    """Paged-cache decode over layers: ``cache`` leaves carry a leading
    [L] (every family, the hybrid one included: its pools and states have
    one shape in every layer); each layer works on views, so the cache is
    updated in place and returned as is."""
    for i, p in enumerate(per_layer(stacked)):
        x, _ = block_decode_paged(x, p, _cache_layer(cache, i), table, pos,
                                  active, cfg, ctx,
                                  window=layer_window(cfg, i),
                                  engine=engine)
    return x, cache
