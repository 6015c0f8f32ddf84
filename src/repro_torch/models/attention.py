"""Attention — SP flow (train / prefill), the contiguous-cache decode
flow and the paged decode flow of the serving runtime (port of
``repro.models.attention``).

SP flow (x sequence-sharded over ``model``):
  * one all-gather-matmul ring computes Q (this rank's heads) and K/V
    (replicated kv weights); each rank attends the kv heads its q heads
    use;
  * flash attention over the full sequence for the local heads — the
    CUDA kernels on a card (kernels/ops.py);
  * output projection as matmul-reduce-scatter back to sequence shards.
Two more SP schedules share the layer: Ulysses (gather the q/o weights,
switch sequence and head sharding with all-to-alls) and ring attention
(q stays sequence-sharded, kv blocks stream around ``model`` through
``managed.managed_ring_attention`` and its carry kernel, over the model
axis's process group).  ``attention_sp_auto`` picks one of the three
from the cost model.

Contiguous decode flow (batch replicated; KV cache [B, S, KV, hd] sharded
over the cache axes on the sequence dim): the oracle of the paged flow.

Paged decode flow (batch replicated; KV pool sharded over data x model
(x pod) on the page dim, rank r owning global page ids [r*Np_loc,
(r+1)*Np_loc)):
  * q/k/v via weight-stationary contractions closed over 'data';
  * the new K/V row is written into the slot's page by the rank that
    owns it;
  * all q heads are gathered over 'model' (tiny); with one cache shard
    the paged kernel runs on the pool, with more each rank takes the
    plain partials of its pages (as the reference) and they LSE-merge
    over the cache axes (distributed flash-decoding);
  * o-projection row-parallel, closed over 'model'.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed
from repro_torch.core.overlap import fsdp_gather
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import ref
from repro_torch.models import layers
from repro_torch.parallel.sharding import MeshCtx


def padded_kv_heads(cfg: ModelConfig) -> int:
    """Smallest kv-head count >= n_kv_heads that divides padded_heads."""
    h = cfg.padded_heads
    kv = max(1, cfg.n_kv_heads)
    while h % kv:
        kv += 1
    return kv


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: int = 0, q_offset: int = 0,
           engine: str = "auto") -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Skv, KV, hd]; GQA via head grouping.
    ``q_offset``: global position of q[0] relative to k[0]; ``window`` > 0:
    sliding-window attention.  Flash attention (the CUDA kernels for a
    CUDA tensor) where ``ops.flash_attention_applicable``, else the dense
    reference; ``engine="torch"`` pins the plain flash engines (tests)."""
    if engine == "torch" or ops.flash_attention_applicable(q, k, v):
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, engine=engine)
    return attend_ref(q, k, v, causal=causal, window=window,
                      q_offset=q_offset)


def attend_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, window: int = 0,
               q_offset: int = 0) -> torch.Tensor:
    """Dense attention (the reference's attend_ref, which is its
    flash_attention_ref)."""
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)


def _local_kv_slice(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                    ctx: MeshCtx) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The replicated kv heads sliced to the range this rank's q heads
    use: q heads are contiguous per rank ([r*h_loc, (r+1)*h_loc)); with
    group size g = Hp / KVp the kv range is [(r*h_loc)//g, ...) of uniform
    size (KVp | tp or tp | KVp — guaranteed by padded_kv_heads and tp a
    power of two)."""
    hp = cfg.padded_heads
    kvp = padded_kv_heads(cfg)
    h_loc = hp // ctx.tp
    g = hp // kvp                       # q heads per kv head
    kv_count = max(1, h_loc // g)
    if h_loc % max(min(g, h_loc), 1):
        raise ValueError(f"{h_loc} q heads a rank with groups of {g}")
    if kv_count == kvp:
        return k, v, kvp
    lo = (ctx.axis_index("model") * h_loc) // g
    return (k[:, :, lo:lo + kv_count], v[:, :, lo:lo + kv_count], kv_count)


# ---------------------------------------------------------------------------
# SP flow (training / prefill)
# ---------------------------------------------------------------------------


def attention_sp(x: torch.Tensor, params: dict, cfg: ModelConfig,
                 ctx: MeshCtx, *, causal: bool = True, window: int = 0,
                 return_kv: bool = False, engine: str = "auto") -> Any:
    """x: [B, S_loc, D] -> [B, S_loc, D].  When ``return_kv`` (prefill),
    also returns this rank's (k, v) sequence slice for the cache.
    ``engine`` pins the flash-attention engine (tests only)."""
    b, s_loc, _ = x.shape
    h_loc = cfg.padded_heads // ctx.tp
    kvh = padded_kv_heads(cfg)
    hd = cfg.head_dim

    wq = fsdp_gather(params["w_q"], "data", ctx, mode=ctx.mdmp_mode)
    wkv = fsdp_gather(params["w_kv"], "data", ctx, mode=ctx.mdmp_mode)
    wo = fsdp_gather(params["w_o"], "data", ctx, axis=1, mode=ctx.mdmp_mode)

    x2 = layers.to_ring(x)
    q2, kv2 = managed.all_gather_matmul_multi(x2, [wq, wkv], "model", ctx,
                                              mode=ctx.mdmp_mode)
    s_full = q2.shape[0] // b
    q = layers.from_ring(q2, b).reshape(b, s_full, h_loc, hd)
    k, v = layers.from_ring(kv2, b).chunk(2, dim=-1)
    k = k.reshape(b, s_full, kvh, hd)
    v = v.reshape(b, s_full, kvh, hd)

    if not cfg.attention_free and cfg.rope_theta > 0:
        pos = torch.arange(s_full, device=x.device)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)

    k_att, v_att, _ = _local_kv_slice(k, v, cfg, ctx)
    o = attend(q, k_att, v_att, causal=causal, window=window, engine=engine)
    o2 = layers.to_ring(o.reshape(b, s_full, h_loc * hd))
    y2 = managed.matmul_reduce_scatter(o2, wo, "model", ctx,
                                       mode=ctx.mdmp_mode)
    y = layers.from_ring(y2.to(x.dtype), b)
    if return_kv:
        # this rank's own sequence slice of the (replicated) kv
        rows = slice(ctx.axis_index("model") * s_loc,
                     (ctx.axis_index("model") + 1) * s_loc)
        return y, (k[:, rows], v[:, rows])
    return y


def _full_head_qkv(x: torch.Tensor, params: dict, cfg: ModelConfig,
                   ctx: MeshCtx) -> tuple[torch.Tensor, ...]:
    """The Ulysses and ring projections: the q/o weights gathered whole
    (FSDP over 'data', columns / rows over 'model'), then q [B, S_loc, H,
    hd] with FULL heads and k, v [B, S_loc, KV, hd] of this rank's
    sequence block, roped.  Returns (q, k, v, w_o)."""
    b, s_loc, _ = x.shape
    kvh, hd = padded_kv_heads(cfg), cfg.head_dim
    mode = ctx.mdmp_mode
    wq = fsdp_gather(params["w_q"], "data", ctx, mode=mode)
    wq = fsdp_gather(wq, "model", ctx, axis=1, mode=mode)     # [D, H*hd]
    wkv = fsdp_gather(params["w_kv"], "data", ctx, mode=mode)
    wo = fsdp_gather(params["w_o"], "data", ctx, axis=1, mode=mode)
    wo = fsdp_gather(wo, "model", ctx, axis=0, mode=mode)     # [H*hd, D]
    q = (x @ wq).reshape(b, s_loc, cfg.padded_heads, hd)
    k, v = (x @ wkv).chunk(2, dim=-1)
    k = k.reshape(b, s_loc, kvh, hd)
    v = v.reshape(b, s_loc, kvh, hd)
    if cfg.rope_theta > 0:
        pos = ctx.axis_index("model") * s_loc + torch.arange(
            s_loc, device=x.device)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        k = layers.apply_rope(k, pos, cfg.rope_theta)
    return q, k, v, wo


def attention_sp_ulysses(x: torch.Tensor, params: dict, cfg: ModelConfig,
                         ctx: MeshCtx, *, causal: bool = True,
                         window: int = 0, return_kv: bool = False,
                         engine: str = "auto") -> Any:
    """Ulysses-style attention: gather the q/o WEIGHTS over 'model' (bytes
    ∝ D·H·hd) and switch seq-sharding <-> head-sharding with a managed
    all_to_all (bytes ∝ S·B·D / tp), in place of all-gathering the
    SEQUENCE for the qkv matmuls.  Numerically identical to
    attention_sp."""
    b, s_loc, _ = x.shape
    kvh, hd = padded_kv_heads(cfg), cfg.head_dim
    mode = ctx.mdmp_mode
    q, k, v, wo = _full_head_qkv(x, params, cfg, ctx)

    # head<->seq switch: [B, S_loc, H, hd] -> [B, S, H_loc, hd]
    qt = managed.managed_all_to_all(q.transpose(0, 1), "model", ctx,
                                    split_axis=2, concat_axis=0, mode=mode)
    qt = qt.transpose(0, 1)
    # kv heads are few: plain seq all-gather (tiny)
    tp = ctx.tp
    kg = layers.from_ring(managed.managed_all_gather(
        layers.to_ring(k.reshape(b, s_loc, kvh * hd)), "model", ctx,
        mode=mode), b).reshape(b, s_loc * tp, kvh, hd)
    vg = layers.from_ring(managed.managed_all_gather(
        layers.to_ring(v.reshape(b, s_loc, kvh * hd)), "model", ctx,
        mode=mode), b).reshape(b, s_loc * tp, kvh, hd)

    k_att, v_att, _ = _local_kv_slice(kg, vg, cfg, ctx)
    o = attend(qt, k_att, v_att, causal=causal, window=window, engine=engine)

    # switch back: [B, S, H_loc, hd] -> [B, S_loc, H, hd]
    ot = managed.managed_all_to_all(o.transpose(0, 1), "model", ctx,
                                    split_axis=0, concat_axis=2, mode=mode)
    ot = ot.transpose(0, 1).reshape(b, s_loc, cfg.padded_heads * hd)
    y = (ot @ wo).to(x.dtype)                            # no psum needed
    if return_kv:
        return y, (k, v)   # this rank's seq slice, all kv heads
    return y


def attention_sp_ring(x: torch.Tensor, params: dict, cfg: ModelConfig,
                      ctx: MeshCtx, *, causal: bool = True, window: int = 0,
                      return_kv: bool = False, engine: str = "auto",
                      ring_mode: str | None = None) -> Any:
    """Ring attention / context parallelism: q stays sequence-sharded with
    FULL heads, kv blocks stream around 'model' through the managed ring
    while the carry kernel folds the block that already arrived — O(S_loc)
    activation memory.  Projections mirror Ulysses, with no head<->seq
    switch and no kv slicing.  ``ring_mode`` is the ring's mode when the
    caller has already resolved it (``resolve_sp_plan``); otherwise the
    ring resolves and logs it per call.  Numerically identical to
    attention_sp."""
    b, s_loc, _ = x.shape
    q, k, v, wo = _full_head_qkv(x, params, cfg, ctx)
    o = managed.managed_ring_attention(q, k, v, "model", ctx, causal, window,
                                       ctx.mdmp_mode,
                                       group=ctx.groups.get("model"),
                                       engine=engine, decided=ring_mode)
    y = (o.reshape(b, s_loc, -1) @ wo).to(x.dtype)
    if return_kv:
        return y, (k, v)   # this rank's seq slice, all kv heads
    return y


#: schedule name (cost model / tuner / plan) -> SP attention implementation
SP_SCHEDULES = {
    "bulk": attention_sp,          # megatron AG-matmul rings
    "ulysses": attention_sp_ulysses,
    "ring": attention_sp_ring,
}


@dataclasses.dataclass(frozen=True)
class SPPlan:
    """The SP attention of one call site, resolved (and logged) once:
    the schedule and, for the ring, its mode."""
    schedule: str                  # "bulk" | "ulysses" | "ring"
    ring_mode: str | None = None   # "bulk" | "interleaved" for the ring


def resolve_sp_plan(cfg: ModelConfig, ctx: MeshCtx, batch: int,
                    s_loc: int, *, causal: bool = True,
                    impl: str | None = None) -> SPPlan:
    """The decisions attention ``impl`` (default ``cfg.attn_impl``) needs
    at [batch, s_loc]: the attention_schedule record for "auto" and the
    ring_attention record when the schedule is the ring.  The reference
    logs them once per traced call site; the eager port's ``Model``
    resolves them once per shape and passes the plan to every layer."""
    impl = cfg.attn_impl if impl is None else impl
    hd, hp = cfg.head_dim, cfg.padded_heads
    kvh = padded_kv_heads(cfg)
    itemsize = getattr(torch, cfg.dtype).itemsize
    if impl == "auto":
        schedule = managed.resolve_attention_schedule(
            "model", ctx.tp, batch, s_loc, hp, kvh, hd, cfg.d_model,
            dtype_bytes=itemsize, causal=causal,
            mode=ctx.mdmp_mode).schedule
    else:
        schedule = {"ulysses": "ulysses", "ring": "ring"}.get(impl, "bulk")
    if schedule != "ring":
        return SPPlan(schedule)
    return SPPlan(schedule, managed.resolve_ring_attention(
        "model", ctx, batch, s_loc, hp, hd, batch * s_loc * kvh * hd *
        itemsize, causal=causal, mode=ctx.mdmp_mode))


def attention_sp_auto(x: torch.Tensor, params: dict, cfg: ModelConfig,
                      ctx: MeshCtx, *, causal: bool = True, window: int = 0,
                      return_kv: bool = False, engine: str = "auto",
                      plan: SPPlan | None = None) -> Any:
    """The managed dispatcher (cfg.attn_impl='auto'): pick bulk gather vs
    ulysses a2a vs ring streaming from the cost model, log the
    DecisionRecord, and run the winner.  ``plan`` is a plan resolved
    earlier (``resolve_sp_plan``), which is then run as it stands."""
    if plan is None:
        b, s_loc, _ = x.shape
        plan = resolve_sp_plan(cfg, ctx, b, s_loc, causal=causal,
                               impl="auto")
    kw = {"ring_mode": plan.ring_mode} if plan.schedule == "ring" else {}
    return SP_SCHEDULES[plan.schedule](x, params, cfg, ctx, causal=causal,
                                       window=window, return_kv=return_kv,
                                       engine=engine, **kw)


def cache_axes(ctx: MeshCtx) -> tuple[str, ...]:
    """Mesh axes the KV-cache page (or sequence) dim is sharded over."""
    return (("pod", "data", "model") if ctx.has_pod else ("data", "model"))


def cache_shards(ctx: MeshCtx) -> int:
    n = 1
    for ax in cache_axes(ctx):
        n *= ctx.axis_sizes.get(ax, 1)
    return n


def cache_rank(ctx: MeshCtx) -> int:
    """Linear rank of this process along the cache sharding axes."""
    r = 0
    for ax in cache_axes(ctx):
        r = r * ctx.axis_sizes.get(ax, 1) + ctx.axis_index(ax)
    return r


def _decode_qkv(x: torch.Tensor, params: dict, pos: torch.Tensor,
                cfg: ModelConfig, ctx: MeshCtx) -> tuple[torch.Tensor, ...]:
    """q [B, h_loc, hd], k, v [B, KV, hd] of one decode step, roped at
    ``pos`` (one position per batch row): weight-stationary contractions
    closed over 'data'."""
    b = x.shape[0]
    h_loc = cfg.padded_heads // ctx.tp
    kvh, hd = padded_kv_heads(cfg), cfg.head_dim
    qkv = managed.managed_all_reduce(
        torch.cat([x @ params["w_q"], x @ params["w_kv"]], dim=-1),
        "data", ctx, mode=ctx.mdmp_mode)
    q, knew, vnew = qkv.split([h_loc * hd, kvh * hd, kvh * hd], dim=-1)
    q = q.reshape(b, h_loc, hd)
    knew = knew.reshape(b, kvh, hd)
    vnew = vnew.reshape(b, kvh, hd)
    if cfg.rope_theta > 0:
        q = layers.apply_rope_slots(q, pos, cfg.rope_theta)
        knew = layers.apply_rope_slots(knew, pos, cfg.rope_theta)
    return q, knew, vnew


def _all_heads(q: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """[B, h_loc, hd] -> every head [B, H, hd], gathered over 'model'."""
    q_all = managed.managed_all_gather(
        q.transpose(0, 1).contiguous(), "model", ctx, mode=ctx.mdmp_mode)
    return q_all.transpose(0, 1).contiguous()


def _o_proj(o: torch.Tensor, params: dict, cfg: ModelConfig, ctx: MeshCtx,
            dtype: torch.dtype) -> torch.Tensor:
    """This model rank's head block of o [B, H, hd] through the
    row-parallel o-projection, closed over 'model'."""
    b, hd = o.shape[0], cfg.head_dim
    h_loc = cfg.padded_heads // ctx.tp
    r_m = ctx.axis_index("model")
    o_my = o.to(dtype)[:, r_m * h_loc:(r_m + 1) * h_loc]
    y = managed.managed_all_reduce(
        o_my.reshape(b, h_loc * hd) @ params["w_o"], "model", ctx,
        mode=ctx.mdmp_mode)
    return y.to(dtype)


def _merge_over_cache(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                      ctx: MeshCtx) -> tuple[torch.Tensor, torch.Tensor]:
    """The distributed flash-decoding LSE merge of per-shard partials:
    rescale to the global max, then sum l and acc over the cache axes."""
    axes = cache_axes(ctx)
    m_glob = managed.all_reduce_max(m, axes, ctx)
    w = torch.exp(m - m_glob)
    l, acc = l * w, acc * w[..., None]
    for ax in axes:
        l = managed.managed_all_reduce(l, ax, ctx)
        acc = managed.managed_all_reduce(acc, ax, ctx)
    return l, acc


def attention_decode(x: torch.Tensor,
                     kv_cache: tuple[torch.Tensor, torch.Tensor],
                     pos: torch.Tensor, params: dict, cfg: ModelConfig,
                     ctx: MeshCtx, *, window: int = 0
                     ) -> tuple[torch.Tensor,
                                tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode attention against the CONTIGUOUS cache.

    x:        [B, D_loc(data)] (batch replicated over the mesh)
    kv_cache: (k, v) each [B, S_shard, KV, hd], sequence sharded over
              cache_axes(ctx) — for SWA layers the shards cover the
              window as a ring buffer.  Updated IN PLACE (the reference
              returns an updated copy of a donated buffer): the row at
              ``pos``'s slot takes the new K/V on the shard that owns it
              and keeps its old value elsewhere; a position past the
              cache is owned by no shard and is not written.
    pos:      [] int32 on x's device — the global position being written
              and attended.  Nothing here reads it on the host, so the
              step can be captured in a CUDA graph.
    Returns (y [B, D_loc(data)], cache)."""
    b = x.shape[0]
    h, kvh, hd = cfg.padded_heads, padded_kv_heads(cfg), cfg.head_dim
    k_cache, v_cache = kv_cache
    s_shard = k_cache.shape[1]
    n_sh = cache_shards(ctx)
    me = cache_rank(ctx)
    q, knew, vnew = _decode_qkv(x, params, pos.reshape(1).expand(b), cfg,
                                ctx)

    # the reference's owner test (ring-buffer slot for SWA)
    slot_global = pos if window <= 0 else pos % (s_shard * n_sh)
    owner = slot_global // s_shard
    slot = (slot_global % s_shard).long().reshape(1)
    is_mine = owner == me
    for cache, new in ((k_cache, knew), (v_cache, vnew)):
        old = cache.index_select(1, slot)
        cache.index_copy_(1, slot, torch.where(
            is_mine, new[:, None].to(cache.dtype), old))

    qg = _all_heads(q, ctx).reshape(b, kvh, h // kvh, hd)
    # products of the cache's type accumulated in f32 (the reference's
    # preferred_element_type=f32)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          k_cache.float()) * (1.0 / math.sqrt(hd))
    slot_ids = me * s_shard + torch.arange(s_shard, device=x.device)
    if window > 0:
        # ring buffer: slot holds position p iff p % ring == slot
        ring = s_shard * n_sh
        cand = torch.where(slot_ids <= pos % ring,
                           (pos // ring) * ring + slot_ids,
                           (pos // ring - 1) * ring + slot_ids)
        valid = (cand >= torch.clamp(pos + 1 - window, min=0)) \
            & (cand <= pos)
    else:
        valid = slot_ids <= pos
    logits = torch.where(valid, logits, -math.inf)
    m = managed.all_reduce_max(logits.amax(dim=-1), cache_axes(ctx), ctx)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    l, o = p.sum(dim=-1), torch.einsum("bkgs,bskd->bkgd",
                                       p.to(v_cache.dtype).float(),
                                       v_cache.float())
    for ax in cache_axes(ctx):
        l = managed.managed_all_reduce(l, ax, ctx)
        o = managed.managed_all_reduce(o, ax, ctx)
    o = (o / torch.clamp(l[..., None], min=1e-30)).reshape(b, h, hd)
    return _o_proj(o, params, cfg, ctx, x.dtype), (k_cache, v_cache)


def attention_decode_paged(x: torch.Tensor,
                           pool: tuple[torch.Tensor, torch.Tensor],
                           table: torch.Tensor, pos: torch.Tensor,
                           active: torch.Tensor, params: dict,
                           cfg: ModelConfig, ctx: MeshCtx, *,
                           window: int = 0, engine: str = "auto"
                           ) -> tuple[torch.Tensor,
                                      tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode attention against a PAGED KV cache.

    x:      [B, D_loc(data)] — every slot decodes its own token.
    pool:   (k_pages, v_pages), each [Np_loc + 1, page, KV, hd]: this
            cache shard's pages (global ids [r*Np_loc, (r+1)*Np_loc) at
            cache rank r), then one that takes the writes this rank must
            not make (inactive slots, other shards' pages;
            models/model.py::paged_cache_specs).  Updated IN PLACE (the
            reference donates the pool buffers).
    table:  [B, n_pages_max] int32 GLOBAL page ids per slot (replicated).
    pos:    [B] int32 per-slot positions being written/attended.
    active: [B] bool — inactive slots neither write the cache nor count;
            their outputs are zeros the engine discards.
    ``engine`` pins the paged-attention implementation (tests only).
    With one cache shard the paged kernel runs; with more, the kernel's
    partials of this shard's pages (``paged_attention_partials``) LSE-merge
    over the cache axes, as the reference's ``paged_attention_partials_jnp``
    branch.
    Returns (y [B, D_loc(data)], pool).
    """
    b = x.shape[0]
    h, hd = cfg.padded_heads, cfg.head_dim
    k_pages, v_pages = pool
    np_loc, page = k_pages.shape[0] - 1, k_pages.shape[1]
    q, knew, vnew = _decode_qkv(x, params, pos, cfg, ctx)

    # Cache write: slot b's position pos[b] lives in page
    # table[b, pos[b] // page], row pos[b] % page, of the rank that owns
    # that page.  torch has no drop-mode scatter and an out-of-range index
    # is a device-side assert, so the rows this rank must not write are
    # routed to the pool's trailing page, which no table entry names.  No
    # host sync.
    off = cache_rank(ctx) * np_loc
    col = (pos // page).clamp(max=table.shape[1] - 1).long()
    lp = table.gather(1, col[:, None])[:, 0].long() - off
    writable = active & (lp >= 0) & (lp < np_loc)
    lp_safe = torch.where(writable, lp, np_loc)
    row = (pos % page).long()
    k_pages[lp_safe, row] = knew.to(k_pages.dtype)
    v_pages[lp_safe, row] = vnew.to(v_pages.dtype)

    q_all = _all_heads(q, ctx)                              # [B, H, hd]
    lens = torch.where(active, pos + 1, 0).to(torch.int32)
    if cache_shards(ctx) == 1:
        o = paged.paged_attention(q_all, k_pages, v_pages, table, lens,
                                  window=window, engine=engine)
    else:
        m, l, acc = paged.paged_attention_partials(
            q_all, k_pages[:np_loc], v_pages[:np_loc], table, lens,
            window=window, pool_offset=off, engine=engine)
        l, acc = _merge_over_cache(m, l, acc, ctx)
        o = (acc / torch.clamp(l[..., None], min=1e-30))[:, 0]
    o = o.reshape(b, h, hd)
    return _o_proj(o, params, cfg, ctx, x.dtype), (k_pages, v_pages)
