"""Attention — the paged decode flow of the serving runtime (port of
``repro.models.attention``; the SP flow and the contiguous-cache decode
come with the training slice).

Decode flow (batch replicated; KV pool sharded over data x model on the
page dim):
  * q/k/v via weight-stationary contractions closed over 'data';
  * the new K/V row is written into the slot's page in place;
  * all q heads are gathered over 'model' (tiny), paged attention runs
    on the local pool, and the partials LSE-merge over the cache axes;
  * o-projection row-parallel, closed over 'model'.
At axis size 1 the collectives are the identity and the pool is one shard,
which is the only case this slice runs: the multi-shard merge raises
until the managed collectives are ported.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed
from repro_torch.kernels import paged_attention as paged
from repro_torch.models import layers
from repro_torch.parallel.sharding import MeshCtx


def padded_kv_heads(cfg: ModelConfig) -> int:
    """Smallest kv-head count >= n_kv_heads that divides padded_heads."""
    h = cfg.padded_heads
    kv = max(1, cfg.n_kv_heads)
    while h % kv:
        kv += 1
    return kv


def cache_axes(ctx: MeshCtx) -> tuple[str, ...]:
    """Mesh axes the KV-cache page dim is sharded over."""
    return (("pod", "data", "model") if ctx.has_pod else ("data", "model"))


def cache_shards(ctx: MeshCtx) -> int:
    n = 1
    for ax in cache_axes(ctx):
        n *= ctx.axis_sizes.get(ax, 1)
    return n


def attention_decode_paged(x: torch.Tensor,
                           pool: tuple[torch.Tensor, torch.Tensor],
                           table: torch.Tensor, pos: torch.Tensor,
                           active: torch.Tensor, params: dict,
                           cfg: ModelConfig, ctx: MeshCtx, *,
                           window: int = 0, engine: str = "auto"
                           ) -> tuple[torch.Tensor,
                                      tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode attention against a PAGED KV cache.

    x:      [B, D] — every slot decodes its own token.
    pool:   (k_pages, v_pages), each [Np + 1, page, KV, hd]: pages
            0..Np-1 are the table's, the last one takes the writes of
            inactive slots (models/model.py::paged_cache_specs).  Updated
            IN PLACE (the reference donates the pool buffers).
    table:  [B, n_pages_max] int32 page ids per slot.
    pos:    [B] int32 per-slot positions being written/attended.
    active: [B] bool — inactive slots neither write the cache nor count;
            their outputs are zeros the engine discards.
    ``engine`` pins the paged-attention implementation (tests only).
    Returns (y [B, D], pool).
    """
    n_sh = cache_shards(ctx)
    if n_sh != 1:
        raise NotImplementedError(
            f"paged attention over {n_sh} cache shards: the distributed "
            "LSE merge comes with ROADMAP Queue 1 slice 4")
    b = x.shape[0]
    h = cfg.padded_heads
    h_loc = h // ctx.tp
    kvh = padded_kv_heads(cfg)
    hd = cfg.head_dim
    k_pages, v_pages = pool
    np_loc, page = k_pages.shape[0] - 1, k_pages.shape[1]

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

    # Cache write: slot b's position pos[b] lives in page
    # table[b, pos[b] // page], row pos[b] % page.  torch has no drop-mode
    # scatter and an out-of-range index is a device-side assert, so the
    # rows that must not be written (inactive slots) are routed to the
    # pool's trailing page, which no table entry names.  No host sync.
    col = (pos // page).clamp(max=table.shape[1] - 1).long()
    lp = table.gather(1, col[:, None])[:, 0].long()
    writable = active & (lp >= 0) & (lp < np_loc)
    lp_safe = torch.where(writable, lp, np_loc)
    row = (pos % page).long()
    k_pages[lp_safe, row] = knew.to(k_pages.dtype)
    v_pages[lp_safe, row] = vnew.to(v_pages.dtype)

    q_all = managed.managed_all_gather(
        q.transpose(0, 1), "model", ctx, mode=ctx.mdmp_mode)  # [H, B, hd]
    q_all = q_all.transpose(0, 1).contiguous()              # [B, H, hd]
    lens = torch.where(active, pos + 1, 0).to(torch.int32)
    o = paged.paged_attention(q_all, k_pages, v_pages, table, lens,
                              window=window, engine=engine)
    o = o.reshape(b, h, hd).to(x.dtype)

    o_my = o[:, :h_loc]                        # this model rank's heads
    y = managed.managed_all_reduce(
        o_my.reshape(b, h_loc * hd) @ params["w_o"], "model", ctx,
        mode=ctx.mdmp_mode)
    return y.to(x.dtype), (k_pages, v_pages)
