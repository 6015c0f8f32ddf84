"""Mixture-of-Experts blocks (port of ``repro.models.moe``): two layouts
x three managed dispatch schedules, per rank over the ``model`` axis.

Layouts:

``ep_a2a``    experts sharded by id over the ``model`` axis (moonshot);
              capacity-limited token dispatch crosses the axis.
``expert_tp`` every expert's FFN sharded over ``model`` like a dense MLP
              (grok); dispatch is local on the sequence-gathered tokens.

Dispatch schedules (``cfg.moe.dispatch``, resolved by
``managed.resolve_moe_dispatch``): ``bulk`` (capacity buffers through
one all_to_all each way), ``stream`` (the buffers streamed around the EP
ring by ``managed.managed_expert_stream``; at axis size 1, as in the
reference, it takes the bulk branch), ``dense`` (every expert on every
token, gate-masked: capacity-free) and ``auto`` (the cost model picks).
Capacity comes from each rank's own tokens, so ranks drop differently
from one rank unless the capacity factor is high enough.  Every
collective is the identity at axis size 1.

The expert FFN of the capacity path runs through
``kernels/grouped_matmul.py``: the hand-written CUDA kernel on a card,
whose per-expert valid counts (``expert_counts``) stay on the device.
Across ranks it runs at shard shapes: the ep_a2a bulk branch's G =
E_loc * tp groups over E_loc experts, the stream's [E_loc, C/g, D]
blocks with clipped counts, expert_tp's F_loc = F / tp columns.
The decode flow computes every expert per token, gate-masked, with plain
products (the reference's semantics): one ``torch.matmul`` of
``x[None]`` [1, B, D] against the stacked [E, D, F] weights, so no
permuted copy of a weight is made.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed, transport
from repro_torch.core.overlap import fsdp_gather
from repro_torch.kernels import grouped_matmul
from repro_torch.models import layers
from repro_torch.moe.dispatch import (capacity_for, combine_from_buffers,
                                      dispatch_indices, expert_counts,
                                      gather_to_buffers)
from repro_torch.parallel.sharding import MeshCtx

__all__ = ["moe_block", "moe_block_ep", "moe_block_expert_tp",
           "moe_block_decode", "moe_layout", "resolve_dispatch"]

#: (schedule, g, capacity_factor) of one dispatch call site
Dispatch = tuple[str, int, float]


def _router(x: torch.Tensor, w_router: torch.Tensor, n_experts: int,
            top_k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [T, D] -> (top-k gate weights [T, K] renormalised, top-k expert
    ids [T, K], aux loss).  The top k come from a stable descending sort,
    so equal probabilities keep the lower expert first, as
    ``lax.top_k``."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p = srt.values[:, :top_k]
    top_idx = srt.indices[:, :top_k]
    gates = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss
    mask = F.one_hot(top_idx, n_experts).float().sum(dim=1)
    me = mask.mean(dim=0)
    pe = probs.mean(dim=0)
    aux = n_experts * torch.sum(me * pe)
    return gates, top_idx, aux


def _expert_ffn(h: torch.Tensor, w1: torch.Tensor,
                w1_gate: torch.Tensor | None, w2: torch.Tensor, mlp: str,
                valid: torch.Tensor, engine: str) -> torch.Tensor:
    """Batched expert FFN over capacity groups h [G, C, D] with per-group
    kept-row counts ``valid`` [G]: the grouped-expert kernel."""
    return grouped_matmul.grouped_expert_ffn(h, w1, w1_gate, w2, valid,
                                             mlp=mlp, engine=engine)


def moe_layout(cfg: ModelConfig, ctx: MeshCtx) -> str:
    """The layout ``moe_block`` runs: ep_a2a when the experts divide over
    the model axis and the config allows it, expert_tp otherwise."""
    impl = cfg.moe.impl
    divides = cfg.moe.n_experts % ctx.tp == 0
    if impl in ("auto", "ep_a2a") and divides:
        return "ep_a2a"
    return "expert_tp"


def resolve_dispatch(cfg: ModelConfig, ctx: MeshCtx, tokens_local: int,
                     layout: str) -> Dispatch:
    """Route the dispatch knob through the managed runtime (one
    DecisionRecord(op="moe_dispatch") per call).  An explicit
    ``cfg.moe.dispatch`` wins over the ambient mode; "auto" lets the cost
    model pick (schedule, g, capacity_factor), priced for THIS layout's
    wire.  ``Model`` resolves once per token count and hands the result to
    every layer, as the reference logs once per traced call site."""
    e = cfg.moe
    decision = managed.resolve_moe_dispatch(
        "model", ctx.tp, tokens_local, cfg.d_model, e.n_experts, e.top_k,
        e.d_ff_expert, mults=3 if layers.gated(cfg.mlp) else 2,
        dtype_bytes=getattr(torch, cfg.dtype).itemsize,
        capacity_factor=e.capacity_factor, layout=layout,
        mode=ctx.mdmp_mode,
        schedule=None if e.dispatch == "auto" else e.dispatch,
        g=e.dispatch_g or None)
    return decision.schedule, decision.g, decision.capacity_factor


def _gathered_ffn_weights(params: dict, cfg: ModelConfig, ctx: MeshCtx
                          ) -> tuple[torch.Tensor, torch.Tensor | None,
                                     torch.Tensor]:
    w1 = fsdp_gather(params["w1"], "data", ctx, axis=1, mode=ctx.mdmp_mode)
    w1g = (fsdp_gather(params["w1_gate"], "data", ctx, axis=1,
                       mode=ctx.mdmp_mode)
           if layers.gated(cfg.mlp) else None)
    w2 = fsdp_gather(params["w2"], "data", ctx, axis=2, mode=ctx.mdmp_mode)
    return w1, w1g, w2


def _all_experts(x2: torch.Tensor, w1: torch.Tensor,
                 w1g: torch.Tensor | None, w2: torch.Tensor,
                 mlp: str) -> torch.Tensor:
    """Every expert on every token: x2 [T, D] -> [E, T, D] (the dense
    schedule's products, in x2's type)."""
    xe = x2.unsqueeze(0)
    u = torch.matmul(xe, w1)
    act = layers.activation(mlp, u, torch.matmul(xe, w1g)
                            if layers.gated(mlp) else None)
    return torch.matmul(act, w2)


# ---------------------------------------------------------------------------
# ep_a2a: expert-parallel dispatch across the 'model' axis
# ---------------------------------------------------------------------------


def _dense_fallback_ep(x2: torch.Tensor, gates: torch.Tensor,
                       top_idx: torch.Tensor, w1: torch.Tensor,
                       w1g: torch.Tensor | None, w2: torch.Tensor,
                       cfg: ModelConfig, ctx: MeshCtx,
                       n_experts: int) -> torch.Tensor:
    """The no-dispatch schedule: all-gather the tokens, run this rank's
    E_loc experts on the FULL token set gate-masked, reduce-scatter the
    outputs back.  Capacity-free: no token is ever dropped."""
    e_loc = n_experts // ctx.tp
    ge = _scatter_gates(gates, top_idx, n_experts)          # [t, E]
    x_full = managed.managed_all_gather(x2, "model", ctx,
                                        mode=ctx.mdmp_mode)
    ge_full = managed.managed_all_gather(ge.to(x2.dtype), "model", ctx,
                                         mode=ctx.mdmp_mode)
    o = _all_experts(x_full, w1, w1g, w2, cfg.mlp)        # [E_loc, T, D]
    eidx = ctx.axis_index("model") * e_loc
    g_loc = ge_full[:, eidx:eidx + e_loc]
    y_part = torch.einsum("etd,te->td", o, g_loc.to(o.dtype))
    return managed.managed_reduce_scatter(y_part, "model", ctx,
                                          mode=ctx.mdmp_mode)


def moe_block_ep(x: torch.Tensor, params: dict, cfg: ModelConfig,
                 ctx: MeshCtx, *, dispatch: Dispatch | None = None,
                 engine: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S_loc, D] -> (y, aux_loss).  Experts sharded by id over
    'model'; tokens routed under the managed dispatch schedule.
    ``dispatch`` is a resolved (schedule, g, cf), resolved here when
    None; ``engine`` pins the grouped FFN's engine."""
    e_cfg = cfg.moe
    b, s_loc, d = x.shape
    t = b * s_loc
    tp = ctx.tp
    e = e_cfg.n_experts
    schedule, g, cf = dispatch or resolve_dispatch(cfg, ctx, t, "ep_a2a")
    cap = capacity_for(t, e_cfg, cf)

    x2 = x.reshape(t, d)
    gates, top_idx, aux = _router(x2, params["w_router"], e, e_cfg.top_k)
    w1, w1g, w2 = _gathered_ffn_weights(params, cfg, ctx)

    if schedule == "dense":
        # capacity-free on any axis size, tp=1 included
        y2 = _dense_fallback_ep(x2, gates, top_idx, w1, w1g, w2, cfg, ctx,
                                e)
        return y2.reshape(b, s_loc, d).to(x.dtype), aux

    dest, tok, keep, order = dispatch_indices(top_idx, e, cap)
    buffers = gather_to_buffers(x2, dest, tok, keep, e, cap)
    counts = expert_counts(top_idx, e, cap)

    if schedule == "stream" and tp > 1:
        def expert_fn(blk, valid):
            return _expert_ffn(blk, w1, w1g, w2, cfg.mlp, valid, engine)

        back = managed.managed_expert_stream(buffers, counts, "model", ctx,
                                             expert_fn, g=g)
    else:
        # tokens cross the EP axis: [E, C, D] -> [E_loc, tp*C, D]; the
        # per-expert kept counts ride along on an int all-to-all so the
        # grouped kernel skips the padded capacity rows on the receiving
        # side (G = E_loc * tp groups, tp per expert)
        recv = managed.managed_all_to_all(buffers, "model", ctx,
                                          split_axis=0, concat_axis=1,
                                          mode=ctx.mdmp_mode)
        e_loc = e // tp
        cnt_recv = counts
        if tp > 1:
            cnt_recv = torch.cat(transport.all_to_all(
                list(counts.chunk(tp)), ctx.group("model")))
        hg = recv.reshape(e_loc * tp, cap, d)
        vg = cnt_recv.reshape(tp, e_loc).T.reshape(e_loc * tp)
        out_g = _expert_ffn(hg, w1, w1g, w2, cfg.mlp, vg, engine)
        out = out_g.reshape(e_loc, tp * cap, d)
        # route results back
        back = managed.managed_all_to_all(out, "model", ctx, split_axis=1,
                                          concat_axis=0, mode=ctx.mdmp_mode)
    y2 = combine_from_buffers(back, dest, tok, keep, gates, order, t)
    return y2.reshape(b, s_loc, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# expert_tp: each expert TP-sharded over 'model'
# ---------------------------------------------------------------------------


def moe_block_expert_tp(x: torch.Tensor, params: dict, cfg: ModelConfig,
                        ctx: MeshCtx, *, dispatch: Dispatch | None = None,
                        engine: str = "auto"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S_loc, D] -> (y, aux_loss).  Every rank holds an ff-shard
    of every expert; dispatch happens on the sequence-gathered tokens and
    the down-projection reduce-scatters back to sequence shards.  "stream"
    chunks the sequence AG/RS rings; "dense" skips the capacity buffers
    (every expert on every token, gate-masked: capacity-free)."""
    e_cfg = cfg.moe
    b, s_loc, d = x.shape
    schedule, g, cf = dispatch or resolve_dispatch(cfg, ctx, b * s_loc,
                                                   "expert_tp")
    seq_mode = "interleaved" if schedule == "stream" else ctx.mdmp_mode
    seq_chunks = g if schedule == "stream" else None

    x_full2 = managed.managed_all_gather(layers.to_ring(x), "model", ctx,
                                         mode=seq_mode, chunks=seq_chunks)
    t = x_full2.shape[0]
    e = e_cfg.n_experts
    cap = capacity_for(t, e_cfg, cf)

    gates, top_idx, aux = _router(x_full2, params["w_router"], e,
                                  e_cfg.top_k)
    w1, w1g, w2 = _gathered_ffn_weights(params, cfg, ctx)

    if schedule == "dense":
        ge = _scatter_gates(gates, top_idx, e)               # [T, E]
        part = _all_experts(x_full2, w1, w1g, w2, cfg.mlp)   # [E, T, D]
        y_part = torch.einsum("etd,te->td", part, ge.to(part.dtype))
    else:
        dest, tok, keep, order = dispatch_indices(top_idx, e, cap)
        buffers = gather_to_buffers(x_full2, dest, tok, keep, e, cap)
        counts = expert_counts(top_idx, e, cap)
        part = _expert_ffn(buffers, w1, w1g, w2, cfg.mlp, counts, engine)
        y_part = combine_from_buffers(part, dest, tok, keep, gates, order,
                                      t)

    # one ring both sums the ff-partials and scatters the sequence
    y2 = managed.managed_reduce_scatter(y_part, "model", ctx, mode=seq_mode,
                                        chunks=seq_chunks)
    return layers.from_ring(y2, b).to(x.dtype), aux


def moe_block(x: torch.Tensor, params: dict, cfg: ModelConfig, ctx: MeshCtx,
              *, dispatch: Dispatch | None = None, engine: str = "auto"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    fn = (moe_block_ep if moe_layout(cfg, ctx) == "ep_a2a"
          else moe_block_expert_tp)
    return fn(x, params, cfg, ctx, dispatch=dispatch, engine=engine)


# ---------------------------------------------------------------------------
# Decode flow: single token, batch replicated
# ---------------------------------------------------------------------------


def moe_block_decode(x: torch.Tensor, params: dict, cfg: ModelConfig,
                     ctx: MeshCtx) -> torch.Tensor:
    """x: [B, D_loc(data)] -> [B, D_loc(data)].  Every rank routes the
    replicated batch identically; expert weights stay in place and every
    local expert is computed per token, gate-masked: an ep_a2a rank keeps
    the gate columns of its E_loc experts, an expert_tp rank all of them
    (its ff partials sum over 'model')."""
    e_cfg = cfg.moe
    e = e_cfg.n_experts

    x_full = managed.managed_all_gather(x.T, "data", ctx,
                                        mode=ctx.mdmp_mode).T   # [B, D]
    gates, top_idx, _ = _router(x_full, params["w_router"], e, e_cfg.top_k)
    gate_full = _scatter_gates(gates, top_idx, e)               # [B, E]

    xe = x.unsqueeze(0)                                         # [1, B, D]
    u = torch.matmul(xe, params["w1"])                          # [E, B, F]
    if layers.gated(cfg.mlp):
        g = torch.matmul(xe, params["w1_gate"])
        ug = managed.managed_all_reduce(torch.cat([u, g], dim=-1), "data",
                                        ctx, mode=ctx.mdmp_mode)
        uu, g = ug.chunk(2, dim=-1)
        act = layers.activation(cfg.mlp, uu, g)
    else:
        u = managed.managed_all_reduce(u, "data", ctx, mode=ctx.mdmp_mode)
        act = layers.activation(cfg.mlp, u, None)
    part = torch.matmul(act, params["w2"])                  # [E_loc, B, D]
    if moe_layout(cfg, ctx) == "ep_a2a":
        e_loc = e // ctx.tp
        eidx = ctx.axis_index("model") * e_loc
        gate_full = gate_full[:, eidx:eidx + e_loc]
    y = torch.einsum("ebd,be->bd", part, gate_full.to(part.dtype))
    y = managed.managed_all_reduce(y, "model", ctx, mode=ctx.mdmp_mode)
    return y.to(x.dtype)


def _scatter_gates(gates: torch.Tensor, top_idx: torch.Tensor,
                   n_experts: int) -> torch.Tensor:
    """[T, K] gate weights + ids -> dense [T, E]."""
    oh = F.one_hot(top_idx, n_experts).to(gates.dtype)          # [T, K, E]
    return torch.einsum("tk,tke->te", gates, oh)
