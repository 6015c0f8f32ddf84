"""Managed runtime — configuration, the decision log, the resolvers and
ring attention (port of ``repro.core.managed``).

The reference expresses every collective through a ``managed_*`` entry
point that picks bulk or interleaved execution from the cost model and
logs a ``DecisionRecord``.  ``managed_all_reduce`` /
``managed_all_gather`` / ``managed_all_to_all`` /
``managed_reduce_scatter`` and the fused matmuls are the identity at axis
size 1 (as the reference's are) and raise above it; their
``torch.distributed`` form comes with the managed-collectives slice.  The
serving resolvers (``resolve_serve_schedule``, ``resolve_preempt``), the
halo-aggregation resolver (``resolve_halo_aggregation``), the MoE
dispatch resolver (``resolve_moe_dispatch``), the attention-schedule
resolver (``resolve_attention_schedule``) and the generic call-site
resolver ``_resolve`` are ported whole: they run on the host and price
with ``DEFAULT_HW``.

``managed_ring_attention`` (context parallelism) runs over a
``torch.distributed`` process group: kv blocks travel around the ring by
``batch_isend_irecv`` while the carry kernel folds the block that has
arrived.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import cost_model
from repro_torch.core.cost_model import DEFAULT_HW, HardwareModel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import (finalize_partials,
                                                 init_partials)
from repro_torch.obs.tracer import dispatch_span
from repro_torch.parallel.sharding import MeshCtx

Group = dist.ProcessGroup | None

# ---------------------------------------------------------------------------
# Global MDMP configuration + decision log (the managed-runtime audit trail)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MDMPConfig:
    """Process-wide MDMP behaviour.  ``mode='auto'`` lets the cost model pick
    per call site; forcing ``bulk`` reproduces the unmanaged baseline,
    forcing ``interleaved`` the always-intermingle mode."""
    mode: str = "auto"                # auto | bulk | interleaved
    chunks: int | None = None         # override ring sub-chunking
    hw: HardwareModel = DEFAULT_HW
    log_decisions: bool = True


_STATE = threading.local()


def get_config() -> MDMPConfig:
    cfg = getattr(_STATE, "config", None)
    if cfg is None:
        cfg = MDMPConfig()
        _STATE.config = cfg
    return cfg


class use_config:
    """``with managed.use_config(MDMPConfig(mode='bulk')): ...``"""

    def __init__(self, config: MDMPConfig):
        self._new = config

    def __enter__(self) -> MDMPConfig:
        self._old = getattr(_STATE, "config", None)
        _STATE.config = self._new
        return self._new

    def __exit__(self, *exc: Any) -> None:
        _STATE.config = self._old


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    op: str
    axis: str
    nbytes: int
    mode: str
    chunks: int
    predicted_bulk_s: float
    predicted_interleaved_s: float
    #: monotonic log time (``time.perf_counter``), stamped by
    #: ``log_decision``; excluded from equality so decision-trail
    #: comparisons stay timestamp-free.
    t: float | None = dataclasses.field(default=None, compare=False)


#: Every DecisionRecord ``op`` the managed runtime may emit (the same
#: registry as the reference, so trails compare op for op).
DECISION_OPS = frozenset({
    "halo_aggregation", "attention_schedule", "pipeline_schedule",
    "serve_schedule", "preempt_policy", "ckpt_interval", "moe_dispatch",
    "all_gather", "reduce_scatter", "all_reduce", "all_to_all",
    "all_gather_matmul", "all_gather_matmul_multi", "gram_ag_ring",
    "matmul_reduce_scatter", "ring_attention", "expert_stream",
    "program_plan",
    "lint",
})

_DECISION_LOG: list[DecisionRecord] = []


def log_decision(rec: DecisionRecord) -> None:
    """Append to the audit trail, enforcing the op-name registry."""
    if rec.op not in DECISION_OPS:
        raise ValueError(f"unregistered DecisionRecord op {rec.op!r}; add "
                         f"it to managed.DECISION_OPS")
    if rec.t is None:
        object.__setattr__(rec, "t", time.perf_counter())
    _DECISION_LOG.append(rec)


def decision_log() -> list[DecisionRecord]:
    return list(_DECISION_LOG)


def clear_decision_log() -> None:
    _DECISION_LOG.clear()


class capture_decisions:
    """``with managed.capture_decisions() as cap: ...`` — scoped view of
    the decisions logged inside the block, without clearing the global
    trail.  ``cap.records`` re-slices the trail on every access."""

    def __init__(self) -> None:
        self._start = 0
        self._end: int | None = None

    def __enter__(self) -> "capture_decisions":
        self._start = len(_DECISION_LOG)
        self._end = None
        return self

    def __exit__(self, *exc: Any) -> None:
        self._end = len(_DECISION_LOG)

    @property
    def records(self) -> list[DecisionRecord]:
        return list(_DECISION_LOG[self._start:self._end])


# ---------------------------------------------------------------------------
# Program-plan override (the planner's hook into every resolver)
# ---------------------------------------------------------------------------
#
# Precedence, most-binding first: explicit caller knob > program-plan knob
# > ambient mode > cost-model auto.  The plan is duck-typed (anything with
# ``knob_for(op, axis) -> dict | None``); the planner itself is ported in
# a later slice.


def install_plan(plan: Any | None) -> None:
    """Install (or clear, with None) the active program plan for this
    thread."""
    _STATE.plan = plan


def active_plan() -> Any | None:
    return getattr(_STATE, "plan", None)


class use_plan:
    """``with managed.use_plan(program_plan): ...`` — scoped install."""

    def __init__(self, plan: Any | None):
        self._new = plan

    def __enter__(self) -> Any | None:
        self._old = getattr(_STATE, "plan", None)
        _STATE.plan = self._new
        return self._new

    def __exit__(self, *exc: Any) -> None:
        _STATE.plan = self._old


def _plan_knob(op: str, axis_name: str) -> dict | None:
    plan = active_plan()
    if plan is None:
        return None
    return plan.knob_for(op, axis_name)


# ---------------------------------------------------------------------------
# Collectives at axis size 1
# ---------------------------------------------------------------------------


def _axis_size(axis_name: str, ctx: MeshCtx) -> int:
    return ctx.axis_sizes.get(axis_name, 1)


def _nbytes(x: torch.Tensor) -> int:
    return int(x.numel() * x.element_size())


def _resolve(op: str, axis_name: str, ctx: MeshCtx, nbytes: int,
             mode: str | None, chunks: int | None, collective: str,
             compute_time_s: float = 0.0) -> tuple[str, int]:
    """Resolve mode/chunks for a call site moving ``nbytes`` and log the
    decision (the reference passes the operand and takes its bytes)."""
    cfg = get_config()
    pk = _plan_knob(op, axis_name)
    if pk is not None and mode in (None, "auto") and chunks is None:
        # the program plan binds this call site; an explicit caller
        # mode/chunks would have pinned the knob above it
        mode = pk.get("mode") or mode
        chunks = pk.get("chunks")
    mode = mode or cfg.mode
    n = _axis_size(axis_name, ctx)
    decision = cost_model.decide(
        nbytes, n, compute_time_s=compute_time_s, hw=cfg.hw,
        collective=collective,
        force_mode=None if mode == "auto" else mode)
    eff_chunks = chunks if chunks is not None else (
        cfg.chunks if cfg.chunks is not None else decision.chunks)
    eff_mode = decision.mode if mode == "auto" else mode
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op=op, axis=axis_name, nbytes=nbytes, mode=eff_mode,
            chunks=eff_chunks,
            predicted_bulk_s=decision.bulk_time_s,
            predicted_interleaved_s=decision.interleaved_time_s))
    return eff_mode, max(1, int(eff_chunks))


def _multi_rank(op: str, axis_name: str, n: int) -> NotImplementedError:
    return NotImplementedError(
        f"{op} over axis {axis_name!r} of size {n}: the torch.distributed "
        "collectives come with ROADMAP Queue 1 slice 4")


def managed_all_reduce(x: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                       mode: str | None = None) -> torch.Tensor:
    """Sum ``x`` across ``axis_name`` — the identity at axis size 1."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    raise _multi_rank("managed_all_reduce", axis_name, n)


def managed_all_gather(x: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                       mode: str | None = None,
                       chunks: int | None = None) -> torch.Tensor:
    """All-gather ``x`` (tiled along axis 0) across ``axis_name`` — the
    identity at axis size 1."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    raise _multi_rank("managed_all_gather", axis_name, n)


def managed_reduce_scatter(x: torch.Tensor, axis_name: str, ctx: MeshCtx,
                           *, mode: str | None = None,
                           chunks: int | None = None) -> torch.Tensor:
    """Sum-reduce ``x`` across ``axis_name``, scattering blocks of axis 0
    — the identity at axis size 1."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    raise _multi_rank("managed_reduce_scatter", axis_name, n)


def managed_all_to_all(x: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                       split_axis: int = 0, concat_axis: int = 0,
                       mode: str | None = None) -> torch.Tensor:
    """All-to-all: block j of ``x`` (along ``split_axis``) goes to rank j,
    the received blocks concatenated along ``concat_axis`` — the identity
    at axis size 1."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    raise _multi_rank("managed_all_to_all", axis_name, n)


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                      ctx: MeshCtx, *, mode: str | None = None
                      ) -> torch.Tensor:
    """``all_gather(x, axis) @ w`` — a plain product at axis size 1, whose
    autograd gradient is the reference's custom VJP at that size."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x @ w
    raise _multi_rank("all_gather_matmul", axis_name, n)


def all_gather_matmul_multi(x: torch.Tensor, ws: list[torch.Tensor],
                            axis_name: str, ctx: MeshCtx, *,
                            mode: str | None = None) -> list[torch.Tensor]:
    """``[all_gather(x) @ w for w in ws]`` with one ring for all — plain
    products at axis size 1."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return [x @ w for w in ws]
    raise _multi_rank("all_gather_matmul_multi", axis_name, n)


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                          ctx: MeshCtx, *, mode: str | None = None
                          ) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` over rows — a plain product at axis size
    1."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x @ w
    raise _multi_rank("matmul_reduce_scatter", axis_name, n)


# ---------------------------------------------------------------------------
# Serving resolvers
# ---------------------------------------------------------------------------


def resolve_serve_schedule(axis_name: str, batch_slots: int,
                           mean_prompt: float, mean_new: float,
                           n_params: float, *, dtype_bytes: int = 2,
                           max_prompt: float | None = None,
                           measured_step_s: float | None = None,
                           measured_dispatch_s: float | None = None,
                           ttft_budget_s: float | None = None,
                           mode: str | None = None,
                           schedule: str | None = None,
                           chunk: int | None = None
                           ) -> cost_model.ServeScheduleDecision:
    """The managed-runtime entry for the serving schedule (static waves vs
    continuous batching, plus the scheduling quantum C).  ``mode='bulk'``
    pins static waves (the unmanaged baseline); ``mode='interleaved'``
    pins continuous batching; ``schedule``/``chunk`` pin an explicit
    choice.  Measured step/dispatch seconds from ``serve/metrics.py``
    override the modeled roofline terms.  The DecisionRecord reuses
    ``chunks`` to carry C and the predicted fields to carry
    seconds-per-token."""
    cfg = get_config()
    pk = _plan_knob("serve_schedule", axis_name)
    if pk is not None and schedule is None and chunk is None and \
            mode in (None, "auto"):
        schedule = pk.get("mode")
        chunk = pk.get("chunks")
    eff_mode = mode or cfg.mode
    force = {"bulk": "static", "interleaved": "continuous"}.get(eff_mode,
                                                                schedule)
    decision = cost_model.decide_serve_schedule(
        n_params, batch_slots, mean_prompt, mean_new,
        max_prompt=max_prompt, dtype_bytes=dtype_bytes, hw=cfg.hw,
        measured_step_s=measured_step_s,
        measured_dispatch_s=measured_dispatch_s,
        ttft_budget_s=ttft_budget_s, force_mode=force, force_chunk=chunk)
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op="serve_schedule", axis=axis_name,
            nbytes=int(n_params) * dtype_bytes,
            mode=decision.mode, chunks=decision.chunk,
            predicted_bulk_s=1.0 / max(decision.static_tok_s, 1e-30),
            predicted_interleaved_s=1.0 / max(decision.chosen_tok_s,
                                              1e-30)))
    return decision


def resolve_preempt(axis_name: str, victim_pages: int, page_bytes: int,
                    replay_tokens: int, n_params: float, *,
                    batch_slots: int = 1, dtype_bytes: int = 2,
                    measured_step_s: float | None = None,
                    measured_pcie_bw: float | None = None,
                    chunk_bytes: int | None = None,
                    wait_s: float | None = None,
                    allow_swap: bool = True,
                    mode: str | None = None,
                    policy: str | None = None
                    ) -> cost_model.PreemptDecision:
    """The managed-runtime entry for the serving preemption knob (swap a
    victim's KV pages to host vs drop-and-recompute vs head-of-line
    wait).  ``mode='bulk'`` pins drop-and-recompute; ``mode='interleaved'``
    pins swap; an explicit ``policy`` wins over the ambient mode.  The
    DecisionRecord reuses ``chunks`` to carry the victim's page count and
    the predicted fields to carry recompute-vs-chosen seconds."""
    cfg = get_config()
    pk = _plan_knob("preempt_policy", axis_name)
    if pk is not None and policy is None and mode in (None, "auto"):
        policy = pk.get("mode")
    eff_mode = mode or cfg.mode
    force = policy if policy is not None else \
        {"bulk": "recompute", "interleaved": "swap"}.get(eff_mode)
    decision = cost_model.decide_preempt(
        victim_pages, page_bytes, replay_tokens, n_params,
        step_s=measured_step_s, batch_slots=batch_slots,
        dtype_bytes=dtype_bytes, pcie_bw=measured_pcie_bw,
        chunk_bytes=chunk_bytes, wait_s=wait_s, allow_swap=allow_swap,
        hw=cfg.hw, force_policy=force)
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op="preempt_policy", axis=axis_name,
            nbytes=decision.swap_bytes,
            mode=decision.policy, chunks=decision.victim_pages,
            predicted_bulk_s=decision.recompute_s,
            predicted_interleaved_s=decision.chosen_s))
    return decision


def resolve_halo_aggregation(axis_name: str, axis_size: int,
                             rows_local: int, cols: int, *,
                             dtype_bytes: int = 4,
                             candidate_k: Sequence[int] = (1, 2, 4, 8),
                             mode: str | None = None,
                             k: int | None = None
                             ) -> cost_model.HaloAggregationDecision:
    """The managed-runtime entry for the aggregation knob: pick how many
    stencil sweeps each halo exchange should carry (k=1 = bulk) and log the
    decision.  Called at planning time — ``axis_size`` is the extent of
    the process group the rows are split over — and the chosen k feeds
    ``halo.jacobi_solve(mode="aggregated", k=...)``.

    ``mode="bulk"`` (or a global MDMPConfig forcing bulk) pins k=1 — the
    paper-faithful unmanaged baseline; ``k`` pins an explicit sweep count
    (the tuner's measured override).  The DecisionRecord reuses ``chunks``
    to carry k and the predicted fields to carry seconds-per-sweep.
    """
    cfg = get_config()
    pk_plan = _plan_knob("halo_aggregation", axis_name)
    if pk_plan is not None and mode in (None, "auto") and k is None:
        k = pk_plan.get("chunks")
    eff_mode = mode or cfg.mode
    force_k = 1 if eff_mode == "bulk" else k
    decision = cost_model.decide_halo_aggregation(
        rows_local, cols, axis_size, dtype_bytes=dtype_bytes, hw=cfg.hw,
        candidate_k=candidate_k, force_k=force_k)
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op="halo_aggregation", axis=axis_name,
            nbytes=2 * decision.k * cols * dtype_bytes,
            mode=decision.mode, chunks=decision.k,
            predicted_bulk_s=decision.bulk_sweep_s,
            predicted_interleaved_s=decision.aggregated_sweep_s))
    return decision


def resolve_moe_dispatch(axis_name: str, axis_size: int, tokens_local: int,
                         d_model: int, n_experts: int, top_k: int,
                         d_ff_expert: int, *, mults: int = 3,
                         dtype_bytes: int = 2,
                         capacity_factor: float = 1.25,
                         measured_imbalance: float | None = None,
                         measured_drop_rate: float | None = None,
                         measured_occupancy: float | None = None,
                         layout: str = "ep_a2a",
                         mode: str | None = None,
                         schedule: str | None = None,
                         g: int | None = None,
                         capacity_factor_override: float | None = None
                         ) -> cost_model.MoEDispatchDecision:
    """The managed-runtime entry for the MoE dispatch knob (bulk a2a vs
    chunked-stream vs dense-fallback, plus the capacity factor), logged as
    a ``DecisionRecord(op="moe_dispatch")``.  ``mode='bulk'`` pins the
    unmanaged baseline; ``mode='interleaved'`` pins the always-stream
    schedule; an explicit ``schedule`` (a pinned ``cfg.moe.dispatch``)
    wins over the ambient mode.  The DecisionRecord reuses ``chunks`` to
    carry the stream chunk count g."""
    cfg = get_config()
    pk = _plan_knob("moe_dispatch", axis_name)
    if pk is not None and schedule is None and g is None and \
            mode in (None, "auto"):
        schedule = pk.get("mode")
        g = pk.get("chunks")
        if capacity_factor_override is None:
            capacity_factor_override = pk.get("capacity_factor")
    eff_mode = mode or cfg.mode
    force = schedule if schedule is not None else \
        {"bulk": "bulk", "interleaved": "stream"}.get(eff_mode)
    decision = cost_model.decide_moe_dispatch(
        tokens_local, d_model, n_experts, top_k, d_ff_expert, axis_size,
        mults=mults, dtype_bytes=dtype_bytes,
        capacity_factor=capacity_factor,
        measured_imbalance=measured_imbalance,
        measured_drop_rate=measured_drop_rate,
        measured_occupancy=measured_occupancy, hw=cfg.hw, layout=layout,
        force_schedule=force, force_g=g,
        force_capacity_factor=capacity_factor_override)
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op="moe_dispatch", axis=axis_name, nbytes=decision.a2a_bytes,
            mode=decision.schedule, chunks=decision.g,
            predicted_bulk_s=decision.bulk_s,
            predicted_interleaved_s=decision.chosen_s))
    return decision


# ---------------------------------------------------------------------------
# Managed ring attention (context parallelism)
#
# The paper's Figure-3 strategy mapped onto attention: q stays sequence-
# sharded, kv blocks rotate around the ring while the carry kernel folds
# the block that already arrived into the online-softmax (m, l, acc) carry.
# The permute of the next block is posted BEFORE the current block is
# folded and waited for only before it is used.  ``mode='bulk'`` is the
# oracle: all-gather the kv and take ONE step (identical math, bulk
# communication).  Blocks that the causal or window mask rules out are
# skipped on the host; every rank still takes part in every permute.
#
# The backward re-streams the ring: dq accumulates locally as kv blocks
# pass by again, while each block's f32 (dk, dv) accumulator travels WITH
# it and arrives back home after a full cycle.  Residuals are only (q, k,
# v, out, lse).
# ---------------------------------------------------------------------------


def _group_rank(group: Group, n: int) -> int:
    """This rank's index along the ring axis of size ``n``."""
    if n == 1:
        return 0
    if group is None:
        raise ValueError(f"ring attention over {n} ranks needs their "
                         "process group")
    if dist.get_world_size(group) != n:
        raise ValueError(f"the process group has "
                         f"{dist.get_world_size(group)} ranks, the axis "
                         f"{n}")
    return dist.get_rank(group)


def _ring_permute_start(tensors: list[torch.Tensor], group: Group, idx: int,
                        n: int, tag0: int = 0
                        ) -> tuple[list[torch.Tensor], list]:
    """Post one ring step (the reference's ``_ring_perm``: rank i sends to
    i + 1): every tensor goes to the next rank, and the previous rank's
    arrive in fresh buffers once every returned work has been waited for.
    Tags keep the tensors apart where next and previous are the same rank
    (n = 2).  The caller keeps the (contiguous) sent tensors alive until
    then."""
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for i, t in enumerate(tensors):
        if not t.is_contiguous():
            raise ValueError("ring messages are contiguous tensors")
        ops.append(dist.P2POp(dist.isend, t, nxt, group, tag=tag0 + i))
        ops.append(dist.P2POp(dist.irecv, recv[i], prv, group,
                              tag=tag0 + i))
    return recv, dist.batch_isend_irecv(ops)


def _wait(works: list) -> None:
    for w in works:
        w.wait()


def _block_visible(q_off: int, k_off: int, sq: int, skv: int, causal: bool,
                   window: int) -> bool:
    """Whether ANY (qpos, kpos) pair of the block survives the mask."""
    vis = True
    if causal:
        vis = vis and k_off <= q_off + sq - 1
    if window > 0:
        vis = vis and (q_off - (k_off + skv - 1)) < window
    return vis


def resolve_ring_attention(axis_name: str, ctx: MeshCtx, batch: int,
                           s_local: int, heads: int, head_dim: int,
                           kv_nbytes: int, *, causal: bool = True,
                           mode: str | None = None) -> str:
    """The ring-attention call site's mode (bulk gather vs interleaved
    ring), priced as an all-gather of the ``kv_nbytes`` of this rank's k
    against the flash compute it can hide, and logged as a
    ``DecisionRecord(op="ring_attention")``."""
    n = _axis_size(axis_name, ctx)
    compute_s = ((0.5 if causal else 1.0) * n
                 * cost_model.attention_flash_step_s(
                     batch, s_local, heads, head_dim, get_config().hw))
    eff_mode, _ = _resolve("ring_attention", axis_name, ctx, kv_nbytes,
                           mode, None, "all_gather",
                           compute_time_s=compute_s)
    return eff_mode


def managed_ring_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, axis_name: str, ctx: MeshCtx,
                           causal: bool = True, window: int = 0,
                           mode: str | None = None, *, group: Group = None,
                           engine: str = "auto",
                           decided: str | None = None) -> torch.Tensor:
    """Sequence-sharded attention with kv streamed around ``axis_name``.

    q: [B, S_loc, H, hd]; k, v: [B, S_loc, KV, hd] — every rank holds its
    own sequence block of q AND kv.  Global positions are rank-derived:
    q[0] sits at ``rank * S_loc``.  The axis size comes from ``ctx``;
    above 1 ``group`` is that axis's process group.  Returns [B, S_loc,
    H, hd] in q's type, differentiable in q, k and v.

    ``mode`` pins the schedule as in the reference (resolved and logged
    per call); ``decided`` is a mode the caller has already resolved and
    logged (``resolve_ring_attention``), so the model resolves once per
    shape, not per layer per step.  ``engine="torch"`` pins the plain
    carry step (tests)."""
    n = _axis_size(axis_name, ctx)
    idx = _group_rank(group, n)
    with dispatch_span("attention.ring", q, op="ring_attention",
                       axis=axis_name, nbytes=2 * _nbytes(k),
                       buffer="kv_blocks"):
        if decided is None:
            b, s_loc, h, hd = q.shape
            decided = resolve_ring_attention(
                axis_name, ctx, b, s_loc, h, hd, _nbytes(k), causal=causal,
                mode=mode)
        return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, window, decided,
                                    n, idx, group, engine)


class _RingAttention(torch.autograd.Function):
    """The reference's custom VJP: the forward saves (q, k, v, out, lse)
    and the backward re-streams the ring."""

    @staticmethod
    def forward(fctx, q, k, v, causal, window, mode, n, idx, group, engine):
        out, lse = _ring_fwd(q, k, v, causal, window, mode, n, idx, group,
                             engine)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.args = (causal, window, mode, n, idx, group)
        return out

    @staticmethod
    def backward(fctx, dy):
        q, k, v, out, lse = fctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, out, lse, dy, *fctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None


def _q_offset(idx: int, s_loc: int, causal: bool, window: int) -> int:
    # positions matter only under a mask
    return idx * s_loc if (causal or window > 0) else 0


def _ring_fwd(q, k, v, causal, window, mode, n, idx, group, engine):
    b, s_loc, h, hd = q.shape

    def step(kb, vb, carry, q_off, k_off):
        return kernel_ops.flash_attention_step(
            q, kb, vb, carry, causal=causal, window=window, q_offset=q_off,
            k_offset=k_off, engine=engine)

    if n == 1:
        return finalize_partials(*step(k, v, None, 0, 0), out_dtype=q.dtype)
    q_off = _q_offset(idx, s_loc, causal, window)
    if mode == "bulk":
        kg, vg = _all_gather_seq(k, group, n), _all_gather_seq(v, group, n)
        return finalize_partials(*step(kg, vg, None, q_off, 0),
                                 out_dtype=q.dtype)
    carry = init_partials(b, s_loc, h, hd, device=q.device)
    kb, vb = k, v
    for s in range(n):
        if s < n - 1:
            # post block s+1's transfer before folding block s
            nxt, works = _ring_permute_start([kb, vb], group, idx, n)
        k_off = ((idx - s) % n) * s_loc
        if _block_visible(q_off, k_off, s_loc, s_loc, causal, window):
            carry = step(kb, vb, carry, q_off, k_off)
        if s < n - 1:
            _wait(works)
            kb, vb = nxt
    return finalize_partials(*carry, out_dtype=q.dtype)


def _all_gather_seq(x: torch.Tensor, group: Group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def _ring_bwd(q, k, v, out, lse, dy, causal, window, mode, n, idx, group):
    b, s_loc, h, hd = q.shape
    dsum = (dy.float() * out.float()).sum(dim=-1)

    def step_bwd(kb, vb, q_off, k_off):
        return kernel_ops.flash_attention_bwd_block(
            q, kb, vb, dy, lse, dsum, causal=causal, window=window,
            q_offset=q_off, k_offset=k_off)

    def cast(dq, dk, dv):
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

    if n == 1:
        return cast(*step_bwd(k, v, 0, 0))
    q_off = _q_offset(idx, s_loc, causal, window)
    if mode == "bulk":
        kg, vg = _all_gather_seq(k, group, n), _all_gather_seq(v, group, n)
        dq, dk_full, dv_full = step_bwd(kg, vg, q_off, 0)
        # each rank computed its q rows' share of EVERY kv position: the
        # transpose of the gather sums them and keeps this rank's slice
        # (an all-reduce: gloo has no reduce-scatter)
        dist.all_reduce(dk_full, group=group)
        dist.all_reduce(dv_full, group=group)
        rows = slice(idx * s_loc, (idx + 1) * s_loc)
        return cast(dq, dk_full[:, rows], dv_full[:, rows])
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kb, vb = k, v
    for s in range(n):
        if s < n - 1:
            nxt, works = _ring_permute_start([kb, vb], group, idx, n)
        k_off = ((idx - s) % n) * s_loc
        if _block_visible(q_off, k_off, s_loc, s_loc, causal, window):
            dq_i, dk_i, dv_i = step_bwd(kb, vb, q_off, k_off)
            dq += dq_i
            dkb += dk_i
            dvb += dv_i
        # the (dk, dv) accumulators travel WITH their block: after the
        # full cycle every rank has contributed and the sums are home
        home, acc_works = _ring_permute_start([dkb, dvb], group, idx, n,
                                              tag0=2)
        _wait(acc_works)
        dkb, dvb = home
        if s < n - 1:
            _wait(works)
            kb, vb = nxt
    return cast(dq, dkb, dvb)


def resolve_attention_schedule(axis_name: str, axis_size: int, batch: int,
                               s_local: int, heads: int, kv_heads: int,
                               head_dim: int, d_model: int, *,
                               dtype_bytes: int = 2, causal: bool = True,
                               mode: str | None = None,
                               schedule: str | None = None
                               ) -> cost_model.AttentionScheduleDecision:
    """The managed-runtime entry for the three-way attention schedule
    (bulk sequence-gather vs ulysses a2a vs ring streaming).  Called with
    static shapes; the chosen schedule feeds ``models/attention.py``
    dispatch and lands in the decision log.

    ``mode='bulk'`` pins the unmanaged baseline; ``mode='interleaved'``
    pins the always-stream schedule (ring); ``schedule`` pins an explicit
    choice (the tuner's measured winner)."""
    cfg = get_config()
    pk = _plan_knob("attention_schedule", axis_name)
    if pk is not None and schedule is None and mode in (None, "auto"):
        schedule = pk.get("mode")
    eff_mode = mode or cfg.mode
    force = {"bulk": "bulk", "interleaved": "ring"}.get(eff_mode, schedule)
    decision = cost_model.decide_attention_schedule(
        batch, s_local, heads, kv_heads, head_dim, d_model, axis_size,
        dtype_bytes=dtype_bytes, causal=causal, hw=cfg.hw,
        force_schedule=force)
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op="attention_schedule", axis=axis_name,
            nbytes=2 * batch * s_local * kv_heads * head_dim * dtype_bytes,
            mode=decision.schedule, chunks=max(1, axis_size),
            predicted_bulk_s=decision.bulk_s,
            predicted_interleaved_s=decision.chosen_s))
    return decision
