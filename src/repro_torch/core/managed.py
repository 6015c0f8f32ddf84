"""Managed runtime — configuration, the decision log, the managed
collectives, the resolvers and ring attention (port of
``repro.core.managed``).

Every collective goes through a ``managed_*`` entry point that picks bulk
or interleaved (ring) execution from the cost model and logs a
``DecisionRecord``: ``managed_all_gather`` / ``managed_reduce_scatter`` /
``managed_all_reduce`` / ``managed_all_to_all`` and the fused
``all_gather_matmul[_multi]`` / ``matmul_reduce_scatter``.  They are
per-rank code over the ``torch.distributed`` process group of each mesh
axis (``MeshCtx.groups``), moved by core/transport.py, and each is a
``torch.autograd.Function`` whose backward is the reference's custom VJP.
At axis size 1 each is the identity.  The serving resolvers
(``resolve_serve_schedule``, ``resolve_preempt``), the halo-aggregation
resolver (``resolve_halo_aggregation``), the MoE dispatch resolver
(``resolve_moe_dispatch``), the attention-schedule resolver
(``resolve_attention_schedule``), the pipeline-schedule resolver
(``resolve_pipeline_schedule``), the checkpoint-cadence resolver
(``resolve_checkpoint``) and the generic call-site resolver ``_resolve``
run on the host and price with ``DEFAULT_HW``.

``managed_expert_stream`` (expert parallelism) streams the MoE capacity
buffers around the expert-parallel ring: each block's permute is posted
before the previous block's expert FFN runs, and each chunk's result goes
home with its own permute.  ``managed_psum_scatter_gather`` is the
all-reduce as a reduce-scatter followed by an all-gather.

``managed_ring_attention`` (context parallelism) runs over a process
group too: kv blocks travel around the ring by batched point-to-point
ops while the carry kernel folds the block that has arrived.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import cost_model, transport
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
    # quantized FSDP weight gathering (fp8 payload, the master weights in
    # their own type, an exact-type gradient reduce-scatter)
    fsdp_gather_dtype: str | None = None


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
# ``knob_for(op, axis) -> dict | None``): plan/planner.py's
# ``ProgramPlan``.


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
# Managed collectives
#
# Per-rank code over one process group per mesh axis (``MeshCtx.groups``).
# Every collective is a ``torch.autograd.Function`` whose backward is its
# exact dual as another managed collective (AG <-> RS, AR <-> AR, A2A <->
# reverse A2A, AG-matmul <-> matmul-RS + gram ring), resolved and logged
# again, as the reference's custom VJPs are.  ``mode="bulk"`` is one
# backend collective; ``"interleaved"`` is the ring: ``chunks`` messages a
# step over batched point-to-point ops, the next block's permute posted
# before the block that arrived is consumed.  Messages go through
# core/transport.py.  At axis size 1 each is the identity (or the plain
# product).
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


def _split(x: torch.Tensor, chunks: int) -> list[torch.Tensor]:
    if chunks <= 1 or x.shape[0] % chunks:
        return [x]
    return list(x.chunk(chunks))


def _permute_start(tensors: list[torch.Tensor], group: Group, idx: int,
                   n: int, tag0: int = 0, shift: int = 1
                   ) -> tuple[list[torch.Tensor], transport.Pending]:
    """Post one ring step (the reference's ``_ring_perm``: rank i sends to
    i + ``shift``): every tensor goes to rank idx + shift, and rank idx -
    shift's arrive in fresh buffers once the returned ``Pending`` has been
    waited for.  Tags keep the messages apart where both peers are the
    same rank (n = 2).  The sent tensors must stay unchanged until
    then."""
    recv = [torch.empty_like(t) for t in tensors]
    pending = transport.p2p_start(
        [(t, (idx + shift) % n, tag0 + i) for i, t in enumerate(tensors)],
        [(r, (idx - shift) % n, tag0 + i) for i, r in enumerate(recv)],
        group)
    return recv, pending


def _join(pieces: list[torch.Tensor]) -> torch.Tensor:
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _ring_pass(x: torch.Tensor, group: Group, idx: int, n: int,
               chunks: int):
    """Yield ``(src, block)``: this rank's ``x`` first, then each other
    rank's block as it travels by, the permute of the next block in
    flight while the caller consumes this one."""
    buf = x.contiguous()
    for s in range(n):
        if s < n - 1:
            # the step as ``chunks`` messages (``_ppermute_chunked``)
            nxt, pending = _permute_start(_split(buf, chunks), group, idx,
                                          n)
        yield (idx - s) % n, buf
        if s < n - 1:
            pending.wait()
            buf = _join(nxt)


def _ring_reduce(block_of, group: Group, idx: int, n: int,
                 chunks: int) -> torch.Tensor:
    """The reduce-scatter ring: block b starts at rank b + 1 and gathers
    each rank's share on its way to rank b.  ``block_of(b)`` is this
    rank's share of block b, computed while the partial is in flight."""
    send = block_of((idx - 1) % n)
    for s in range(1, n):
        recv, pending = _permute_start(_split(send.contiguous(), chunks),
                                       group, idx, n)
        mine = block_of((idx - 1 - s) % n)
        pending.wait()
        send = _join(recv) + mine
    return send


def _rows(n: int, x: torch.Tensor, what: str) -> int:
    if x.shape[0] % n:
        raise ValueError(f"{what}: axis 0 ({x.shape[0]}) not divisible by "
                         f"the axis size {n}")
    return x.shape[0] // n


def _all_gather_impl(x, axis_name, ctx, mode, chunks):
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    eff_mode, c = _resolve("all_gather", axis_name, ctx, _nbytes(x), mode,
                           chunks, "all_gather")
    group = ctx.group(axis_name)
    if eff_mode == "bulk":
        return torch.cat(transport.all_gather(x, group))
    m = x.shape[0]
    out = x.new_empty((n * m,) + tuple(x.shape[1:]))
    for src, blk in _ring_pass(x, group, ctx.axis_index(axis_name), n, c):
        out[src * m:(src + 1) * m] = blk
    return out


def _reduce_scatter_impl(x, axis_name, ctx, mode, chunks):
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    eff_mode, c = _resolve("reduce_scatter", axis_name, ctx, _nbytes(x),
                           mode, chunks, "reduce_scatter")
    group = ctx.group(axis_name)
    m = _rows(n, x, "reduce_scatter")
    if eff_mode == "bulk":
        return transport.reduce_scatter(x, group)
    x = x.contiguous()
    return _ring_reduce(lambda b: x[b * m:(b + 1) * m], group,
                        ctx.axis_index(axis_name), n, c)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axis_name, ctx, mode, chunks):
        fctx.args = (axis_name, ctx, mode, chunks)
        return _all_gather_impl(x, axis_name, ctx, mode, chunks)

    @staticmethod
    def backward(fctx, dy):
        return (_reduce_scatter_impl(dy, *fctx.args), None, None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axis_name, ctx, mode, chunks):
        fctx.args = (axis_name, ctx, mode, chunks)
        return _reduce_scatter_impl(x, axis_name, ctx, mode, chunks)

    @staticmethod
    def backward(fctx, dy):
        return _all_gather_impl(dy, *fctx.args), None, None, None, None


class _Sum(torch.autograd.Function):
    """The bulk all-reduce; its transpose is the all-reduce itself."""

    @staticmethod
    def forward(fctx, x, group):
        fctx.group = group
        return transport.all_reduce(x, group)

    @staticmethod
    def backward(fctx, dy):
        return transport.all_reduce(dy, fctx.group), None


def managed_all_gather(x: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                       mode: str | None = None,
                       chunks: int | None = None) -> torch.Tensor:
    """All-gather ``x`` (tiled along axis 0) across ``axis_name``; its
    gradient is the reduce-scatter."""
    if _axis_size(axis_name, ctx) == 1:
        return x
    return _AllGather.apply(x, axis_name, ctx, mode, chunks)


def managed_reduce_scatter(x: torch.Tensor, axis_name: str, ctx: MeshCtx,
                           *, mode: str | None = None,
                           chunks: int | None = None) -> torch.Tensor:
    """Sum-reduce ``x`` across ``axis_name``, scattering blocks of axis 0
    (tiled): rank i receives ``sum_r x_r[i*m:(i+1)*m]``; its gradient is
    the all-gather."""
    if _axis_size(axis_name, ctx) == 1:
        return x
    return _ReduceScatter.apply(x, axis_name, ctx, mode, chunks)


def managed_all_reduce(x: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                       mode: str | None = None,
                       chunks: int | None = None) -> torch.Tensor:
    """Sum ``x`` across ``axis_name`` (every rank receives the sum).  The
    ring composes the managed reduce-scatter and all-gather, zero-padding
    a leading axis that the axis size does not divide; a 0-d operand takes
    the bulk all-reduce and its DecisionRecord says so (mode='bulk')."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    scalar = x.dim() == 0
    eff_mode, c = _resolve("all_reduce", axis_name, ctx, _nbytes(x),
                           "bulk" if scalar else mode, chunks, "all_reduce")
    if eff_mode == "bulk" or scalar:
        return _Sum.apply(x, ctx.group(axis_name))
    rows = x.shape[0]
    if rows % n:
        x = torch.cat([x, x.new_zeros((n - rows % n,) + tuple(x.shape[1:]))])
    scattered = managed_reduce_scatter(x, axis_name, ctx, mode=eff_mode,
                                       chunks=c)
    full = managed_all_gather(scattered, axis_name, ctx, mode=eff_mode,
                              chunks=c)
    return full[:rows] if rows != full.shape[0] else full


def all_reduce_max(x: torch.Tensor, axes: Sequence[str],
                   ctx: MeshCtx) -> torch.Tensor:
    """The maximum over ``axes`` (the reference's ``lax.pmax``; no
    gradient, no decision)."""
    for ax in axes:
        if _axis_size(ax, ctx) > 1:
            x = transport.all_reduce(x, ctx.group(ax), dist.ReduceOp.MAX)
    return x


def all_reduce_min(x: torch.Tensor, axes: Sequence[str],
                   ctx: MeshCtx) -> torch.Tensor:
    """The minimum over ``axes`` (the reference's ``lax.pmin``)."""
    for ax in axes:
        if _axis_size(ax, ctx) > 1:
            x = transport.all_reduce(x, ctx.group(ax), dist.ReduceOp.MIN)
    return x


def _all_to_all_impl(x, axis_name, ctx, split_axis, concat_axis, mode,
                     chunks):
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x
    eff_mode, _ = _resolve("all_to_all", axis_name, ctx, _nbytes(x), mode,
                           chunks, "all_to_all")
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} ({x.shape[split_axis]}"
                         f") not divisible by the axis size {n}")
    group, idx = ctx.group(axis_name), ctx.axis_index(axis_name)
    blocks = [b.contiguous() for b in x.chunk(n, split_axis)]
    if eff_mode == "bulk":
        got = transport.all_to_all(blocks, group)
    else:
        # every shifted permute sources from x: all n - 1 messages are in
        # flight at once; block (idx + s) goes to rank idx + s
        got = [None] * n
        got[idx] = blocks[idx]
        recv = [torch.empty_like(blocks[0]) for _ in range(1, n)]
        transport.p2p_start(
            [(blocks[(idx + s) % n], (idx + s) % n, s) for s in range(1, n)],
            [(recv[s - 1], (idx - s) % n, s) for s in range(1, n)],
            group).wait()
        for s in range(1, n):
            got[(idx - s) % n] = recv[s - 1]
    return torch.cat(got, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, axis_name, ctx, split_axis, concat_axis, mode,
                chunks):
        fctx.args = (axis_name, ctx, split_axis, concat_axis, mode, chunks)
        return _all_to_all_impl(x, axis_name, ctx, split_axis, concat_axis,
                                mode, chunks)

    @staticmethod
    def backward(fctx, dy):
        # the transpose of an all-to-all is the reverse all-to-all
        axis_name, ctx, split_axis, concat_axis, mode, chunks = fctx.args
        return (_all_to_all_impl(dy, axis_name, ctx, concat_axis, split_axis,
                                 mode, chunks),
                None, None, None, None, None, None)


def managed_all_to_all(x: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                       split_axis: int = 0, concat_axis: int = 0,
                       mode: str | None = None,
                       chunks: int | None = None) -> torch.Tensor:
    """All-to-all: block j of ``x`` (along ``split_axis``) goes to rank j,
    the received blocks concatenated along ``concat_axis`` in source-rank
    order; its gradient is the reverse all-to-all."""
    if _axis_size(axis_name, ctx) == 1:
        return x
    return _AllToAll.apply(x, axis_name, ctx, split_axis, concat_axis, mode,
                           chunks)


# -- fused ring collectives: the paper's Figure 3, tile-granular ------------


def _matmul_compute_s(flops: float) -> float:
    return flops / get_config().hw.peak_flops


def _ag_matmul_impl(x, ws, axis_name, ctx, mode, chunks, op):
    """``[all_gather(x) @ w for w in ws]``: one gather ring, each arriving
    block multiplied by every w while the next block is in flight."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return [x @ w for w in ws]
    cols = sum(w.shape[1] for w in ws)
    compute_s = _matmul_compute_s(2.0 * x.shape[0] * n * x.shape[1] * cols)
    eff_mode, c = _resolve(op, axis_name, ctx, _nbytes(x), mode, chunks,
                           "all_gather", compute_time_s=compute_s)
    group = ctx.group(axis_name)
    if eff_mode == "bulk":
        xg = torch.cat(transport.all_gather(x, group))
        return [xg @ w for w in ws]
    m = x.shape[0]
    outs = [x.new_empty((n * m, w.shape[1])) for w in ws]
    for src, blk in _ring_pass(x, group, ctx.axis_index(axis_name), n, c):
        for o, w in zip(outs, ws):
            o[src * m:(src + 1) * m] = blk @ w
    return outs


def _gram_ag_ring(a, b, axis_name, ctx, mode, chunks):
    """``all_gather(a)^T @ b`` with the gather interleaved into the
    accumulation (the dw of the ring VJPs).  a: [m_loc, p] sharded on axis
    0; b: [n*m_loc, q] full rows.  Returns this rank's [p, q]."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return a.t() @ b
    eff_mode, c = _resolve("gram_ag_ring", axis_name, ctx, _nbytes(a), mode,
                           chunks, "all_gather")
    group = ctx.group(axis_name)
    if eff_mode == "bulk":
        return torch.cat(transport.all_gather(a, group)).t() @ b
    m = a.shape[0]
    acc = None
    for src, blk in _ring_pass(a, group, ctx.axis_index(axis_name), n, c):
        part = (blk.t() @ b[src * m:(src + 1) * m]).float()
        acc = part if acc is None else acc + part
    return acc.to(torch.promote_types(a.dtype, b.dtype))


def _mmrs_impl(x, w, axis_name, ctx, mode, chunks):
    """``reduce_scatter(x @ w)`` with the matmul interleaved into the
    reduction ring: each step computes only the output block about to be
    sent."""
    n = _axis_size(axis_name, ctx)
    if n == 1:
        return x @ w
    compute_s = _matmul_compute_s(2.0 * x.shape[0] * x.shape[1]
                                  * w.shape[1])
    eff_mode, c = _resolve("matmul_reduce_scatter", axis_name, ctx,
                           _nbytes(x), mode, chunks, "reduce_scatter",
                           compute_time_s=compute_s)
    group = ctx.group(axis_name)
    m = _rows(n, x, "matmul_reduce_scatter")
    if eff_mode == "bulk":
        return transport.reduce_scatter(x @ w, group)
    return _ring_reduce(lambda b: x[b * m:(b + 1) * m] @ w, group,
                        ctx.axis_index(axis_name), n, c)


class _AllGatherMatmul(torch.autograd.Function):
    """The reference's custom VJP: dx = matmul_reduce_scatter(dy, w^T)
    and dw = the gram ring, for each w."""

    @staticmethod
    def forward(fctx, x, axis_name, ctx, mode, chunks, op, *ws):
        fctx.save_for_backward(x, *ws)
        fctx.args = (axis_name, ctx, mode, chunks)
        return tuple(_ag_matmul_impl(x, list(ws), axis_name, ctx, mode,
                                     chunks, op))

    @staticmethod
    def backward(fctx, *dys):
        x, *ws = fctx.saved_tensors
        dx, dws = None, []
        for w, dy in zip(ws, dys):
            d = _mmrs_impl(dy, w.t(), *fctx.args)
            dx = d if dx is None else dx + d
            dws.append(_gram_ag_ring(x, dy, *fctx.args).to(w.dtype))
        return (dx.to(x.dtype), None, None, None, None, None, *dws)


class _MatmulReduceScatter(torch.autograd.Function):
    """The reference's custom VJP: dx = all_gather_matmul(dy, w^T) and
    dw = x^T @ AG(dy) by the gram ring over dy."""

    @staticmethod
    def forward(fctx, x, w, axis_name, ctx, mode, chunks):
        fctx.save_for_backward(x, w)
        fctx.args = (axis_name, ctx, mode, chunks)
        return _mmrs_impl(x, w, axis_name, ctx, mode, chunks)

    @staticmethod
    def backward(fctx, dy):
        x, w = fctx.saved_tensors
        axis_name, ctx, mode, chunks = fctx.args
        (dx,) = _ag_matmul_impl(dy, [w.t()], axis_name, ctx, mode, chunks,
                                "all_gather_matmul")
        dw = _gram_ag_ring(dy, x, *fctx.args).t()
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                      ctx: MeshCtx, *, mode: str | None = None,
                      chunks: int | None = None) -> torch.Tensor:
    """``all_gather(x, axis) @ w`` with the gather interleaved into the
    matmul: each ring step multiplies the block that arrived while the
    next is in flight.  x: [m_local, k] sharded on axis 0, w: [k, f].
    Returns [m_local * n, f]."""
    if _axis_size(axis_name, ctx) == 1:
        return x @ w
    (y,) = _AllGatherMatmul.apply(x, axis_name, ctx, mode, chunks,
                                  "all_gather_matmul", w)
    return y


def all_gather_matmul_multi(x: torch.Tensor, ws: list[torch.Tensor],
                            axis_name: str, ctx: MeshCtx, *,
                            mode: str | None = None,
                            chunks: int | None = None
                            ) -> list[torch.Tensor]:
    """``[all_gather(x) @ w for w in ws]`` with ONE ring for all (fused
    QKV / up+gate projections whose outputs shard differently)."""
    if _axis_size(axis_name, ctx) == 1:
        return [x @ w for w in ws]
    return list(_AllGatherMatmul.apply(x, axis_name, ctx, mode, chunks,
                                       "all_gather_matmul_multi", *ws))


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axis_name: str,
                          ctx: MeshCtx, *, mode: str | None = None,
                          chunks: int | None = None) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` over rows, the matmul interleaved into the
    reduction ring (the paper's "send data as soon as it has been
    computed").  x: [M, k_local], w: [k_local, d] (both sharded on the
    contracting dim).  Returns [M // n, d] (rank i holds row block i)."""
    if _axis_size(axis_name, ctx) == 1:
        return x @ w
    return _MatmulReduceScatter.apply(x, w, axis_name, ctx, mode, chunks)


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


def resolve_pipeline_schedule(axis_name: str, axis_size: int,
                              batch_fwd_s: float, batch_bytes: float, *,
                              n_layers: int | None = None,
                              stash_cap_bytes: float | None = None,
                              candidate_micro: Sequence[int] = (4, 8, 16,
                                                                32),
                              candidate_virtual: Sequence[int] = (2,),
                              overlap_budget: float = 1.0,
                              mode: str | None = None,
                              schedule: str | None = None,
                              n_micro: int | None = None,
                              virtual: int | None = None
                              ) -> cost_model.PipelineScheduleDecision:
    """The managed-runtime entry for the pipeline-schedule knob (gpipe vs
    1f1b vs interleaved, plus the microbatch count M and virtual chunk
    factor v) — the analogue of ``resolve_halo_aggregation`` for the
    pipeline-parallel training loop.  Called at build time with static
    shapes; the chosen (schedule, M, v) feeds
    ``parallel/pipeline.build_schedule`` and lands in the decision log.

    ``mode='bulk'`` pins gpipe (the unmanaged forward-then-backward
    baseline); ``mode='interleaved'`` pins 1f1b (the always-intermingle
    schedule); ``schedule``/``n_micro``/``virtual`` pin an explicit
    choice (the tuner's measured winner).  ``overlap_budget`` is the
    instrumented readiness of the stage boundary
    (``instrument.analyze_region``, as ``CommRegion.plan`` passes it) —
    how much of a tick's compute can hide the handoff bytes.  The
    DecisionRecord reuses ``chunks`` to carry the microbatch count M."""
    cfg = get_config()
    pk = _plan_knob("pipeline_schedule", axis_name)
    if pk is not None and schedule is None and n_micro is None and \
            mode in (None, "auto"):
        schedule = pk.get("mode")
        n_micro = pk.get("chunks")
        if virtual is None:
            virtual = pk.get("virtual")
    eff_mode = mode or cfg.mode
    # an EXPLICIT schedule wins over the ambient mode (same precedence as
    # cfg.attn_impl vs mdmp_mode): mode only maps to a schedule when none
    # was requested
    force = schedule if schedule is not None else \
        {"bulk": "gpipe", "interleaved": "1f1b"}.get(eff_mode)
    decision = cost_model.decide_pipeline_schedule(
        axis_size, batch_fwd_s, batch_bytes, n_layers=n_layers,
        stash_cap_bytes=stash_cap_bytes,
        candidate_micro=candidate_micro,
        candidate_virtual=candidate_virtual, hw=cfg.hw,
        overlap_budget=overlap_budget, force_schedule=force,
        force_micro=n_micro, force_virtual=virtual)
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op="pipeline_schedule", axis=axis_name,
            nbytes=int(batch_bytes / max(1, decision.n_micro)),
            mode=decision.schedule, chunks=decision.n_micro,
            predicted_bulk_s=decision.bulk_s,
            predicted_interleaved_s=decision.chosen_s))
    return decision


def resolve_checkpoint(axis_name: str, step_s: float, snapshot_bytes: int,
                       *, mtbf_s: float = 1800.0,
                       measured_write_bw: float | None = None,
                       measured_ckpt_cost_s: float | None = None,
                       measured_restore_s: float | None = None,
                       mode: str | None = None,
                       interval: int | None = None
                       ) -> cost_model.CheckpointDecision:
    """The managed-runtime entry for the checkpoint-cadence knob (the
    Young/Daly interval) — the analogue of ``resolve_serve_schedule`` for
    the fault-tolerance path.  Called by ``TrainLoop`` between steps with
    the EWMA step time and checkpoint/metrics.py's measured write
    bandwidth / per-checkpoint cost; the chosen interval drives the next
    ``save_async`` and lands in the decision log.

    ``mode='bulk'`` pins the fixed ``ckpt_every=25`` baseline (the
    unmanaged cadence every prior PR shipped); an explicit ``interval``
    wins over the ambient mode (same precedence as every other managed
    knob).  The DecisionRecord reuses ``chunks`` to carry the interval
    and the predicted fields to carry overhead fractions (fixed vs
    chosen)."""
    cfg = get_config()
    pk = _plan_knob("ckpt_interval", axis_name)
    if pk is not None and interval is None and mode in (None, "auto"):
        interval = pk.get("chunks")
    eff_mode = mode or cfg.mode
    force = interval if interval is not None else (
        cost_model.CKPT_FIXED_INTERVAL if eff_mode == "bulk" else None)
    decision = cost_model.decide_checkpoint(
        step_s, snapshot_bytes, mtbf_s=mtbf_s,
        write_bw=measured_write_bw,
        ckpt_cost_s=measured_ckpt_cost_s,
        restore_s=measured_restore_s, hw=cfg.hw, force_interval=force)
    if cfg.log_decisions:
        log_decision(DecisionRecord(
            op="ckpt_interval", axis=axis_name,
            nbytes=int(snapshot_bytes),
            mode=decision.mode, chunks=decision.interval,
            predicted_bulk_s=decision.fixed_overhead,
            predicted_interleaved_s=decision.chosen_overhead))
    return decision


# ---------------------------------------------------------------------------
# Managed expert dispatch (expert parallelism)
#
# The paper's Figure-3 strategy mapped onto MoE token routing: the [E, C,
# D] capacity buffers are the declared communication, and instead of one
# bulk all-to-all each way around the expert FFN, the ring streams one
# rank-block at a time — the NEXT block's permute is posted before the
# current block's expert FFN runs, and each of the g capacity chunks'
# results returns home with its own permute as soon as it is computed.
# The same math as all-to-all -> FFN -> reverse all-to-all (the bulk
# oracle).  The reference's backward is plain autodiff over linear
# permutes; here each permute is a ``torch.autograd.Function`` whose
# backward is the inverse permute, so autograd streams the backward ring
# through ``expert_fn``'s own backward.
# ---------------------------------------------------------------------------


class _Permuted(torch.autograd.Function):
    """``arrived`` (what a permute by ``shift`` brought) as the function of
    the ``sent`` tensor: its gradient is the inverse permute of the
    output's gradient."""

    @staticmethod
    def forward(fctx, sent, arrived, shift, group, idx, n):
        fctx.args = (group, idx, n, shift)
        return arrived.view_as(arrived)

    @staticmethod
    def backward(fctx, dy):
        group, idx, n, shift = fctx.args
        (dx,), pending = _permute_start([dy.contiguous()], group, idx, n,
                                        shift=-shift)
        pending.wait()
        return dx, None, None, None, None, None


def managed_expert_stream(buffers: torch.Tensor, counts: torch.Tensor,
                          axis_name: str, ctx: MeshCtx, expert_fn, *,
                          g: int = 1) -> torch.Tensor:
    """Stream expert-capacity buffers around ``axis_name``.

    buffers: [E, C, D] capacity rows of THIS rank's tokens (expert-major,
    experts sharded E_loc = E/n per rank); counts: [E] int valid-row
    counts (rows past the count are zero padding); ``expert_fn(block,
    valid)`` applies this rank's LOCAL experts to an [E_loc, c, D] block
    (c = C/g) with per-expert valid counts [E_loc].  Returns [E, C, D]:
    row-block e holds the processed rows of expert e for MY tokens —
    exactly ``managed_all_to_all -> ffn -> reverse managed_all_to_all``.
    """
    n = _axis_size(axis_name, ctx)
    e, c, d = buffers.shape
    if n == 1:
        return expert_fn(buffers, counts)
    if e % n:
        raise ValueError(f"expert_stream: {e} experts over {n} ranks")
    eff_g = g if (g >= 1 and c % max(1, g) == 0) else 1
    _resolve("expert_stream", axis_name, ctx, _nbytes(buffers),
             "interleaved", eff_g, "all_to_all")
    with dispatch_span("moe.expert_stream", buffers, op="expert_stream",
                       axis=axis_name, nbytes=_nbytes(buffers),
                       chunks=eff_g, buffer="expert_buffers"):
        return _expert_stream_body(
            buffers.reshape(n, e // n, c, d), counts.reshape(n, e // n),
            ctx.group(axis_name), ctx.axis_index(axis_name), n, eff_g,
            expert_fn)


def _expert_stream_body(blocks, cnt_blocks, group, idx, n, eff_g,
                        expert_fn):
    _, e_loc, c, d = blocks.shape
    cs = c // eff_g
    out = [None] * n
    cur, cur_cnt = blocks[idx], cnt_blocks[idx]
    for s in range(n):
        if s + 1 < n:
            # post the NEXT block's transfer before this block's FFN
            send_to = (idx + s + 1) % n
            (nxt, nxt_cnt), pending = _permute_start(
                [blocks[send_to].detach(), cnt_blocks[send_to]], group,
                idx, n, shift=s + 1)
        rets, back = [], []
        for j in range(eff_g):
            vj = torch.clamp(cur_cnt - j * cs, 0, cs)
            yj = expert_fn(cur[:, j * cs:(j + 1) * cs].contiguous(), vj)
            if s > 0:
                # the chunk's result returns to its source rank while the
                # next chunk's FFN runs
                (arr,), ret = _permute_start([yj.detach().contiguous()], group,
                                             idx, n, tag0=2 + j, shift=-s)
                back.append(ret)
                yj = (yj, arr)
            rets.append(yj)
        for ret in back:
            ret.wait()
        if s > 0:
            rets = [_Permuted.apply(y, arr, -s, group, idx, n)
                    for y, arr in rets]
        # what arrived in the return permutes: rank idx+s's experts'
        # output on MY capacity rows
        out[(idx + s) % n] = torch.cat(rets, dim=1) if eff_g > 1 else rets[0]
        if s + 1 < n:
            pending.wait()
            cur = _Permuted.apply(blocks[send_to], nxt, s + 1, group, idx, n)
            cur_cnt = nxt_cnt
    return torch.cat(out, dim=0)


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
    carry step and its plain backward (tests)."""
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
        fctx.args = (causal, window, mode, n, idx, group, engine)
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
            nxt, pending = _permute_start([kb, vb], group, idx, n)
        k_off = ((idx - s) % n) * s_loc
        if _block_visible(q_off, k_off, s_loc, s_loc, causal, window):
            carry = step(kb, vb, carry, q_off, k_off)
        if s < n - 1:
            pending.wait()
            kb, vb = nxt
    return finalize_partials(*carry, out_dtype=q.dtype)


def _all_gather_seq(x: torch.Tensor, group: Group, n: int) -> torch.Tensor:
    return torch.cat(transport.all_gather(x, group), dim=1)


def _ring_bwd(q, k, v, out, lse, dy, causal, window, mode, n, idx, group,
              engine):
    b, s_loc, h, hd = q.shape
    dy = dy.contiguous()
    dsum = (dy.float() * out.float()).sum(dim=-1)

    def step_bwd(kb, vb, q_off, k_off):
        return kernel_ops.flash_attention_bwd_block(
            q, kb, vb, dy, lse, dsum, causal=causal, window=window,
            q_offset=q_off, k_offset=k_off, engine=engine)

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
        rows = slice(idx * s_loc, (idx + 1) * s_loc)
        dk = transport.all_reduce(dk_full, group)[:, rows]
        dv = transport.all_reduce(dv_full, group)[:, rows]
        return cast(dq, dk, dv)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kb, vb = k, v
    for s in range(n):
        if s < n - 1:
            nxt, pending = _permute_start([kb, vb], group, idx, n)
        k_off = ((idx - s) % n) * s_loc
        if _block_visible(q_off, k_off, s_loc, s_loc, causal, window):
            dq_i, dk_i, dv_i = step_bwd(kb, vb, q_off, k_off)
            dq += dq_i
            dkb += dk_i
            dvb += dv_i
        # the (dk, dv) accumulators travel WITH their block: after the
        # full cycle every rank has contributed and the sums are home
        home, acc_pending = _permute_start([dkb, dvb], group, idx, n,
                                           tag0=2)
        acc_pending.wait()
        dkb, dvb = home
        if s < n - 1:
            pending.wait()
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


# ---------------------------------------------------------------------------
# Convenience: sequence-parallel psum replacement
# ---------------------------------------------------------------------------


def managed_psum_scatter_gather(x: torch.Tensor, axis_name: str,
                                ctx: MeshCtx, *,
                                mode: str | None = None) -> torch.Tensor:
    """The all-reduce as a reduce-scatter then an all-gather, so that the
    two halves can straddle compute (Megatron-SP style); numerically the
    all-reduce."""
    return managed_all_gather(
        managed_reduce_scatter(x, axis_name, ctx, mode=mode), axis_name,
        ctx, mode=mode)
