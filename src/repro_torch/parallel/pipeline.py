"""Managed pipeline parallelism over the ``pod`` axis (port of
``repro.parallel.pipeline``).

The multi-pod mesh's default posture is hierarchical DP across pods; this
module provides the alternative: the pod axis as pipeline STAGES.  Layers
split into contiguous chunks (one per *virtual* stage; ``virtual=1`` is the
classic one-chunk-per-rank layout) and microbatches stream through a
lock-step schedule whose per-tick stage handoff is one batch of
point-to-point messages (the MDMP "message"): the activation forward and
the gradient backward, posted together at the end of a tick and waited
for at the start of the next, like the paper's intermingled sends.

Three schedules share one executor, driven by host-built timetables:

  * ``gpipe``        — all forwards, then all backwards.  Simple, but every
                       stage stashes O(M) microbatch activations.
  * ``1f1b``         — the backward of microbatch i starts as soon as the
                       last stage finishes its forward; forwards and
                       backwards share ticks, so at most O(S) activations
                       are ever live per stage.
  * ``interleaved``  — ``virtual`` layer chunks per rank (Megatron-style
                       circular placement: chunk j of rank r is virtual
                       stage j*S + r).  The ramp shrinks by the chunk
                       factor at the cost of ~virtual x more (smaller)
                       handoffs.

Which schedule (and microbatch count / virtual factor) to run is a managed
decision: ``core/cost_model.decide_pipeline_schedule`` models each
timetable's ticks x (alpha + bytes/bw) + bubble, and
``core/managed.resolve_pipeline_schedule`` logs the choice.

The timetables are numpy arrays built (and their invariants checked) on
the host, the reference's array for array; every handoff is *tight* by
construction — the consuming rank runs the dependent unit exactly one tick
after the producer — so the executor needs no receive queues, just the
activation stash.  The executor is per-rank code (one process per rank):
each rank reads its own column of the timetable, so the ranks post
matching sends and receives without a handshake.  In eager code a chunk is
an exact slice of the stacked ``[L, ...]`` layer weights
(``chunk_slice``); the reference's masked scan over a padded slice is not
needed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import transport
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import dispatch_span
from repro_torch.parallel.sharding import MeshCtx

SCHEDULES = ("gpipe", "1f1b", "interleaved")

#: counters of the executor's stage handoffs (messages this rank sent and
#: their bytes)
REGISTRY = MetricsRegistry()
HANDOFF_MESSAGES = "pipeline.handoff_messages"
HANDOFF_BYTES = "pipeline.handoff_bytes"


def handoffs() -> tuple[int, int]:
    """(messages, bytes) this rank has handed to a neighbouring stage."""
    return (int(REGISTRY.counter(HANDOFF_MESSAGES).value),
            int(REGISTRY.counter(HANDOFF_BYTES).value))


def reset_handoffs() -> None:
    REGISTRY.counter(HANDOFF_MESSAGES).value = 0
    REGISTRY.counter(HANDOFF_BYTES).value = 0


# ---------------------------------------------------------------------------
# Layer -> stage/chunk partitioning
# ---------------------------------------------------------------------------


def chunk_bounds(n_layers: int, n_chunks: int,
                 chunk_idx: int) -> tuple[int, int]:
    """(first layer, layer count) of chunk ``chunk_idx`` when ``n_layers``
    split into ``n_chunks`` contiguous chunks.  The remainder
    ``n_layers % n_chunks`` is distributed to the FIRST chunks (one extra
    layer each) so no layer is ever dropped."""
    base, rem = divmod(int(n_layers), int(n_chunks))
    chunk_idx = int(chunk_idx)
    lo = chunk_idx * base + min(chunk_idx, rem)
    return lo, base + (1 if chunk_idx < rem else 0)


def max_chunk_layers(n_layers: int, n_chunks: int) -> int:
    """Upper bound on any chunk's layer count."""
    return -(-int(n_layers) // int(n_chunks))


def chunk_slice(stacked: dict, n_layers: int, n_chunks: int,
                chunk_idx: int) -> dict:
    """Chunk ``chunk_idx``'s layers of a leaf-stacked layer dict: each
    leaf's rows ``[lo, lo + per)`` (views; ``chunk_bounds``' remainder
    rule)."""
    lo, per = chunk_bounds(n_layers, n_chunks, chunk_idx)
    return {k: v[lo:lo + per] for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# Host-built lock-step timetables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """One schedule's timetable: per tick and rank, the forward / backward
    lane's (microbatch, virtual chunk, stash slot), -1 = idle.  ``n_stash``
    is the peak live activation count per rank — the memory contrast
    between schedules (gpipe: M; 1f1b: <= 2S-1)."""
    name: str
    n_stage: int
    n_micro: int
    virtual: int
    ticks: int
    n_stash: int
    f_mb: np.ndarray          # [T, S] int32
    f_chunk: np.ndarray
    f_slot: np.ndarray
    b_mb: np.ndarray
    b_chunk: np.ndarray
    b_slot: np.ndarray


def _timetable(name: str, m: int, s: int, v: int):
    """(mb, virtual stage) -> tick for the F and B lanes.  Every schedule
    here is *tight*: F(mb, q) runs exactly one tick after F(mb, q-1) and
    B(mb, q) exactly one tick after B(mb, q+1), so handoffs never queue."""
    n_virtual = s * v
    fwd: dict[tuple[int, int], int] = {}
    bwd: dict[tuple[int, int], int] = {}
    if name in ("gpipe", "1f1b"):
        if v != 1:
            raise ValueError(f"{name} runs one chunk per rank (virtual=1)")
        for mb in range(m):
            for q in range(s):
                fwd[(mb, q)] = mb + q
                bwd[(mb, q)] = ((m + s - 1) + (m - 1 - mb) + (s - 1 - q)
                                if name == "gpipe"
                                else 2 * s - 1 - q + mb)
    elif name == "interleaved":
        if v < 2:
            raise ValueError("interleaved needs virtual >= 2")
        if m % s:
            raise ValueError(
                f"interleaved needs n_micro % n_stage == 0 (got {m} % {s})")
        for mb in range(m):
            g, i = divmod(mb, s)
            last_f = g * v * s + (v - 1) * s + i + (s - 1)
            for q in range(n_virtual):
                j, r = divmod(q, s)
                fwd[(mb, q)] = g * v * s + j * s + i + r
                bwd[(mb, q)] = last_f + 1 + (n_virtual - 1 - q)
    else:
        raise ValueError(f"unknown pipeline schedule {name!r}")
    return fwd, bwd


def build_schedule(name: str, n_micro: int, n_stage: int,
                   virtual: int = 1) -> PipelineSchedule:
    """Build (and verify) the lock-step timetable for one schedule."""
    m, s = int(n_micro), int(n_stage)
    v = int(virtual) if name == "interleaved" else 1
    n_virtual = s * v
    fwd, bwd = _timetable(name, m, s, v)
    ticks = 1 + max(max(fwd.values()), max(bwd.values()))

    f_mb = np.full((ticks, s), -1, np.int32)
    f_chunk = np.full((ticks, s), -1, np.int32)
    b_mb = np.full((ticks, s), -1, np.int32)
    b_chunk = np.full((ticks, s), -1, np.int32)
    for (mb, q), t in fwd.items():
        r = q % s
        assert f_mb[t, r] < 0, ("F lane collision", name, t, r)
        f_mb[t, r], f_chunk[t, r] = mb, q
        if q > 0:                       # tight forward handoff
            assert fwd[(mb, q - 1)] == t - 1, (name, mb, q)
        assert bwd[(mb, q)] > t, (name, mb, q)
    for (mb, q), t in bwd.items():
        r = q % s
        assert b_mb[t, r] < 0, ("B lane collision", name, t, r)
        b_mb[t, r], b_chunk[t, r] = mb, q
        if q < n_virtual - 1:           # tight backward handoff
            assert bwd[(mb, q + 1)] == t - 1, (name, mb, q)

    # Stash slots: allocated at F, freed after B.  A slot freed by this
    # tick's B only re-enters the pool NEXT tick (the executor runs F's
    # stash write before B's read).
    f_slot = np.full((ticks, s), -1, np.int32)
    b_slot = np.full((ticks, s), -1, np.int32)
    n_stash = 1
    for r in range(s):
        free: list[int] = []
        live: dict[tuple[int, int], int] = {}
        hwm = 0
        for t in range(ticks):
            if f_mb[t, r] >= 0:
                slot = free.pop() if free else hwm
                if slot == hwm:
                    hwm += 1
                f_slot[t, r] = slot
                live[(int(f_mb[t, r]), int(f_chunk[t, r]))] = slot
            if b_mb[t, r] >= 0:
                slot = live.pop((int(b_mb[t, r]), int(b_chunk[t, r])))
                b_slot[t, r] = slot
                free.append(slot)
        assert not live, (name, r, live)
        n_stash = max(n_stash, hwm)

    return PipelineSchedule(
        name=name, n_stage=s, n_micro=m, virtual=v, ticks=ticks,
        n_stash=n_stash, f_mb=f_mb, f_chunk=f_chunk, f_slot=f_slot,
        b_mb=b_mb, b_chunk=b_chunk, b_slot=b_slot)


# ---------------------------------------------------------------------------
# The lock-step executor (forward + backward through the pipeline)
# ---------------------------------------------------------------------------


def _handoff(sends: list[tuple[torch.Tensor, int, int]],
             recvs: list[tuple[torch.Tensor, int, int]],
             group: Any) -> transport.Pending | None:
    """Post one tick's stage messages as one batch (tag 0 forward, 1
    backward), counting what this rank sends."""
    if not sends and not recvs:
        return None
    for t, _, _ in sends:
        REGISTRY.counter(HANDOFF_MESSAGES).add(1)
        REGISTRY.counter(HANDOFF_BYTES).add(t.numel() * t.element_size())
    return transport.p2p_start(sends, recvs, group)


def pipeline_value_and_grad(chunk_fn: Callable, loss_fn: Callable,
                            params: Any, x_proto: torch.Tensor,
                            sched: PipelineSchedule, axis_name: str,
                            ctx: MeshCtx, *, mean: bool = True,
                            grad_seed_scale: float = 1.0,
                            reduce_grads: bool = True
                            ) -> tuple[torch.Tensor, Any]:
    """Run the pipelined training step on this rank: loss AND grads flow
    through the pipeline via explicit forward / backward ticks.

    chunk_fn(params, chunk_idx, mb_idx, x) -> y
        one virtual stage's layer chunk; y has ``x_proto``'s shape.  The
        FIRST virtual stage (chunk_idx == 0, only ever run on rank 0)
        must ignore ``x`` and build its input from the microbatch index
        (embedding / injection).
    loss_fn(params, y, mb_idx) -> 0-d tensor
        per-microbatch loss from the LAST virtual stage's output.
    params: a tree (dicts, lists) of tensors; the grads come back in its
        structure.
    x_proto: a tensor (any device, ``meta`` too) of the inter-stage
        activation block's shape and type; the blocks live on the
        parameters' device.

    Per tick every rank runs at most one F unit under ``torch.no_grad``,
    stashing the chunk's INPUT, then at most one B unit: the chunk re-run
    with grad enabled (rematerialisation) and ``torch.autograd.grad``
    seeded from the loss, scaled by ``seed_scale``, at the last virtual
    stage, else from the received gradient.  The tick's activation and
    gradient then go to the neighbouring stages, forward ``i -> (i+1) %
    S`` and backward ``i -> (i-1) % S``, as one batch of point-to-point
    messages (core/transport.py) waited for at the start of the next tick
    — the two MDMP messages of this subsystem.

    Returns (loss, grads): the loss is summed over ``axis_name`` (only the
    last stage adds; valid on every rank); grads cover this rank's chunks
    (zeros elsewhere) unless ``reduce_grads`` also sums them over
    ``axis_name``.  ``mean=True`` returns per-microbatch means;
    ``mean=False`` the sums.  ``grad_seed_scale`` multiplies the backward
    seed only (the correction for a loss that is all-reduced, and so
    replicated, over other axes) — the reported loss is never scaled by
    it.
    """
    s = sched.n_stage
    n_virtual = s * sched.virtual
    m = sched.n_micro
    sid = ctx.axis_index(axis_name) if s > 1 else 0
    group = ctx.group(axis_name) if s > 1 else None
    nxt, prv = (sid + 1) % s, (sid - 1) % s
    leaves, spec = pytree.tree_flatten(params)
    device = leaves[0].device
    act_shape, act_dtype = tuple(x_proto.shape), x_proto.dtype
    seed_scale = (1.0 / m if mean else 1.0) * grad_seed_scale

    stash: list[torch.Tensor | None] = [None] * sched.n_stash
    grads: list[torch.Tensor | None] = [None] * len(leaves)
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    y_prev = dx_prev = None             # this rank's last outputs (S == 1)
    x_recv = dy_recv = None
    pending = None

    def zeros() -> torch.Tensor:
        return torch.zeros(act_shape, dtype=act_dtype, device=device)

    nbytes = int(np.prod(act_shape)) * x_proto.element_size()
    with dispatch_span("pipeline.ticks", x_proto, op="pipeline_schedule",
                       axis=axis_name, nbytes=nbytes,
                       scale=max(1, int(sched.ticks)), schedule=sched.name,
                       buffer="stage_handoff"):
        for t in range(sched.ticks):
            if pending is not None:
                pending.wait()
                pending = None
            if s == 1:
                x_recv, dy_recv = y_prev, dx_prev
            f_mb, f_chunk = int(sched.f_mb[t, sid]), int(sched.f_chunk[t, sid])
            b_mb, b_chunk = int(sched.b_mb[t, sid]), int(sched.b_chunk[t, sid])
            y_out = dx_out = None

            if f_mb >= 0:
                x_in = x_recv if f_chunk > 0 else zeros()
                with torch.no_grad():
                    y_out = chunk_fn(params, f_chunk, f_mb,
                                     x_in).to(act_dtype).contiguous()
                stash[int(sched.f_slot[t, sid])] = x_in

            if b_mb >= 0:
                slot = int(sched.b_slot[t, sid])
                x_in, stash[slot] = stash[slot], None
                mine = [leaf.detach().requires_grad_() for leaf in leaves]
                p = pytree.tree_unflatten(mine, spec)
                xi = x_in.detach().requires_grad_(b_chunk > 0)
                with torch.enable_grad():
                    y = chunk_fn(p, b_chunk, b_mb, xi)
                    if b_chunk == n_virtual - 1:
                        out = loss_fn(p, y, b_mb)
                        seed = torch.full_like(out, seed_scale)
                        loss_acc = loss_acc + out.detach().float()
                    else:
                        out, seed = y, dy_recv.to(y.dtype)
                    got = torch.autograd.grad(
                        out, mine + ([xi] if b_chunk > 0 else []),
                        grad_outputs=seed, allow_unused=True)
                del out, y, seed
                for i, g in enumerate(got[:len(leaves)]):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
                if b_chunk > 0:
                    dx = got[-1]
                    dx_out = (zeros() if dx is None
                              else dx.to(act_dtype).contiguous())
                del got

            if s == 1:
                y_prev, dx_prev = y_out, dx_out
            elif t + 1 < sched.ticks:
                sends, recvs = [], []
                if y_out is not None and f_chunk < n_virtual - 1:
                    sends.append((y_out, nxt, 0))
                if dx_out is not None:
                    sends.append((dx_out, prv, 1))
                x_recv = dy_recv = None
                if (sched.f_mb[t + 1, sid] >= 0
                        and sched.f_chunk[t + 1, sid] > 0):
                    x_recv = zeros()
                    recvs.append((x_recv, prv, 0))
                if (sched.b_mb[t + 1, sid] >= 0
                        and sched.b_chunk[t + 1, sid] < n_virtual - 1):
                    dy_recv = zeros()
                    recvs.append((dy_recv, nxt, 1))
                pending = _handoff(sends, recvs, group)

    loss = loss_acc / m if mean else loss_acc
    out_grads = [torch.zeros_like(leaf) if g is None else g.to(leaf.dtype)
                 for g, leaf in zip(grads, leaves)]
    if s > 1:
        loss = transport.all_reduce(loss, group)    # only the last stage adds
        if reduce_grads:
            out_grads = [transport.all_reduce(g, group) for g in out_grads]
    return loss, pytree.tree_unflatten(out_grads, spec)


# ---------------------------------------------------------------------------
# Forward-only GPipe (the bulk baseline; kept for inference / demos)
# ---------------------------------------------------------------------------


def pipeline_apply(stage_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                   stage_params: Any, x_microbatches: torch.Tensor,
                   axis_name: str, ctx: MeshCtx) -> torch.Tensor:
    """Forward-only GPipe over the ``axis_name`` stages.

    stage_fn(x, params) -> x    this rank's layer sub-stack
    stage_params                this rank's stage parameters (local)
    x_microbatches: [M, B, ...] microbatches (equal on every stage; only
                                stage 0's input content matters)
    Returns [M, B, ...] outputs (valid on the LAST stage; other stages
    return zeros — callers select, see select_last_stage).

    Schedule: T = M + S - 1 ticks; at tick t stage s processes microbatch
    t - s.  The inter-stage handoff is one message per tick, stage i to
    stage i + 1.
    """
    n_stage = ctx.axis_sizes.get(axis_name, 1)
    sid = ctx.axis_index(axis_name)
    group = ctx.group(axis_name)
    m = x_microbatches.shape[0]
    outputs = torch.zeros_like(x_microbatches)
    inflight = pending = None
    if sid > 0:
        inflight = torch.empty_like(x_microbatches[0])
        pending = _handoff([], [(inflight, sid - 1, 0)], group)
    with dispatch_span("pipeline.apply", x_microbatches,
                       op="pipeline_schedule", axis=axis_name,
                       nbytes=x_microbatches[0].numel()
                       * x_microbatches.element_size(),
                       scale=max(1, m + n_stage - 1), schedule="gpipe_fwd",
                       buffer="stage_handoff"):
        # tick sid + mb: this stage's microbatch mb; its output goes on
        # while the next microbatch's input arrives
        for mb in range(m):
            if pending is not None:
                pending.wait()
            x_in = x_microbatches[mb] if sid == 0 else inflight
            y = stage_fn(x_in, stage_params).contiguous()
            if sid == n_stage - 1:
                outputs[mb] = y
            sends = [(y, sid + 1, 0)] if sid < n_stage - 1 else []
            recvs = []
            if sid > 0 and mb + 1 < m:
                inflight = torch.empty_like(x_microbatches[0])
                recvs.append((inflight, sid - 1, 0))
            pending = _handoff(sends, recvs, group)
        if pending is not None:
            pending.wait()
    return outputs


def select_last_stage(x: torch.Tensor, axis_name: str,
                      ctx: MeshCtx) -> torch.Tensor:
    """Broadcast the last stage's value to every stage (masked sum)."""
    n_stage = ctx.axis_sizes.get(axis_name, 1)
    if n_stage == 1:
        return x
    mask = float(ctx.axis_index(axis_name) == n_stage - 1)
    return transport.all_reduce(x * mask, ctx.group(axis_name))
