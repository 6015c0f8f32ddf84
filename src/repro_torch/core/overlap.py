"""As-ready gradient reduction, FSDP gathers and transfer metering (port
of ``repro.core.overlap``).

In a bulk-synchronous data-parallel step the gradient all-reduce happens
after the whole backward pass (the paper's Figure 2 phase separation).
The MDMP schedule fires each parameter's reduction the moment its
gradient is fully written.  With parameters gathered on use,

    w_full = fsdp_gather(w_shard, 'data', ctx)     # FSDP forward

autograd gives exactly that: the gradient of the managed all-gather is a
managed reduce-scatter, run in the layer's own backward.  This module
packages that pattern, the explicit all-reduce for replicated parameters,
a bucketing helper (the message-aggregation counter-knob), gradient
accumulation and the pooled overlap budget.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.managed import (get_config, managed_all_gather,
                                      managed_all_reduce,
                                      managed_reduce_scatter)
from repro_torch.parallel.sharding import MeshCtx


@dataclasses.dataclass
class OverlapAccount:
    """A SINGLE pooled overlap budget, in seconds of hideable compute.

    Per-subsystem resolution lets every op assume it can hide its wire
    under the adjacent compute — but on one device the compute stream
    hides the link ONCE, not once per op.  The whole-program planner opens
    one account per contention set, seeds it with the LARGEST single hide
    the set's interleaved knobs offer, and draws every op's wire from it;
    whatever doesn't fit is exposed serial link time."""
    budget_s: float
    drawn_s: float = 0.0

    @property
    def remaining_s(self) -> float:
        return max(0.0, self.budget_s - self.drawn_s)

    def draw(self, wire_s: float) -> float:
        """Hide as much of ``wire_s`` as the account still covers; returns
        the EXPOSED remainder (serial link seconds the step must pay)."""
        hidden = min(max(0.0, wire_s), self.remaining_s)
        self.drawn_s += hidden
        return max(0.0, wire_s) - hidden


def fsdp_gather(w_shard: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                axis: int = 0, mode: str | None = None) -> torch.Tensor:
    """Gather an FSDP-sharded parameter (sharded on ``axis``) for use.

    Its gradient is the as-ready reduce-scatter (bulk or ring to match
    ``mode``).  When ``MDMPConfig.fsdp_gather_dtype`` is set (e.g.
    'float8_e4m3fn'), the gathered payload is quantised per shard (absmax
    scale) while the gradient's reduce-scatter stays exact.  The identity
    at axis size 1."""
    if ctx.axis_sizes.get(axis_name, 1) == 1:
        return w_shard
    qdt = get_config().fsdp_gather_dtype
    if qdt and w_shard.dim() >= 2 and w_shard.numel() >= 1 << 16:
        return _FsdpGatherQ.apply(w_shard, axis_name, ctx, axis, mode, qdt)
    if axis == 0:
        return managed_all_gather(w_shard, axis_name, ctx, mode=mode)
    moved = w_shard.movedim(axis, 0)
    out = managed_all_gather(moved, axis_name, ctx, mode=mode)
    return out.movedim(0, axis)


class _FsdpGatherQ(torch.autograd.Function):
    """The quantised gather: an fp8 payload and one f32 scale per shard
    travel (as bytes), every block is dequantised by its own scale; the
    backward reduce-scatters the exact gradient."""

    @staticmethod
    def forward(fctx, w_shard, axis_name, ctx, axis, mode, qdt):
        fctx.args = (axis_name, ctx, axis, mode)
        moved = w_shard.movedim(axis, 0) if axis else w_shard
        qdtype = getattr(torch, qdt)
        fmax = float(torch.finfo(qdtype).max)
        scale = torch.clamp(moved.float().abs().amax(), min=1e-12) / fmax
        q = (moved.float() / scale).to(qdtype)
        qg = managed_all_gather(q.view(torch.uint8), axis_name, ctx,
                                mode=mode).view(qdtype)
        s_all = managed_all_gather(scale.reshape(1), axis_name, ctx,
                                   mode=mode)
        n, m = s_all.shape[0], moved.shape[0]
        blocks = qg.reshape((n, m) + tuple(qg.shape[1:])).float()
        deq = blocks * s_all.reshape((n,) + (1,) * (blocks.dim() - 1))
        out = deq.reshape(qg.shape).to(w_shard.dtype)
        return out.movedim(0, axis) if axis else out

    @staticmethod
    def backward(fctx, dy):
        axis_name, ctx, axis, mode = fctx.args
        moved = dy.movedim(axis, 0) if axis else dy
        g = managed_reduce_scatter(moved.contiguous(), axis_name, ctx,
                                   mode=mode)
        return (g.movedim(0, axis) if axis else g), None, None, None, \
            None, None


def fsdp_gather_tree(params: Any, axis_name: str, ctx: MeshCtx, *,
                     min_size: int = 1024, mode: str | None = None) -> Any:
    """Gather every FSDP-sharded leaf of a param tree.  Leaves smaller than
    ``min_size`` elements are taken as replicated and passed through."""
    def gather(w):
        if w.dim() >= 1 and w.numel() >= min_size:
            return fsdp_gather(w, axis_name, ctx, mode=mode)
        return w
    return pytree.tree_map(gather, params)


def reduce_replicated_grads(grads: Any, axis_names: Sequence[str],
                            ctx: MeshCtx, *, mean: bool = True) -> Any:
    """Bulk all-reduce (mean by default) of the gradients of replicated
    parameters (the leftovers that no fsdp_gather transpose reduces)."""
    denom = 1
    for ax in axis_names:
        denom *= ctx.axis_sizes.get(ax, 1)

    def red(g):
        for ax in axis_names:
            g = managed_all_reduce(g, ax, ctx)
        return g / denom if mean else g
    return pytree.tree_map(red, grads)


# ---------------------------------------------------------------------------
# Bucketed reduction — the message-aggregation baseline/knob
# ---------------------------------------------------------------------------


def bucketed_all_reduce(grads: Any, axis_name: str, ctx: MeshCtx, *,
                        bucket_bytes: int = 32 * 1024 * 1024,
                        mode: str | None = None) -> Any:
    """Flatten the grad tree into buckets of ~``bucket_bytes`` and reduce
    each bucket with one collective.  bucket_bytes=inf reproduces the
    single-bulk-message baseline; small buckets approach the paper's
    fine-grained per-datum messaging.

    Buckets are formed PER DTYPE, so a mixed tree keeps each leaf's exact
    type end to end (a bf16 leaf first must not drag f32 grads through
    bf16)."""
    leaves, spec = pytree.tree_flatten(grads)
    if not leaves:
        return grads
    groups: dict[torch.dtype, list[int]] = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    out: list[Any] = [None] * len(leaves)
    for dtype, idxs in groups.items():
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
        per_bucket = max(1, int(bucket_bytes // dtype.itemsize))
        red = torch.cat([managed_all_reduce(part, axis_name, ctx, mode=mode)
                         for part in flat.split(per_bucket)])
        off = 0
        for i in idxs:
            size = leaves[i].numel()
            out[i] = red[off:off + size].reshape(leaves[i].shape)
            off += size
    return pytree.tree_unflatten(out, spec)


def drain_chunk_bytes(step_s: float, write_bw: float, *,
                      budget: float = 0.1,
                      min_bytes: int = 1 << 16,
                      max_bytes: int = 1 << 27) -> int:
    """Chunk size for a device->host drain, metered under the overlap
    budget: each chunk's pull may stall the step stream for at most
    ``budget`` of one step's compute, so

        chunk_bytes = budget * step_s * write_bw

    The serving preemption path meters KV page swaps with it: a preempted
    request's page chain drains to host (and restores back) in chunks of
    this size (serve/engine.py; cost_model.decide_preempt prices the same
    chunking's alpha cost)."""
    want = int(max(0.0, budget) * max(step_s, 1e-6) * max(write_bw, 1.0))
    return max(min_bytes, min(max_bytes, want))


def grad_accumulate(step_grads_fn: Callable[[Any], tuple[Any, Any]],
                    microbatches: int, *, mean: bool = True
                    ) -> Callable[[Any], tuple[Any, Any]]:
    """Gradient accumulation: ``step_grads_fn(mb) -> (loss,
    grads)`` over ``microbatches`` stacked microbatches (leading axis).
    Returns a function of the stacked batch giving ``(mean_loss,
    mean_grads)`` with ``mean=True``, or ``(mean_loss, summed_grads)``
    with ``mean=False``."""
    def accumulate(stacked_batch):
        loss, grads = step_grads_fn(pytree.tree_map(lambda x: x[0],
                                                    stacked_batch))
        for i in range(1, microbatches):
            l, g = step_grads_fn(pytree.tree_map(lambda x: x[i],
                                                 stacked_batch))
            loss = loss + l
            grads = pytree.tree_map(torch.add, grads, g)
        scale = 1.0 / microbatches
        if mean:
            grads = pytree.tree_map(lambda g: g * scale, grads)
        return loss * scale, grads
    return accumulate
