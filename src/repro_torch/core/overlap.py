"""FSDP gather and transfer metering (port of ``repro.core.overlap``; the
gradient-bucketing helpers come with the managed collectives, ROADMAP
Queue 1 slice 4)."""

from __future__ import annotations

import torch

from repro_torch.parallel.sharding import MeshCtx


def fsdp_gather(w_shard: torch.Tensor, axis_name: str, ctx: MeshCtx, *,
                axis: int = 0, mode: str | None = None) -> torch.Tensor:
    """Gather an FSDP-sharded parameter (sharded on ``axis``) for use — the
    identity at axis size 1, where autograd's gradient is the identity too
    (the reference's as-ready reduce-scatter of the gradient)."""
    n = ctx.axis_sizes.get(axis_name, 1)
    if n == 1:
        return w_shard
    raise NotImplementedError(
        f"fsdp_gather over axis {axis_name!r} of size {n}: the "
        "torch.distributed collectives come with ROADMAP Queue 1 slice 4")


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
