"""Transfer metering (port of ``repro.core.overlap``; the FSDP gather and
gradient-bucketing helpers come with the training slice)."""

from __future__ import annotations


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
