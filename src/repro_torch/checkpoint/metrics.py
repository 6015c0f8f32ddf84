"""Checkpoint instrumentation — the runtime counters the cadence is
planned from (port of ``repro.checkpoint.metrics``).

Same contract as ``serve/metrics.py``: iteration k's measured behaviour
schedules iteration k+1.  For checkpointing the "iteration" is one async
save: every save records how long the on-device snapshot blocked the
loop, how long the chunked D2H drain took, how long the writer thread
spent on disk, and the snapshot bytes.  ``write_bw_estimate`` /
``ckpt_cost_s_estimate`` invert those records into the δ (per-checkpoint
cost) and bandwidth terms of the Young/Daly model; ``TrainLoop`` feeds
them back into ``managed.resolve_checkpoint`` to re-resolve the cadence
as the EWMA step time drifts.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.registry import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class SaveRecord:
    step: int
    nbytes: int
    snapshot_s: float        # on-device donated-copy dispatch (loop-blocking)
    drain_s: float           # chunked device->host transfer (writer thread)
    write_s: float           # serialisation + atomic commit (writer thread)


@dataclasses.dataclass(frozen=True)
class RestoreRecord:
    step: int
    restore_s: float


class CheckpointMetrics:
    """Estimators ride the unified ``obs.MetricsRegistry``; the record
    lists stay for tests and the summary's byte count."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.reg = registry if registry is not None else MetricsRegistry()
        self.saves: list[SaveRecord] = []
        self.restores: list[RestoreRecord] = []
        # max-rate / min-cost: "a slow save means contention, not a
        # slower disk" — the noise-robust estimators as registry extrema
        self._write_bw = self.reg.extremum("ckpt.write_bw", kind="max")
        self._cost = self.reg.extremum("ckpt.cost_s", kind="min")
        self._restore = self.reg.extremum("ckpt.restore_s", kind="min")

    # -- recording -----------------------------------------------------------

    def note_save(self, step: int, nbytes: int, snapshot_s: float,
                  drain_s: float, write_s: float) -> None:
        self.saves.append(SaveRecord(step, nbytes, snapshot_s, drain_s,
                                     write_s))
        if drain_s + write_s > 0:
            self._write_bw.observe(nbytes / (drain_s + write_s))
        self._cost.observe(snapshot_s + drain_s)

    def note_restore(self, step: int, restore_s: float) -> None:
        self.restores.append(RestoreRecord(step, restore_s))
        self._restore.observe(restore_s)

    # -- estimates fed back into the cost model ------------------------------

    def write_bw_estimate(self) -> float | None:
        """Measured end-to-end checkpoint bandwidth, bytes/s: running max
        over saves of nbytes / (drain + write)."""
        return self._write_bw.value

    def ckpt_cost_s_estimate(self) -> float | None:
        """δ of the Young/Daly model: the per-checkpoint seconds the run
        actually pays (snapshot block + the metered drain; the disk write
        rides the writer thread off the critical path) — running min."""
        return self._cost.value

    def restore_s_estimate(self) -> float | None:
        return self._restore.value

    # -- aggregates ----------------------------------------------------------

    def summary(self) -> dict:
        return {
            "saves": len(self.saves),
            "restores": len(self.restores),
            "bytes": self.saves[-1].nbytes if self.saves else 0,
            "write_bw": self.write_bw_estimate() or 0.0,
            "ckpt_cost_s": self.ckpt_cost_s_estimate() or 0.0,
            "restore_s": self.restore_s_estimate() or 0.0,
        }
