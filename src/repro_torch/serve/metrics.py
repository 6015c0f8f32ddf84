"""Serving instrumentation — the runtime counters the scheduler plans from.

MDMP's contract is that iteration k's measured behaviour schedules
iteration k+1.  For serving the "iteration" is one dispatched quantum of
C engine steps: every quantum records its wall clock and how many
slot-steps did useful work, and the per-request traces record TTFT/TPOT.
``step_s_estimate`` / ``dispatch_s_estimate`` invert the quantum model
``wall = dispatch + C * step`` from those records; the scheduler feeds
them back into ``cost_model.decide_serve_schedule`` (via
``managed.resolve_serve_schedule(measured_*)``) to correct the modeled
roofline terms online.

The overload path adds three more instruments, all feeding the preempt/
shed decisions the same way: ``sheds`` (typed admission rejections and
their reasons), ``preempts`` (the victim/policy sequence — the
determinism tests compare it across runs), and ``swaps`` (measured D2H/
H2D bytes and seconds, whose ratio is the MEASURED PCIe bandwidth
``swap_bw_estimate`` that re-prices the swap-vs-recompute decision).
``p99_ttft_s`` / ``slo_met_tokens`` are the robustness headline numbers
(the overload benchmark, to be ported).
"""

from __future__ import annotations

import dataclasses
import math
import time

from repro_torch.obs.registry import MetricsRegistry


@dataclasses.dataclass
class RequestTrace:
    rid: int
    submit_s: float
    n_prompt: int
    n_new: int
    first_token_s: float | None = None
    done_s: float | None = None
    generated: int = 0


@dataclasses.dataclass(frozen=True)
class QuantumRecord:
    wall_s: float
    chunk: int               # C — engine steps dispatched per slot
    useful_steps: int        # sum over slots of steps that advanced a slot
    slots: int


class ServeMetrics:
    """Counters and estimators ride the unified ``obs.MetricsRegistry``
    (one registry per ServeMetrics); the record lists (``quanta``,
    ``sheds``, ``preempts``) stay — the determinism tests compare their
    sequences, and the variant-window estimators slice them."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self._t0 = time.perf_counter()
        self.reg = registry if registry is not None else MetricsRegistry()
        self.quanta: list[QuantumRecord] = []
        self.traces: dict[int, RequestTrace] = {}
        self.sheds: list[tuple[int, str]] = []      # (rid, reason)
        self.preempts: list[tuple[int, str]] = []   # (rid, policy)
        self._swap_bytes = self.reg.counter("serve.swap_bytes")
        self._swap_s = self.reg.counter("serve.swap_s")
        # "the min is the noise-robust estimator on a shared host"
        self._step_min = self.reg.extremum("serve.step_s", kind="min")
        self._quantum_wall = self.reg.histogram("serve.quantum_wall_s")

    # registry-backed counters, exposed under their historical names
    @property
    def swap_bytes(self) -> int:
        return int(self._swap_bytes.value)

    @property
    def swap_s(self) -> float:
        return float(self._swap_s.value)

    def now(self) -> float:
        return time.perf_counter() - self._t0

    # -- recording -----------------------------------------------------------

    def on_submit(self, rid: int, n_prompt: int, n_new: int) -> None:
        self.traces[rid] = RequestTrace(rid=rid, submit_s=self.now(),
                                        n_prompt=n_prompt, n_new=n_new)

    def on_first_token(self, rid: int) -> None:
        t = self.traces[rid]
        if t.first_token_s is None:
            t.first_token_s = self.now()

    def on_generated(self, rid: int, n: int = 1) -> None:
        self.traces[rid].generated += n

    def on_done(self, rid: int) -> None:
        self.traces[rid].done_s = self.now()

    def on_shed(self, rid: int, reason: str) -> None:
        """An admission rejection (queue_full / slo / infeasible)."""
        self.sheds.append((rid, reason))
        self.reg.counter(f"serve.shed.{reason}").add()

    def on_preempt(self, rid: int, policy: str) -> None:
        """A preemption event — the (victim, policy) sequence is the
        determinism contract of the overload fault kinds."""
        self.preempts.append((rid, policy))
        self.reg.counter(f"serve.preempt.{policy}").add()

    def note_swap(self, nbytes: int, seconds: float) -> None:
        """One swap transfer leg (D2H or H2D) — accumulates the measured
        PCIe bandwidth that re-prices decide_preempt online."""
        self._swap_bytes.add(int(nbytes))
        self._swap_s.add(float(seconds))

    def note_quantum(self, wall_s: float, chunk: int, useful_steps: int,
                     slots: int) -> None:
        self.quanta.append(QuantumRecord(wall_s, chunk, useful_steps,
                                         slots))
        self._step_min.observe(wall_s / max(1, chunk))
        self._quantum_wall.observe(wall_s)

    def rebase_pending(self) -> None:
        """Move not-yet-served requests' submit times to 'now' — called
        after warmup so TTFT measures scheduling, not kernel builds."""
        now = self.now()
        for t in self.traces.values():
            if t.first_token_s is None:
                t.submit_s = max(t.submit_s, now)

    # -- estimates fed back into the cost model ------------------------------

    def step_s_estimate(self) -> float | None:
        """Per-engine-step seconds (whole batch): running min over quanta
        of wall/C (an ``obs.registry.Extremum``) — the min is the
        noise-robust estimator on a shared host and absorbs the least
        dispatch overhead."""
        return self._step_min.value

    def dispatch_s_estimate(self) -> float | None:
        """Per-quantum overhead left after charging C * step_s."""
        step = self.step_s_estimate()
        if step is None or len(self.quanta) < 2:
            return None
        rest = sorted(max(0.0, q.wall_s - q.chunk * step)
                      for q in self.quanta)
        return rest[len(rest) // 2]

    def swap_bw_estimate(self) -> float | None:
        """Measured swap bandwidth (bytes/s over all transfer legs) —
        the PCIe term of the swap-vs-recompute decision, measured."""
        if self.swap_bytes <= 0 or self.swap_s <= 0:
            return None
        return self.swap_bytes / self.swap_s

    # -- aggregates ----------------------------------------------------------

    def useful_tokens_per_s(self, since: int = 0) -> float:
        """Useful slot-steps per wall second over ``quanta[since:]`` —
        pass the index where the current schedule variant started so a
        variant is only credited with its own quanta."""
        window = self.quanta[since:]
        wall = sum(q.wall_s for q in window)
        if wall <= 0:
            return 0.0
        return sum(q.useful_steps for q in window) / wall

    def occupancy(self) -> float:
        denom = sum(q.chunk * q.slots for q in self.quanta)
        if denom <= 0:
            return 0.0
        return sum(q.useful_steps for q in self.quanta) / denom

    def ttft_s(self) -> list[float]:
        return [t.first_token_s - t.submit_s for t in self.traces.values()
                if t.first_token_s is not None]

    def p99_ttft_s(self) -> float:
        xs = sorted(self.ttft_s())
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, max(0, math.ceil(0.99 * len(xs)) - 1))]

    def tpot_s(self) -> list[float]:
        out = []
        for t in self.traces.values():
            if t.done_s is not None and t.first_token_s is not None \
                    and t.generated > 1:
                out.append((t.done_s - t.first_token_s)
                           / (t.generated - 1))
        return out

    def slo_met_tokens(self, slo_ttft_s: float) -> int:
        """Tokens generated by COMPLETED requests whose TTFT met the SLO
        — the numerator of SLO-goodput (met tokens / wall second)."""
        tot = 0
        for t in self.traces.values():
            if t.done_s is not None and t.first_token_s is not None \
                    and (t.first_token_s - t.submit_s) <= slo_ttft_s:
                tot += t.generated
        return tot

    def summary(self) -> dict:
        ttft = self.ttft_s()
        tpot = self.tpot_s()
        return {
            "quanta": len(self.quanta),
            "useful_tok_s": self.useful_tokens_per_s(),
            "occupancy": self.occupancy(),
            "mean_ttft_s": sum(ttft) / len(ttft) if ttft else 0.0,
            "p99_ttft_s": self.p99_ttft_s(),
            "mean_tpot_s": sum(tpot) / len(tpot) if tpot else 0.0,
            "step_s": self.step_s_estimate() or 0.0,
            "dispatch_s": self.dispatch_s_estimate() or 0.0,
            "sheds": len(self.sheds),
            "preempts": len(self.preempts),
            "swap_bytes": self.swap_bytes,
        }
