"""The predicted-vs-measured calibration ledger.

Every managed decision logs a DecisionRecord with *predicted* seconds;
every instrumented hot path emits spans with *measured* seconds.  This
module joins the two on ``(op, axis)`` and maintains per-op residual
ratios ``measured / predicted`` — the number that says whether the cost
model's terms are right, per term:

* ratio ~ 1.0: the model is calibrated, trust its mode choices;
* ratio >> 1: the model is optimistic (a bandwidth/latency term too
  high, an overhead term missing) — the chosen mode may be wrong;
* ratio << 1: the model is pessimistic — it may be leaving faster
  interleavings on the table.

``CalibrationLedger.report()`` names the term behind each op (via
:data:`TERM_HINTS`) and flags ops outside tolerance.  ``Recalibrator``
is the *actuator*: it generalizes the two one-off drift hacks the repo
grew — ServeEngine's "re-resolve once after 3 quanta" warmup retune and
TrainLoop's "re-resolve when the step EWMA drifts >25% off the resolved
baseline" — into one policy object both now use.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Iterable, Sequence

from repro_torch.obs.registry import Ewma
from repro_torch.obs.tracer import Span

#: ops whose resolve_* entry point stores the CHOSEN prediction in
#: ``predicted_interleaved_s`` (the generic ``_resolve`` call sites store
#: bulk-vs-interleaved candidate times instead, so the chosen one depends
#: on the recorded mode)
RESOLVER_OPS = frozenset({
    "halo_aggregation", "attention_schedule", "pipeline_schedule",
    "serve_schedule", "preempt_policy", "ckpt_interval", "moe_dispatch",
})

#: which cost-model term each op's residual ratio indicts — the names a
#: human greps for in core/cost_model.py when the report flags an op
TERM_HINTS = {
    "halo_aggregation": "halo wire/sweep terms (decide_halo_aggregation)",
    "attention_schedule": "attention roofline (decide_attention_schedule)",
    "pipeline_schedule": "stage handoff/bubble terms "
                         "(decide_pipeline_schedule)",
    "serve_schedule": "serve step roofline (decide_serve_schedule)",
    "preempt_policy": "PCIe swap bw / replay terms (decide_preempt)",
    "ckpt_interval": "Young/Daly overhead terms (decide_checkpoint)",
    "moe_dispatch": "a2a dispatch terms (decide_moe_dispatch)",
    "program_plan": "joint contention model (plan_program)",
    "lint": "static preflight (no runtime term)",
    "ring_attention": "ring permute/flash overlap terms",
    "expert_stream": "expert ring stream terms",
}


def chosen_predicted_s(rec: Any) -> float:
    """The prediction for the mode the decision actually chose."""
    if rec.op in RESOLVER_OPS or rec.mode != "bulk":
        return float(rec.predicted_interleaved_s)
    return float(rec.predicted_bulk_s)


@dataclasses.dataclass
class CalibrationSample:
    op: str
    axis: str
    predicted_s: float        # chosen prediction, per unit
    measured_s: float         # sum(dur)/sum(scale) over matching spans
    n_spans: int
    #: True when the spans measure THIS op directly; False when the op
    #: is merely covered by an enclosing span (a jitted train step
    #: declaring the collectives compiled into it via an ``ops=`` attr).
    #: Covering samples count for correlation coverage but make no
    #: per-op ratio claim — runtime inside one XLA program cannot be
    #: attributed per collective from the host.
    attributed: bool = True

    @property
    def ratio(self) -> float:
        if self.predicted_s <= 0:
            return float("inf") if self.measured_s > 0 else 1.0
        return self.measured_s / self.predicted_s


def cover_with(spans: Iterable[Span], span_name: str,
               ops: Iterable[str]) -> int:
    """Declare that every ``span_name`` span *covers* ``ops`` — decisions
    for collectives compiled INTO that span's XLA program (their own
    dispatch_span fired at trace time, tagged jit).  Correlation then
    counts those decisions as covered (coverage) without claiming a
    per-op ratio.  Returns the number of spans annotated."""
    ops = sorted(set(ops))
    n = 0
    for s in spans:
        if s.name == span_name and "ops" not in s.attrs:
            s.attrs["ops"] = ops
            n += 1
    return n


@dataclasses.dataclass
class CalibrationLedger:
    """Join DecisionRecords to measured spans and keep per-(op, axis)
    residual ratios."""

    tolerance: float = 0.25
    samples: list[CalibrationSample] = dataclasses.field(
        default_factory=list)
    uncorrelated: list[Any] = dataclasses.field(default_factory=list)
    n_decisions: int = 0

    def correlate(self, spans: Iterable[Span],
                  decisions: Sequence[Any]) -> None:
        """One pass: pool measured spans by their ``op`` attr (and
        ``axis`` when present), then attach each decision to its pool.
        Pooling (rather than 1:1 matching) is deliberate: a re-resolved
        op contributes ALL its spans to the calibration of every
        decision about it — the ledger measures the model, not one
        quantum."""
        by_key: dict[tuple[str, str | None], list[Span]] = defaultdict(list)
        covered: dict[str, list[Span]] = defaultdict(list)
        for s in spans:
            if s.attrs.get("jit"):
                # fired while a compiler traced, dur measures tracing not the
                # collective — structural only, never a calibration input
                continue
            for cov in s.attrs.get("ops", ()):
                covered[str(cov)].append(s)
            op = s.attrs.get("op")
            if not op:
                continue
            by_key[(str(op), None)].append(s)
            ax = s.attrs.get("axis")
            if ax:
                by_key[(str(op), str(ax))].append(s)
        for rec in decisions:
            self.n_decisions += 1
            pool = by_key.get((rec.op, rec.axis)) \
                or by_key.get((rec.op, None))
            if pool:
                dur = sum(s.dur for s in pool)
                scale = sum(float(s.attrs.get("scale", 1.0)) for s in pool)
                self.samples.append(CalibrationSample(
                    op=rec.op, axis=rec.axis,
                    predicted_s=chosen_predicted_s(rec),
                    measured_s=dur / max(scale, 1e-30), n_spans=len(pool)))
                continue
            cover = covered.get(rec.op)
            if cover:
                self.samples.append(CalibrationSample(
                    op=rec.op, axis=rec.axis,
                    predicted_s=chosen_predicted_s(rec),
                    measured_s=0.0, n_spans=len(cover),
                    attributed=False))
                continue
            self.uncorrelated.append(rec)

    # -- aggregates ----------------------------------------------------------

    def coverage(self) -> float:
        """Fraction of decisions correlated to at least one measured
        span (the >=90% acceptance bar)."""
        if self.n_decisions == 0:
            return 1.0
        return len(self.samples) / self.n_decisions

    def ratios(self) -> dict[tuple[str, str], float]:
        """(op, axis) -> mean residual ratio over finite samples."""
        acc: dict[tuple[str, str], list[float]] = defaultdict(list)
        for s in self.samples:
            if not s.attributed:
                continue
            r = s.ratio
            if r != float("inf"):
                acc[(s.op, s.axis)].append(r)
        return {k: sum(v) / len(v) for k, v in acc.items() if v}

    def miscalibrated(self) -> dict[tuple[str, str], float]:
        return {k: r for k, r in self.ratios().items()
                if abs(r - 1.0) > self.tolerance}

    def report(self) -> str:
        """Human trail, one line per (op, axis): predicted vs measured
        per-unit seconds, the residual ratio, and — when flagged — which
        cost-model term is off and by how much."""
        lines = [f"calibration: {len(self.samples)}/{self.n_decisions} "
                 f"decisions correlated "
                 f"(coverage {self.coverage() * 100:.0f}%)"]
        per_key: dict[tuple[str, str], list[CalibrationSample]] = \
            defaultdict(list)
        for s in self.samples:
            per_key[(s.op, s.axis)].append(s)
        for (op, axis), ss in sorted(per_key.items()):
            direct = [x for x in ss if x.attributed]
            if not direct:
                lines.append(f"  {op}[{axis}] n={len(ss)} COVERED by an "
                             f"enclosing span (no per-op ratio)")
                continue
            ss = direct
            pred = sum(x.predicted_s for x in ss) / len(ss)
            meas = sum(x.measured_s for x in ss) / len(ss)
            finite = [x.ratio for x in ss if x.ratio != float("inf")]
            if not finite:
                lines.append(f"  {op}[{axis}] n={len(ss)} predicted=0 "
                             f"measured={meas:.3e}s UNPRICED")
                continue
            ratio = sum(finite) / len(finite)
            line = (f"  {op}[{axis}] n={len(ss)} "
                    f"predicted={pred:.3e}s measured={meas:.3e}s "
                    f"ratio={ratio:.2f}")
            if abs(ratio - 1.0) > self.tolerance:
                pct = (ratio - 1.0) * 100
                term = TERM_HINTS.get(op, "unmapped term")
                line += (f" MISCALIBRATED({pct:+.0f}%) -> {term}")
            lines.append(line)
        if self.uncorrelated:
            ops = sorted({r.op for r in self.uncorrelated})
            lines.append(f"  uncorrelated: {len(self.uncorrelated)} "
                         f"decisions ({', '.join(ops)})")
        return "\n".join(lines)

    def snapshot(self) -> dict:
        """Plain-data view, embedded in the trace's otherData so the CLI
        can re-print the ledger from the file alone."""
        return {
            "coverage": self.coverage(),
            "ratios": {f"{op}[{axis}]": r
                       for (op, axis), r in sorted(self.ratios().items())},
            "miscalibrated": {f"{op}[{axis}]": r for (op, axis), r
                              in sorted(self.miscalibrated().items())},
        }


class Recalibrator:
    """When should a managed knob be re-resolved?  ONE policy for what
    used to be two hand-rolled hacks:

    * **warmup**: fire once as soon as ``warmup`` measurements exist and
      nothing was ever resolved from measurements (ServeEngine's
      "re-resolve after 3 quanta");
    * **sustained drift**: fire whenever the measurement EWMA deviates
      from the value the knob was last resolved against by more than
      ``threshold`` (TrainLoop's ">25% off the resolved step time").

    The caller feeds measurements via :meth:`note` and asks
    :meth:`should_retune`; after actually re-resolving it calls
    :meth:`rebase` with the value it resolved against.
    """

    def __init__(self, threshold: float = 0.25, warmup: int = 3,
                 alpha: float = 0.9):
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self.ewma = Ewma(alpha)
        self.baseline: float | None = None
        self.retunes = 0

    def note(self, measured: float) -> None:
        self.ewma.update(measured)

    @property
    def value(self) -> float | None:
        return self.ewma.value

    def should_retune(self) -> bool:
        if self.ewma.count == 0:
            return False
        if self.baseline is None:
            # never resolved from measurements: fire at warmup
            return self.ewma.count >= self.warmup
        return self.ewma.drift_frac(self.baseline) > self.threshold

    def rebase(self, resolved_against: float | None = None) -> None:
        """Record that a re-resolution happened (against the EWMA unless
        an explicit value is given)."""
        self.baseline = (self.ewma.value if resolved_against is None
                         else float(resolved_against))
        self.retunes += 1
