"""mdmptrace — the zero-dependency span/event tracer (the SEVENTH managed
subsystem's sensor).

MDMP's contract is "implement communications optimally using information
provided by the user and data collected from instrumenting the code" —
this module is the *collecting* half at runtime granularity: every hot
path (serve quanta/swaps, pipeline ticks, halo exchange dispatches,
attention ring steps, MoE dispatch chunks, checkpoint snapshot/drain/
commit, planner resolution, lint preflight) opens a :class:`Span` under
the ambient tracer, and the exporters (``obs/export.py``) and the
calibration ledger (``obs/calibrate.py``) consume the resulting event
stream.

Design constraints, in order:

1.  **Disabled is free.**  The default ambient tracer is a shared
    :data:`NULL` singleton whose ``span()`` returns one reusable no-op
    context manager — no allocation beyond the kwargs dict at the call
    site, no clock reads, no list growth.  ``bench_trace_overhead``
    asserts the enabled path costs <2% of a step and the disabled path
    is bit-identical to untraced code.
2.  **Bounded.**  Events land in a ``deque(maxlen=capacity)`` ring so a
    week-long serve run cannot OOM the host; the drop count is kept.
3.  **Thread-correct.**  Span nesting is tracked per thread (the
    checkpoint writer thread emits drain/commit spans concurrently with
    the train loop), and the ambient tracer itself is installed on a
    thread-local exactly like ``managed.use_config`` — but with a
    process-wide default so worker threads spawned *after*
    ``install_tracer`` inherit it.

Spans carry free-form ``attrs``; the conventional keys the rest of the
repo reads are ``op`` (a ``managed.DECISION_OPS`` name — the calibration
join key), ``axis`` (mesh axis -> a per-axis comm track in the Chrome
export), ``nbytes``, ``scale`` (how many predicted units the span
covers: tokens for serve quanta, sweeps for halo, train-seconds for the
checkpoint cadence), ``buffer``/``reads``/``writes`` (measured
in-flight windows and accesses for mdmplint pass 4), and ``track`` (an
explicit export track override).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Iterator


@dataclasses.dataclass(frozen=True)
class Span:
    """One closed interval on the monotonic clock.  ``t0`` is seconds on
    ``time.perf_counter`` (shared origin across threads), ``dur`` its
    length, ``depth`` the nesting depth *within its thread* at open time
    (0 = top level)."""

    name: str
    t0: float
    dur: float
    depth: int
    tid: int
    attrs: dict[str, Any]

    @property
    def t1(self) -> float:
        return self.t0 + self.dur


@dataclasses.dataclass(frozen=True)
class Instant:
    """A zero-duration event (DecisionRecords export as these)."""

    name: str
    t: float
    tid: int
    attrs: dict[str, Any]


class _NullSpan:
    """The reusable no-op context manager the disabled path hands out."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every operation is a no-op, every query is
    empty.  ONE shared instance (:data:`NULL`) serves the whole process."""

    __slots__ = ()
    enabled = False

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **attrs: Any) -> None:
        return None

    def spans(self) -> list[Span]:
        return []

    def instants(self) -> list[Instant]:
        return []


NULL = NullTracer()


class _SpanCtx:
    """The live context manager: clocks on enter/exit, ring append on
    exit.  A plain class (not ``contextlib.contextmanager``) keeps the
    per-span overhead to two attribute writes and two clock reads."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_SpanCtx":
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        tr._stack().pop()
        tr._events.append(Span(
            name=self._name, t0=self._t0, dur=t1 - self._t0,
            depth=self._depth, tid=threading.get_ident(),
            attrs=self._attrs))
        tr.n_spans += 1
        return False

    def note(self, **attrs: Any) -> None:
        """Attach attrs discovered mid-span (e.g. bytes counted while
        draining) — must be called before ``__exit__``."""
        self._attrs.update(attrs)


class Tracer:
    """The live tracer: a bounded ring of :class:`Span`/:class:`Instant`
    events with per-thread nesting stacks."""

    enabled = True

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._events: deque[Span] = deque(maxlen=self.capacity)
        self._instants: deque[Instant] = deque(maxlen=self.capacity)
        self._local = threading.local()
        self.t_origin = time.perf_counter()
        self.n_spans = 0              # total ever opened (ring may drop)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        """``with tracer.span("serve.quantum", op="serve_schedule",
        axis="serve", nbytes=..., scale=tokens): ...``"""
        return _SpanCtx(self, name, attrs)

    def instant(self, name: str, **attrs: Any) -> None:
        self._instants.append(Instant(
            name=name, t=time.perf_counter(),
            tid=threading.get_ident(), attrs=attrs))

    # -- queries -------------------------------------------------------------

    def spans(self) -> list[Span]:
        return list(self._events)

    def instants(self) -> list[Instant]:
        return list(self._instants)

    @property
    def dropped(self) -> int:
        """Spans the ring evicted (0 unless the run outgrew capacity)."""
        return max(0, self.n_spans - len(self._events))

    def clear(self) -> None:
        self._events.clear()
        self._instants.clear()
        self.n_spans = 0


# ---------------------------------------------------------------------------
# Ambient tracer — thread-local override over a process-wide default, the
# same shape as managed.use_config / managed.install_plan.
# ---------------------------------------------------------------------------

_STATE = threading.local()
_DEFAULT: NullTracer | Tracer = NULL


def get_tracer() -> NullTracer | Tracer:
    """The ambient tracer for this thread (:data:`NULL` unless one was
    installed) — the ONE call every instrumentation site makes."""
    tr = getattr(_STATE, "tracer", None)
    return tr if tr is not None else _DEFAULT


def install_tracer(tracer: NullTracer | Tracer | None) -> None:
    """Install (or clear, with None) the process-wide default tracer —
    the launcher entry point.  Worker threads (the checkpoint writer)
    see it without any per-thread setup."""
    global _DEFAULT
    _DEFAULT = tracer if tracer is not None else NULL


class use_tracer:
    """``with obs.use_tracer(Tracer()) as tr: ...`` — scoped, this
    thread only (tests; the launchers use :func:`install_tracer`)."""

    def __init__(self, tracer: NullTracer | Tracer | None):
        self._new = tracer if tracer is not None else NULL

    def __enter__(self) -> NullTracer | Tracer:
        self._old = getattr(_STATE, "tracer", None)
        _STATE.tracer = self._new
        return self._new

    def __exit__(self, *exc: Any) -> None:
        _STATE.tracer = self._old


def iter_spans(tracer: Tracer, name_prefix: str = "") -> Iterator[Span]:
    for s in tracer.spans():
        if s.name.startswith(name_prefix):
            yield s


def dispatch_span(name: str, operand: Any = None, **attrs: Any):
    """A span at a possibly-compiled dispatch boundary (halo solves,
    ring attention, expert streams, pipeline scans).

    While ``torch.compile`` traces the body it is not being RUN: the span
    still lands (it marks the dispatch in the timeline and measures trace
    time) but is tagged ``jit=True`` so the calibration ledger excludes it
    from measured ratios.  In eager execution the span is a real runtime
    measurement.  ``operand`` is kept for the reference's call signature;
    the check needs only the compiler's state."""
    tr = get_tracer()
    if not tr.enabled:
        return _NULL_SPAN
    import torch
    if torch.compiler.is_compiling():
        attrs["jit"] = True
    return tr.span(name, **attrs)
