"""Chrome-trace-event / Perfetto export of a traced run (port of
``repro.obs.export``: the same file format, so either package's
``launch.trace`` reads a file the other wrote).

``to_chrome_trace`` turns a :class:`~repro_torch.obs.tracer.Tracer` plus the
run's DecisionRecords into the Trace Event Format dict that
chrome://tracing and https://ui.perfetto.dev open directly:

* one **track** (a named ``tid`` with a ``thread_name`` metadata event)
  per communication axis (``comm:data``, ``comm:stage``, ``comm:serve``,
  ...), plus ``compute``, ``serve``, ``ckpt`` and a ``decisions`` track;
* every span is a ``ph="X"`` complete event (``ts``/``dur`` in
  microseconds from the trace origin) with its attrs as ``args``;
* every DecisionRecord is a ``ph="i"`` instant on the ``decisions``
  track carrying the predicted seconds — side by side with the measured
  spans it will be calibrated against.

``measured_windows`` is the bridge to mdmplint pass 4: spans that carry
a ``buffer`` attr are measured in-flight windows, spans carrying
``reads``/``writes`` are measured buffer accesses — see
``analysis.graph.attach_trace``.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Sequence

from repro_torch.obs.tracer import Span, Tracer

#: export track for spans that declare neither ``track`` nor ``axis``
DEFAULT_TRACK = "compute"
DECISION_TRACK = "decisions"


def track_of(name: str, attrs: dict[str, Any]) -> str:
    """The export track for one span: explicit ``track`` attr wins, else
    an ``axis`` attr makes it a per-axis comm track, else compute."""
    t = attrs.get("track")
    if t:
        return str(t)
    ax = attrs.get("axis")
    if ax:
        return f"comm:{ax}"
    return DEFAULT_TRACK


def _decision_args(rec: Any) -> dict[str, Any]:
    return {
        "op": rec.op, "axis": rec.axis, "nbytes": rec.nbytes,
        "mode": rec.mode, "chunks": rec.chunks,
        "predicted_bulk_s": rec.predicted_bulk_s,
        "predicted_interleaved_s": rec.predicted_interleaved_s,
    }


def to_chrome_trace(tracer: Tracer, decisions: Sequence[Any] = (),
                    other_data: dict[str, Any] | None = None) -> dict:
    """Assemble the Trace Event Format dict.  Timestamps are rebased to
    the earliest event so the trace starts at ts=0."""
    spans = tracer.spans()
    instants = tracer.instants()
    stamped = [r for r in decisions if getattr(r, "t", None) is not None]

    origins = ([s.t0 for s in spans] + [i.t for i in instants]
               + [r.t for r in stamped])
    t_origin = min(origins, default=tracer.t_origin)

    # stable track -> tid mapping: decisions first, then sorted names
    tracks: dict[str, int] = {DECISION_TRACK: 0}
    names = sorted({track_of(s.name, s.attrs) for s in spans}
                   | {track_of(i.name, i.attrs) for i in instants})
    for n in names:
        tracks.setdefault(n, len(tracks))

    events: list[dict] = []
    for name, tid in tracks.items():
        events.append({"ph": "M", "pid": 0, "tid": tid,
                       "name": "thread_name", "args": {"name": name}})
    for s in spans:
        events.append({
            "ph": "X", "pid": 0, "tid": tracks[track_of(s.name, s.attrs)],
            "name": s.name, "ts": (s.t0 - t_origin) * 1e6,
            "dur": s.dur * 1e6, "args": dict(s.attrs, depth=s.depth)})
    for i in instants:
        events.append({
            "ph": "i", "s": "t", "pid": 0,
            "tid": tracks[track_of(i.name, i.attrs)],
            "name": i.name, "ts": (i.t - t_origin) * 1e6,
            "args": dict(i.attrs)})
    for rec in decisions:
        t = getattr(rec, "t", None)
        ts = (t - t_origin) * 1e6 if t is not None else 0.0
        events.append({
            "ph": "i", "s": "p", "pid": 0, "tid": tracks[DECISION_TRACK],
            "name": f"decision:{rec.op}", "ts": ts,
            "args": _decision_args(rec)})

    other = {"n_spans": tracer.n_spans, "dropped": tracer.dropped,
             "n_decisions": len(decisions)}
    if other_data:
        other.update(other_data)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_chrome_trace(path: str, tracer: Tracer,
                       decisions: Sequence[Any] = (),
                       other_data: dict[str, Any] | None = None) -> dict:
    doc = to_chrome_trace(tracer, decisions, other_data)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    assert isinstance(doc.get("traceEvents"), list), (
        f"{path}: not a Chrome trace (no traceEvents list)")
    return doc


def trace_tracks(doc: dict) -> dict[int, str]:
    """tid -> track name from the thread_name metadata events."""
    return {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}


# ---------------------------------------------------------------------------
# Measured in-flight windows for mdmplint pass 4
# ---------------------------------------------------------------------------


def measured_windows(spans: Iterable[Span]) -> tuple[
        list[tuple[str, float, float, str]],
        list[tuple[str, float, str, str]]]:
    """Extract (inflight, accesses) from a span stream, rebased so the
    earliest participating span starts at t=0.

    * A span with a ``buffer`` attr is a measured in-flight window on
      that buffer: ``(buffer, t0, t1, label)``.
    * A span with ``reads``/``writes`` attrs (str or sequence of str)
      yields one measured access per named buffer at the span midpoint:
      ``(buffer, t, "read"|"write", label)``.

    ``analysis.graph.attach_trace`` turns these into the typed
    ``InFlight``/``BufferAccess`` rows pass 4 checks — real windows
    instead of corpus-declared ones.
    """
    spans = list(spans)
    picked = [s for s in spans
              if s.attrs.get("buffer") or s.attrs.get("reads")
              or s.attrs.get("writes")]
    t_origin = min((s.t0 for s in picked), default=0.0)
    inflight: list[tuple[str, float, float, str]] = []
    accesses: list[tuple[str, float, str, str]] = []
    for s in picked:
        t0, t1 = s.t0 - t_origin, s.t1 - t_origin
        buf = s.attrs.get("buffer")
        if buf:
            inflight.append((str(buf), t0, t1, s.name))
        mid = 0.5 * (t0 + t1)
        for key, access in (("reads", "read"), ("writes", "write")):
            v = s.attrs.get(key)
            if not v:
                continue
            names = [v] if isinstance(v, str) else list(v)
            for b in names:
                accesses.append((str(b), mid, access, s.name))
    return inflight, accesses
