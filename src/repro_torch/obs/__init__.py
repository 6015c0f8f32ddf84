"""repro_torch.obs — the tracer, the metrics registry, the Chrome-trace
export and the calibration ledger (port of ``repro.obs``).

* ``tracer``    — zero-dependency span/event tracer (bounded ring,
  thread-correct nesting, free when disabled);
* ``registry``  — one metrics registry (counters/gauges/histograms/EWMA/
  extrema) that serve/ builds on;
* ``export``    — Chrome-trace-event/Perfetto JSON (the reference's file
  format) with per-mesh-axis comm tracks + DecisionRecord instants, and
  the measured in-flight windows for mdmplint pass 4;
* ``calibrate`` — the predicted-vs-measured ledger joining
  DecisionRecords to spans, plus the Recalibrator that triggers
  re-resolution on sustained drift.
"""

from repro_torch.obs.calibrate import (CalibrationLedger, CalibrationSample,
                                       Recalibrator, chosen_predicted_s,
                                       cover_with)
from repro_torch.obs.export import (load_trace, measured_windows,
                                    to_chrome_trace, trace_tracks,
                                    write_chrome_trace)
from repro_torch.obs.registry import (Counter, Ewma, Extremum, Gauge,
                                      Histogram, MetricsRegistry)
from repro_torch.obs.tracer import (NULL, Instant, NullTracer, Span, Tracer,
                                    dispatch_span, get_tracer,
                                    install_tracer, use_tracer)

__all__ = [
    "CalibrationLedger", "CalibrationSample", "Recalibrator",
    "chosen_predicted_s", "cover_with",
    "load_trace", "measured_windows", "to_chrome_trace", "trace_tracks",
    "write_chrome_trace",
    "Counter", "Ewma", "Extremum", "Gauge", "Histogram",
    "MetricsRegistry",
    "NULL", "Instant", "NullTracer", "Span", "Tracer", "dispatch_span",
    "get_tracer", "install_tracer", "use_tracer",
]
