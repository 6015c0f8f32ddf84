"""repro_torch.obs — the tracer, the metrics registry and the calibration
ledger (port of ``repro.obs``; the Chrome-trace exporter comes with the
tracing slice).

* ``tracer``    — zero-dependency span/event tracer (bounded ring,
  thread-correct nesting, free when disabled);
* ``registry``  — one metrics registry (counters/gauges/histograms/EWMA/
  extrema) that serve/ builds on;
* ``calibrate`` — the predicted-vs-measured ledger joining
  DecisionRecords to spans, plus the Recalibrator that triggers
  re-resolution on sustained drift.
"""

from repro_torch.obs.calibrate import (CalibrationLedger, CalibrationSample,
                                       Recalibrator, chosen_predicted_s,
                                       cover_with)
from repro_torch.obs.registry import (Counter, Ewma, Extremum, Gauge,
                                      Histogram, MetricsRegistry)
from repro_torch.obs.tracer import (NULL, Instant, NullTracer, Span, Tracer,
                                    dispatch_span, get_tracer,
                                    install_tracer, use_tracer)

__all__ = [
    "CalibrationLedger", "CalibrationSample", "Recalibrator",
    "chosen_predicted_s", "cover_with",
    "Counter", "Ewma", "Extremum", "Gauge", "Histogram",
    "MetricsRegistry",
    "NULL", "Instant", "NullTracer", "Span", "Tracer", "dispatch_span",
    "get_tracer", "install_tracer", "use_tracer",
]
