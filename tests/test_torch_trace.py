"""The port's Chrome-trace export (``repro_torch.obs.export``) and trace
CLI (``repro_torch.launch.trace``) held against the reference's:

  * the same spans, instants and DecisionRecords export to the same Trace
    Event Format document, and the calibration snapshot rides along;
  * a trace the port wrote is loaded, summarised and diffed by the
    reference's ``repro.launch.trace`` exactly as by the port's, and a
    trace the reference wrote by the port's;
  * ``measured_windows`` and ``attach_trace`` turn measured spans into
    pass 4's rows and flip the overlap diagnostic (the reference's
    ``test_obs.py:354``).
"""

import contextlib
import io
import json

import pytest

from repro.core import managed as ref_managed
from repro.launch import trace as ref_trace_cli
from repro.obs import export as ref_export
from repro.obs import tracer as ref_tracer
from repro_torch import obs
from repro_torch.analysis import attach_trace, check_overlap
from repro_torch.analysis.graph import CommGraph
from repro_torch.core import managed
from repro_torch.launch import trace as trace_cli
from repro_torch.obs import export
from repro_torch.obs.tracer import Instant, Span


class _Ring:
    """A tracer's read side over fixed spans (both packages' exporters
    read only these members)."""

    def __init__(self, spans, instants=(), t_origin=0.0):
        self._spans, self._instants = list(spans), list(instants)
        self.t_origin, self.n_spans, self.dropped = t_origin, len(spans), 0

    def spans(self):
        return list(self._spans)

    def instants(self):
        return list(self._instants)


SPANS = [("train.step", 1.0, 0.5, {"track": "compute", "step": 0}),
         ("train.step", 1.6, 0.4, {"track": "compute", "step": 1}),
         ("mdmp.all_gather", 1.1, 0.1, {"axis": "data", "op": "all_gather",
                                        "nbytes": 4096}),
         ("serve.swap_out", 2.0, 1.0, {"buffer": "kv_pages"}),
         ("serve.quantum", 2.25, 0.25, {"reads": "kv_pages",
                                        "track": "serve"}),
         ("lint.preflight", 0.9, 0.01, {"op": "lint", "track": "lint"})]


def _spans(mod):
    return [mod.Span(name=n, t0=t0, dur=d, depth=0, tid=0, attrs=dict(a))
            for n, t0, d, a in SPANS]


def _decisions(mod):
    recs = [mod.DecisionRecord(op="all_gather", axis="data", nbytes=4096,
                               mode="bulk", chunks=1, predicted_bulk_s=1e-4,
                               predicted_interleaved_s=2e-4),
            mod.DecisionRecord(op="program_plan", axis="data2", nbytes=8,
                               mode="local", chunks=1, predicted_bulk_s=0.0,
                               predicted_interleaved_s=0.0)]
    for i, r in enumerate(recs):
        object.__setattr__(r, "t", 1.05 + i)
    return recs


def test_chrome_trace_equals_reference():
    got = export.to_chrome_trace(
        _Ring(_spans(obs), [Instant("mark", 1.2, 0, {"axis": "data"})]),
        _decisions(managed), other_data={"run": "t"})
    want = ref_export.to_chrome_trace(
        _Ring(_spans(ref_tracer),
              [ref_tracer.Instant("mark", 1.2, 0, {"axis": "data"})]),
        _decisions(ref_managed), other_data={"run": "t"})
    assert got == want
    assert export.trace_tracks(got) == ref_export.trace_tracks(want)
    assert export.track_of("x", {"axis": "pod"}) == "comm:pod"


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _write(writer, ring, decisions, path):
    cal = {"coverage": 0.5, "ratios": {"all_gather[data]": 2.0},
           "miscalibrated": {"all_gather[data]": 1.0}}
    writer(str(path), ring, decisions,
           other_data={"run": "train:t", "calibration": cal})


def test_traces_cross_read_between_packages(tmp_path):
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    _write(export.write_chrome_trace, _Ring(_spans(obs)),
           _decisions(managed), port_path)
    _write(ref_export.write_chrome_trace, _Ring(_spans(ref_tracer)),
           _decisions(ref_managed), ref_path)
    assert json.loads(port_path.read_text()) == \
        json.loads(ref_path.read_text())
    for path in (port_path, ref_path):
        got = _cli(trace_cli.main, [str(path)])
        want = _cli(ref_trace_cli.main, [str(path)])
        assert got == want and got[0] == 0
        assert "MISCALIBRATED" in got[1] and "train.step" in got[1]
    for a, b in ((port_path, ref_path), (ref_path, port_path)):
        got = _cli(trace_cli.main, ["--diff", str(a), str(b)])
        assert got == _cli(ref_trace_cli.main, ["--diff", str(a), str(b)])
        assert got[0] == 0
    # a regressed hot path fails the diff in both packages
    slow = [Span(n, t0, d * (3 if n == "train.step" else 1), 0, 0, dict(a))
            for n, t0, d, a in SPANS]
    slow_path = tmp_path / "slow.json"
    export.write_chrome_trace(str(slow_path), _Ring(slow))
    for main in (trace_cli.main, ref_trace_cli.main):
        rc, out = _cli(main, ["--diff", str(ref_path), str(slow_path)])
        assert rc == 1 and "REGRESSED" in out
    with pytest.raises(AssertionError):
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        export.load_trace(str(bad))


def test_measured_windows_equal_reference():
    got = export.measured_windows(_spans(obs))
    want = ref_export.measured_windows(_spans(ref_tracer))
    assert got == want
    inflight, accesses = got
    # rebased on the earliest span that carries a buffer attr
    assert inflight == [("kv_pages", 0.0, 1.0, "serve.swap_out")]
    assert accesses == [("kv_pages", 0.375, "read", "serve.quantum")]


def test_attach_trace_flips_overlap_diagnostic():
    g = CommGraph(name="t", axis_sizes={})
    assert check_overlap(g) == []
    g2 = attach_trace(g, [
        Span("serve.swap_out", 0.0, 1.0, 0, 0, {"buffer": "kv_pages"}),
        Span("serve.quantum", 0.25, 0.25, 0, 0, {"reads": "kv_pages"})])
    assert [d.code for d in check_overlap(g2)] == ["MDMP401"]
    assert check_overlap(g) == []
    g3 = attach_trace(g, [
        Span("serve.swap_in", 0.0, 1.0, 0, 0, {"buffer": "kv_pages"}),
        Span("decode", 0.25, 0.25, 0, 0, {"writes": ["kv_pages"]})])
    assert [d.code for d in check_overlap(g3)] == ["MDMP402"]
    g4 = attach_trace(g3, [Span("late", 2.0, 0.1, 0, 0,
                                {"reads": "kv_pages"})], replace=False)
    assert len(g4.accesses) == 2 and len(g4.inflight) == 1


def test_live_tracer_exports_and_summarises(tmp_path):
    """A real Tracer's spans with a decision logged inside them."""
    tr = obs.Tracer()
    with obs.use_tracer(tr):
        managed.clear_decision_log()
        with tr.span("train.step", track="compute"):
            managed.log_decision(_decisions(managed)[0])
            with tr.span("mdmp.all_gather", axis="data", op="all_gather"):
                pass
    path = tmp_path / "live.json"
    doc = obs.write_chrome_trace(str(path), tr, managed.decision_log())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train.step", "mdmp.all_gather", "decision:all_gather",
            "thread_name"} <= names
    assert _cli(ref_trace_cli.main, [str(path)]) == \
        _cli(trace_cli.main, [str(path)])
