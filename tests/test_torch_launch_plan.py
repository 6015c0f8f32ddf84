"""The launchers' ``--plan``, ``--verify`` and ``--trace`` on the CPU
(reduced configs): a planned, strictly verified and traced launch gives
the plain launch's losses and tokens bit for bit and the same model
decisions; the trace holds the launch's spans and reads in the
reference's ``repro.launch.trace``; ``--verify strict`` exits 1 on a
forced knob the executor would clamp; the defaults are the reference's
(``--plan local``, ``--verify warn``)."""

import contextlib
import io
import json

import numpy as np
import pytest

from repro.launch import trace as ref_trace_cli
from repro_torch import obs
from repro_torch.core import managed
from repro_torch.launch import serve, train

#: the planner's and the verifier's own trail records
OWN = ("program_plan", "lint")


def _launch(main, argv):
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(argv)
        return out, buf.getvalue(), [
            (r.op, r.axis, r.mode, r.chunks, r.nbytes)
            for r in managed.decision_log()]
    finally:
        managed.install_plan(None)
        obs.install_tracer(None)


def _spans(path):
    doc = json.loads(path.read_text())
    return [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "moonshot-v1-16b-a3b"])
def test_train_planned_verified_traced_equals_plain(arch, tmp_path):
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16"]
    plain, _, plain_recs = _launch(train.main, base + [
        "--plan", "local", "--verify", "off", "--ckpt",
        str(tmp_path / "a")])
    path = tmp_path / "train.json"
    got, text, recs = _launch(train.main, base + [
        "--plan", "program", "--verify", "strict", "--trace", str(path),
        "--ckpt", str(tmp_path / "b")])
    assert [h["loss"] for h in got["history"]] == \
        [h["loss"] for h in plain["history"]]
    assert "decision program_plan(local ops=0 topo=scalar" in text
    assert f"mdmplint: train:{arch} clean (0 diagnostics)" in text
    assert [r for r in recs if r[0] not in OWN] == plain_recs
    assert [r[0] for r in recs if r[0] in OWN] == ["program_plan"]
    names = _spans(path)
    assert names.count("train.step") == 3
    assert {"plan.resolve", "lint.preflight", "ckpt.save"} <= set(names)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_trace_cli.main([str(path)]) == 0
    assert f"run=train:{arch}" in buf.getvalue()


def test_train_defaults_and_strict_refusal(tmp_path):
    base = ["--arch", "granite-34b", "--reduced", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt",
            str(tmp_path / "c")]
    _, text, recs = _launch(train.main, base)
    # the reference's defaults: plan local (no plan line), verify warn
    assert "program_plan(" not in text and "mdmplint: " in text
    assert [r[0] for r in recs if r[0] in OWN] == ["program_plan", "lint"]
    # a forced microbatch count that does not divide the local batch is
    # MDMP502: strict refuses the launch before a step runs
    with pytest.raises(SystemExit) as ei:
        _launch(train.main, base + [
            "--mesh", "1x1x1", "--pipeline", "1f1b", "--microbatches", "3",
            "--verify", "strict"])
    assert ei.value.code == 1


def test_serve_planned_verified_traced_equals_plain(tmp_path):
    base = ["--arch", "phi4-mini-3.8b", "--reduced", "--device", "cpu",
            "--requests", "4", "--new-tokens", "6"]
    plain, _, plain_recs = _launch(serve.main, base + [
        "--plan", "local", "--verify", "off"])
    path = tmp_path / "serve.json"
    got, text, recs = _launch(serve.main, base + [
        "--plan", "program", "--verify", "strict", "--trace", str(path)])
    assert all(np.array_equal(a, b) for a, b in zip(got["tokens"],
                                                    plain["tokens"]))
    assert len(got["tokens"]) == 4
    assert "decision program_plan(local ops=2 topo=serve4" in text
    assert "mdmplint: serve:phi4-mini-3.8b clean (0 diagnostics)" in text
    # the plan pins the knobs the engine resolves: the same schedule
    assert {r[2:4] for r in recs if r[0] == "serve_schedule"} == \
        {r[2:4] for r in plain_recs if r[0] == "serve_schedule"}
    assert got["engine"].decode_steps == plain["engine"].decode_steps
    assert "serve.quantum" in _spans(path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ref_trace_cli.main([str(path)]) == 0
    assert "run=serve:phi4-mini-3.8b" in buf.getvalue()
