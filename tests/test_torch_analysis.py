"""The port's static verifier (``repro_torch.analysis``, mdmplint) held
against the reference's (``repro.analysis``), under ``TPU_V5E``:

  * every ``tests/lint_corpus/*.json`` case gives the golden codes, the
    reference's diagnostics (rendered verbose, line for line) and its
    ``exit_code``;
  * the lint CLI's exit code and output equal the reference's for the
    corpus and for ``--target train`` / ``--target serve`` geometry;
  * each pass family on the reference's positive and negative graphs,
    the permutes ``derive_permutes`` builds, and the launcher preflight's
    three modes (the ``lint`` DecisionRecord, ``LintError``).
"""

import contextlib
import glob
import io
import json
import os

import pytest

from repro import analysis as ref_analysis
from repro.core import managed as ref_managed
from repro.launch import lint as ref_lint
from repro.plan import ir as ref_ir
from repro_torch import analysis
from repro_torch.analysis.graph import (BufferAccess, CommGraph, InFlight,
                                        PermuteSite, WaitEdge, _KnobTable)
from repro_torch.core import cost_model as cm
from repro_torch.core import managed
from repro_torch.launch import lint
from repro_torch.plan import CommOp

CORPUS = os.path.join(os.path.dirname(__file__), "lint_corpus")
CASES = sorted(glob.glob(os.path.join(CORPUS, "*.json")))


@pytest.fixture(autouse=True)
def _tpu():
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        yield


def _codes(diags):
    return sorted({d.code for d in diags})


@pytest.mark.parametrize("path", CASES, ids=os.path.basename)
def test_lint_corpus_equals_reference(path):
    with open(path) as f:
        case = json.load(f)
    diags = analysis.run_all(analysis.from_corpus(case))
    want = ref_analysis.run_all(ref_analysis.from_corpus(case))
    assert _codes(diags) == sorted(set(case["expect"])) == _codes(want)
    assert analysis.render(diags, verbose=True) == \
        ref_analysis.render(want, verbose=True)
    assert analysis.exit_code(diags) == ref_analysis.exit_code(want)
    assert analysis.summary(diags, "c") == ref_analysis.summary(want, "c")


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--case", os.path.join(CORPUS, "nondivisor_g.json"), "-v"],
    ["--case", os.path.join(CORPUS, "clean.json")],
    ["--case", os.path.join(CORPUS, "wait_cycle.json")],
    ["--target", "train", "--arch", "granite-34b", "--reduced", "--mesh",
     "2x2x2", "--pipeline", "1f1b", "--batch", "8", "--seq", "32"],
    ["--target", "train", "--arch", "moonshot-v1-16b-a3b", "--reduced",
     "--mesh", "2x4"],
    ["--target", "serve", "--arch", "mamba2-130m", "--reduced", "--slots",
     "4"],
], ids=["corpus-v", "clean", "wait-cycle", "train-1f1b", "train-moe",
        "serve"])
def test_lint_cli_equals_reference(argv):
    rc, out = _cli(lint.main, argv)
    ref_rc, ref_out = _cli(ref_lint.main, argv)
    assert rc == ref_rc
    assert out == ref_out
    assert out.strip().splitlines()[-1].startswith("mdmplint: ")


def test_lint_cli_reads_a_stored_plan(tmp_path):
    from repro_torch.plan import plan_program

    ops = [CommOp(kind="moe", label="m", op_name="moe_dispatch",
                  axis="model", axis_size=4, nbytes=1,
                  meta={"tokens_local": 64, "top_k": 2, "n_experts": 4,
                        "capacity_factor": 1.0, "d_model": 32,
                        "d_ff_expert": 64})]
    plan = plan_program(ops, log=False)
    plan.knobs["moe_dispatch|model"] = {"mode": "stream", "chunks": 5}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan.to_dict()))
    rc, out = _cli(lint.main, ["--case", os.path.join(CORPUS,
                                                      "nondivisor_g.json"),
                               "--plan", str(path)])
    ref_rc, ref_out = _cli(ref_lint.main, ["--case", os.path.join(
        CORPUS, "nondivisor_g.json"), "--plan", str(path)])
    assert (rc, out) == (ref_rc, ref_out)


# -- the pass families, positive and negative ------------------------------


def test_pass_axes_and_drift():
    ok = CommOp(kind="all_reduce", label="g", op_name="all_reduce",
                axis="data", axis_size=2, nbytes=8)
    bad = CommOp(kind="all_reduce", label="g2", op_name="all_reduce",
                 axis="dta", axis_size=2, nbytes=8)
    assert analysis.check_axes(CommGraph("t", {"data": 2},
                                         declared=[ok])) == []
    diags = analysis.check_axes(CommGraph("t", {"data": 2},
                                          declared=[ok, bad]))
    assert _codes(diags) == ["MDMP001"] and diags[0].label == "g2"
    decl = [CommOp(kind="all_gather", label="kv", op_name="all_gather",
                   axis="model", axis_size=4, nbytes=1000)]
    traced = [CommOp(kind="collective", label="ag#0", op_name="all_gather",
                     axis="model", axis_size=4, nbytes=1000,
                     meta={"trips": 9})]
    g = CommGraph("t", {"model": 4}, declared=decl, traced=traced)
    assert _codes(analysis.check_drift(g)) == ["MDMP102"]
    g.traced.append(CommOp(kind="collective", label="ps#1",
                           op_name="all_reduce", axis="data", axis_size=2,
                           nbytes=64))
    assert "MDMP101" in _codes(analysis.check_drift(g))
    g3 = CommGraph("t", {"model": 4},
                   declared=[CommOp(kind="all_to_all", label="a2a",
                                    op_name="all_to_all", axis="model",
                                    axis_size=4, nbytes=1000)],
                   traced=[CommOp(kind="collective", label="ag#0",
                                  op_name="all_gather", axis="model",
                                  axis_size=4, nbytes=1000)])
    assert _codes(analysis.check_drift(g3)) == ["MDMP104"]


def test_pass_permutes_ordering_overlap():
    g = CommGraph("t", {"model": 4})
    g.permutes = [PermuteSite("ok", "model", 4, analysis.ring_perm(4),
                              ring=True)]
    assert analysis.check_permutes(g) == []
    g.permutes = [PermuteSite("even", "model", 4, analysis.ring_perm(4, 2),
                              ring=True)]
    assert _codes(analysis.check_permutes(g)) == ["MDMP202"]
    a = CommOp(kind="all_gather", label="a", op_name="all_gather",
               axis="model", axis_size=4, nbytes=8, window=(0.0, 0.5))
    b = CommOp(kind="all_gather", label="b", op_name="all_gather",
               axis="model", axis_size=4, nbytes=8, window=(0.2, 0.7))
    g = CommGraph("t", {"model": 4}, declared=[a, b])
    assert analysis.check_ordering(g) == []
    g.waits = [WaitEdge("b", "a", "a gates on b's arrival")]
    assert _codes(analysis.check_ordering(g)) == ["MDMP301"]
    g = CommGraph("t", {"x": 8})
    g.inflight = [InFlight("ghost", 0.1, 0.5, "halo.xfer")]
    g.accesses = [BufferAccess("ghost", 0.3, "read", "sweep")]
    assert _codes(analysis.check_overlap(g)) == ["MDMP401"]
    g.accesses = [BufferAccess("ghost", 0.3, "write", "sweep")]
    assert _codes(analysis.check_overlap(g)) == ["MDMP402"]


def test_pass_feasibility():
    moe = CommOp(kind="moe", label="m", op_name="moe_dispatch",
                 axis="model", axis_size=4, nbytes=1,
                 meta={"tokens_local": 64, "top_k": 2, "n_experts": 4,
                       "capacity_factor": 1.0})
    pipe = CommOp(kind="pipeline", label="p", op_name="pipeline_schedule",
                  axis="pod", axis_size=2, nbytes=1,
                  meta={"local_batch": 8, "n_layers": 4,
                        "batch_bytes": 1 << 30})
    halo = CommOp(kind="halo", label="h", op_name="halo_aggregation",
                  axis="x", axis_size=4, nbytes=1,
                  meta={"rows_local": 16, "cols": 64})
    bad = _KnobTable({"moe_dispatch|model": {"mode": "stream",
                                             "chunks": 5},
                      "pipeline_schedule|pod": {"mode": "interleaved",
                                                "chunks": 3, "virtual": 2},
                      "halo_aggregation|x": {"mode": "aggregated",
                                             "chunks": 64}})
    g = CommGraph("t", {"model": 4, "pod": 2, "x": 4},
                  declared=[moe, pipe, halo], plan=bad,
                  stash_cap_bytes=1 << 20)
    codes = [d.code for d in analysis.check_feasibility(g)]
    assert sorted(codes) == ["MDMP501", "MDMP502", "MDMP502", "MDMP503",
                             "MDMP504"]


@pytest.mark.parametrize("kind,mode", [("attention", None),
                                       ("attention", "ring"),
                                       ("pipeline", None),
                                       ("moe", "stream"), ("moe", "bulk")])
def test_derive_permutes_equals_reference(kind, mode):
    d = dict(kind=kind, label="op", op_name={
        "attention": "attention_schedule", "pipeline": "pipeline_schedule",
        "moe": "moe_dispatch"}[kind], axis="model", axis_size=4, nbytes=8,
             meta={"site": ("tests/x.py", 3)})
    knobs = {f"{d['op_name']}|model": {"mode": mode, "chunks": 2}} \
        if mode else {}
    got = analysis.derive_permutes([CommOp(**d)], {"model": 4},
                                   _KnobTable(knobs) if knobs else None)
    want = ref_analysis.derive_permutes(
        [ref_ir.CommOp(**d)], {"model": 4},
        ref_analysis.graph._KnobTable(knobs) if knobs else None)
    assert [p.__dict__ for p in got] == [p.__dict__ for p in want]
    assert analysis.run_all(CommGraph("t", {"model": 4},
                                      permutes=got)) == []


def _broken():
    g = CommGraph("broken", {"model": 4})
    g.permutes = [PermuteSite("dup", "model", 4,
                              ((0, 1), (1, 1), (2, 3), (3, 0)))]
    return g


def test_preflight_modes():
    assert analysis.preflight(_broken(), "off", out=lambda s: None) == []
    managed.clear_decision_log()
    lines = []
    diags = analysis.preflight(_broken(), "warn", out=lines.append)
    assert _codes(diags) == ["MDMP201"]
    recs = [r for r in managed.decision_log() if r.op == "lint"]
    assert len(recs) == 1 and (recs[0].chunks, recs[0].nbytes) == (1, 1)
    ref_managed.clear_decision_log()
    ref_lines = []
    ref_g = ref_analysis.CommGraph("broken", {"model": 4})
    ref_g.permutes = [ref_analysis.PermuteSite(
        "dup", "model", 4, ((0, 1), (1, 1), (2, 3), (3, 0)))]
    ref_analysis.preflight(ref_g, "warn", out=ref_lines.append)
    assert lines == ref_lines
    with pytest.raises(analysis.LintError) as ei:
        analysis.preflight(_broken(), "strict", out=lambda s: None)
    assert ei.value.code == 1 and _codes(ei.value.diags) == ["MDMP201"]
    assert analysis.preflight(CommGraph("clean", {"model": 4}), "strict",
                              out=lambda s: None) == []


def test_strict_renders_side_by_side():
    lines = []
    decl = [CommOp(kind="all_gather", label="kv", op_name="all_gather",
                   axis="model", axis_size=4, nbytes=100,
                   meta={"site": ("src/repro_torch/x.py", 7)})]
    traced = [CommOp(kind="collective", label="ag#0", op_name="all_gather",
                     axis="model", axis_size=4, nbytes=100,
                     meta={"trips": 99,
                           "source": "src/repro_torch/x.py:52"})]
    g = CommGraph("t", {"model": 4}, declared=decl, traced=traced)
    with pytest.raises(SystemExit):
        analysis.preflight(g, "strict", out=lines.append)
    text = "\n".join(lines)
    assert "declared |" in text and "traced   |" in text
    assert "src/repro_torch/x.py:52" in text
