"""The port's whole-program planner held against the reference's
(``repro.plan``), under ``TPU_V5E`` on both sides:

  * ``CommOp.to_dict`` / ``ProgramPlan.to_dict`` equal, floats to rel
    1e-12, on the reference's ``tests/test_plan.py`` cases (the conflict
    geometry, the stash cap, disjoint windows) and the singleton joint
    cost against the solo price;
  * ``train_geometry`` / ``lower_train_ops`` equal for granite-34b reduced
    at 2x2x2 1f1b, phi4-mini and moonshot at 1x2;
  * the planner's cost terms (``collective_components``) equal;
  * the tuner stores, reloads and re-plans a plan as the reference's does,
    and the resolvers prefer an installed plan.
"""

import json
import math

import pytest

from repro import configs as ref_configs
from repro.core import cost_model as ref_cm
from repro.core import managed as ref_managed
from repro.core import tuner as ref_tuner
from repro.plan import ir as ref_ir
from repro.plan import planner as ref_planner
from repro_torch import configs
from repro_torch.core import cost_model as cm
from repro_torch.core import managed, tuner
from repro_torch.plan import ir, planner

N_AXIS = 8


def close(a, b, rel=1e-12, path="") -> None:
    """JSON-like trees equal, floats to ``rel``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            close(a[k], b[k], rel, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, rel, f"{path}/{i}")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=rel, abs=1e-300) or (
            math.isinf(a) and a == b), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.fixture(autouse=True)
def _tpu():
    """Both packages price on TPU_V5E (the reference's default)."""
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        yield
    managed.install_plan(None)


def _conflict(mod_ir, mod_cm):
    att = mod_ir.CommOp(kind="attention", label="conflict.attention",
                        op_name="attention_schedule", axis="model",
                        axis_size=N_AXIS, nbytes=2 * 4 * 2048 * 2 * 128 * 2,
                        dtype_bytes=2, phase="fwd", window=(0.0, 0.6),
                        meta={"batch": 4, "s_local": 2048, "heads": 32,
                              "kv_heads": 2, "head_dim": 128,
                              "d_model": 4096, "causal": True})
    cap = mod_cm.moe_capacity(1024, 2, 16, 1.25)
    moe = mod_ir.CommOp(kind="moe", label="conflict.moe",
                        op_name="moe_dispatch", axis="model",
                        axis_size=N_AXIS, nbytes=16 * cap * 2048 * 2,
                        dtype_bytes=2, phase="fwd", window=(0.1, 0.7),
                        meta={"tokens_local": 1024, "d_model": 2048,
                              "n_experts": 16, "top_k": 2,
                              "d_ff_expert": 512, "capacity_factor": 1.25,
                              "mults": 3})
    return [att, moe]


def _pipe(mod_ir):
    return mod_ir.CommOp(kind="pipeline", label="p",
                         op_name="pipeline_schedule", axis="pod",
                         axis_size=4, nbytes=1 << 20, phase="step",
                         window=(0.0, 1.0),
                         meta={"n_layers": 8, "batch_fwd_s": 1e-3,
                               "batch_bytes": float(1 << 20),
                               "candidate_micro": (4, 8)})


def _cases(mod_ir, mod_cm):
    """name -> (ops, plan_program kwargs): the reference test_plan.py
    cases plus a mixed program on three axes."""
    a, b = _conflict(mod_ir, mod_cm)
    b2 = mod_ir.CommOp.from_dict({**b.to_dict(), "window": [0.7, 1.0]})
    halo = mod_ir.CommOp(kind="halo", label="h", op_name="halo_aggregation",
                         axis="x", axis_size=4, nbytes=4 * 1026,
                         dtype_bytes=4, phase="fwd", window=(0.0, 0.6),
                         meta={"rows_local": 256, "cols": 1026})
    grads = mod_ir.CommOp(kind="all_reduce", label="g", op_name="all_reduce",
                          axis="data", axis_size=4, nbytes=1 << 22,
                          phase="bwd", window=(0.4, 1.0),
                          meta={"collective": "all_reduce",
                                "compute_time_s": 2e-4})
    ckpt = mod_ir.CommOp(kind="ckpt", label="c", op_name="ckpt_interval",
                         axis="data", axis_size=4, nbytes=1 << 24,
                         phase="io", window=(0.9, 1.0),
                         meta={"snapshot_bytes": 1 << 24, "step_s": 0.1,
                               "mtbf_s": 600.0, "write_bw": None})
    return {
        "conflict": ([a, b], {}),
        "disjoint": ([a, b2], {"log": False}),
        "stash_cap": ([_pipe(mod_ir)], {"stash_cap_bytes": 1 << 30}),
        "stash_tight": ([_pipe(mod_ir)], {"stash_cap_bytes": 1 << 19}),
        "mixed": ([a, b, halo, grads, ckpt, _pipe(mod_ir)],
                  {"notes": ["mixed"]}),
    }


def _fields(rec):
    """A DecisionRecord without its timestamp."""
    return (rec.op, rec.axis, rec.nbytes, rec.mode, rec.chunks,
            rec.predicted_bulk_s, rec.predicted_interleaved_s)


@pytest.mark.parametrize("case", ["conflict", "disjoint", "stash_cap",
                                  "stash_tight", "mixed"])
def test_program_plan_equals_reference(case):
    ops, kw = _cases(ir, cm)[case]
    ref_ops, _ = _cases(ref_ir, ref_cm)[case]
    for op, ref_op in zip(ops, ref_ops):
        close(op.to_dict(), ref_op.to_dict())
    managed.clear_decision_log()
    ref_managed.clear_decision_log()
    got = planner.plan_program(ops, **kw)
    want = ref_planner.plan_program(ref_ops, **kw)
    close(got.to_dict(), want.to_dict())
    assert got.summary() == want.summary()
    assert got.coordinated == want.coordinated
    close([_fields(r) for r in managed.decision_log()],
          [_fields(r) for r in ref_managed.decision_log()])
    if case == "conflict":
        moe = next(c for c in got.choices if c.op.op_name == "moe_dispatch")
        assert (moe.local_knob["mode"], moe.knob["mode"]) == ("stream",
                                                              "bulk")
    assert ref_planner.contention_sets(ref_ops) == \
        planner.contention_sets(ops)


def test_joint_cost_singleton_matches_solo_and_reference():
    op = _conflict(ir, cm)[1]
    ref_op = _conflict(ref_ir, ref_cm)[1]
    hw = managed.get_config().hw
    cands = planner.candidates_for(op)
    ref_cands = ref_planner.candidates_for(ref_op)
    assert len(cands) == len(ref_cands)
    for c, rc in zip(cands, ref_cands):
        assert c.knob == rc.knob
        close(list(c.comps.__dict__.values()),
              list(rc.comps.__dict__.values()))
        assert planner.joint_cost([op], [c], hw=hw) == pytest.approx(
            c.solo_s(hw.alpha_s), rel=1e-12)
        assert planner.joint_cost([op], [c], hw=hw) == pytest.approx(
            ref_planner.joint_cost([ref_op], [rc], hw=ref_cm.TPU_V5E),
            rel=1e-12)


@pytest.mark.parametrize("coll", ["all_gather", "reduce_scatter",
                                  "all_reduce", "all_to_all"])
@pytest.mark.parametrize("mode,chunks", [("bulk", 1), ("interleaved", 1),
                                         ("interleaved", 4)])
def test_collective_components_equal_reference(coll, mode, chunks):
    for n in (1, 2, 8):
        got = cm.collective_components(coll, 3.5e6, n, mode=mode,
                                       chunks=chunks, compute_time_s=1e-4,
                                       hw=cm.TPU_V5E)
        want = ref_cm.collective_components(coll, 3.5e6, n, mode=mode,
                                            chunks=chunks,
                                            compute_time_s=1e-4,
                                            hw=ref_cm.TPU_V5E)
        assert got.__dict__ == want.__dict__
        assert got.solo_s(cm.TPU_V5E.alpha_s) == \
            want.solo_s(ref_cm.TPU_V5E.alpha_s)
    with pytest.raises(ValueError):
        cm.collective_wire_s("gather", 1.0, 2)


@pytest.mark.parametrize("arch,mesh,pipeline", [
    ("granite-34b", {"pod": 2, "data": 2, "model": 2}, "1f1b"),
    ("phi4-mini-3.8b", {"data": 1, "model": 2}, "none"),
    ("moonshot-v1-16b-a3b", {"data": 1, "model": 2}, "none"),
    ("granite-34b", {"data": 2, "model": 4}, "none"),
])
def test_train_geometry_and_lowering_equal_reference(arch, mesh, pipeline):
    cfg, ref_cfg = configs.get_reduced(arch), ref_configs.get_reduced(arch)
    kw = dict(mesh_axes=mesh, batch=8, seq=32, pipeline=pipeline)
    geo = ir.train_geometry(cfg, hw=cm.TPU_V5E, **kw)
    want = ref_ir.train_geometry(ref_cfg, hw=ref_cm.TPU_V5E, **kw)
    close(geo, want)
    args = lambda g: dict(mesh_axes=g["mesh_axes"],  # noqa: E731
                          grad_bytes=g["grad_bytes"],
                          pipeline=g["pipeline"],
                          attention=g["attention"], moe=g["moe"])
    ops = ir.lower_train_ops(**args(geo))
    ref_ops = ref_ir.lower_train_ops(**args(want))
    close([o.to_dict() for o in ops], [o.to_dict() for o in ref_ops])
    got = planner.plan_program(ops, log=False)
    close(got.to_dict(), ref_planner.plan_program(ref_ops,
                                                  log=False).to_dict())
    if pipeline == "1f1b":
        assert geo["pipeline"]["local_batch"] == 4
        assert {o.kind for o in ops} >= {"pipeline", "all_reduce"}


def test_lower_collectives_and_crosscheck_equal_reference():
    from repro.core import instrument as ref_instrument
    from repro_torch.core import instrument

    recs = [("all_gather", "x", 4096, 2, 1, "tests/a.py:3"),
            ("psum", "y", 1024, 5, 3, ""),
            ("ppermute", "x", 512, 7, 5, "tests/b.py:9"),
            ("reduce_scatter", "y", 64, 8, 1, "")]
    got = ir.lower_collectives([instrument.CollectiveRecord(*r)
                                for r in recs], {"x": 4, "y": 2},
                               max_depth=8)
    want = ref_ir.lower_collectives(
        [ref_instrument.CollectiveRecord(*r) for r in recs],
        {"x": 4, "y": 2}, max_depth=8)
    close([o.to_dict() for o in got], [o.to_dict() for o in want])
    rep = instrument.RegionReport(records={}, total_eqns=8, collectives=[
        instrument.CollectiveRecord(*r) for r in recs])
    ref_rep = ref_instrument.RegionReport(records={}, total_eqns=8,
                                          collectives=[
        ref_instrument.CollectiveRecord(*r) for r in recs])
    assert ir.crosscheck_collectives(got[:1], rep) == \
        ref_ir.crosscheck_collectives(want[:1], ref_rep)


def test_resolvers_prefer_installed_plan():
    plan = planner.plan_program(_conflict(ir, cm), log=False)
    with managed.use_plan(plan):
        d = managed.resolve_moe_dispatch("model", N_AXIS, 1024, 2048, 16,
                                         2, 512, dtype_bytes=2)
        assert d.schedule == plan.knob_for("moe_dispatch", "model")["mode"]
        a = managed.resolve_attention_schedule(
            "model", N_AXIS, 4, 2048, 32, 2, 128, 4096, dtype_bytes=2)
        assert a.schedule == "ring"
        d2 = managed.resolve_moe_dispatch("model", N_AXIS, 1024, 2048, 16,
                                          2, 512, dtype_bytes=2,
                                          schedule="stream")
        assert d2.schedule == "stream"
    assert managed.active_plan() is None


def test_tuner_roundtrip_and_replan_equal_reference(tmp_path):
    plan = planner.plan_program(_conflict(ir, cm), log=False)
    ref_plan = ref_planner.plan_program(_conflict(ref_ir, ref_cm),
                                        log=False)
    port = tuner.ScheduleTuner(hw=cm.TPU_V5E)
    ref = ref_tuner.ScheduleTuner(hw=ref_cm.TPU_V5E)
    assert port.store_program_plan(plan) == ref.store_program_plan(ref_plan)
    path = tmp_path / "tuner.json"
    port.save(str(path))
    ref.save(str(tmp_path / "ref.json"))
    close(json.loads(path.read_text()),
          json.loads((tmp_path / "ref.json").read_text()))
    # the reference's file loads into the port and back
    back = tuner.ScheduleTuner(hw=cm.TPU_V5E)
    back.load(str(tmp_path / "ref.json"))
    got = back.get_program_plan(plan.signature, plan.topology)
    assert isinstance(got, planner.ProgramPlan)
    assert got.knobs == plan.knobs
    close(got.to_dict(), plan.to_dict())
    assert back.get_program_plan("nothing", "here") is None
    managed.clear_decision_log()
    ref_managed.clear_decision_log()
    recs = tuner.replan_program_plans(back, {"model": 4})
    ref_back = ref_tuner.ScheduleTuner(hw=ref_cm.TPU_V5E)
    ref_back.load(str(tmp_path / "ref.json"))
    want = ref_tuner.replan_program_plans(ref_back, {"model": 4})
    assert recs == want and recs[0]["op"] == "program_plan"
    close(back.program_plans, ref_back.program_plans)
    assert [(r.op, r.mode, r.chunks) for r in managed.decision_log()] == \
        [(r.op, r.mode, r.chunks) for r in ref_managed.decision_log()]
    # a mesh change replays the stored plans through replan_for_mesh too
    assert [r["op"] for r in tuner.replan_for_mesh(back, {"model": 2})] == \
        [r["op"] for r in ref_tuner.replan_for_mesh(ref_back, {"model": 2})]


def test_program_plan_serialization_roundtrip():
    plan = planner.plan_program(_conflict(ir, cm), log=False)
    back = planner.ProgramPlan.from_dict(json.loads(json.dumps(
        plan.to_dict())))
    assert (back.signature, back.topology, back.knobs, back.coordinated) == \
        (plan.signature, plan.topology, plan.knobs, plan.coordinated)
    assert [c.knob for c in back.choices] == [c.knob for c in plan.choices]
    assert back.knob_for("moe_dispatch", "model") == \
        plan.knob_for("moe_dispatch", "model")
