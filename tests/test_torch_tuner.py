"""The port's schedule tuner held against the reference's (host logic,
priced on ``TPU_V5E`` on both sides):

  * every ``decide_*`` seeds the same entry (key, mode, chunks, predicted
    seconds) as the reference's, and ``record`` / ``next_trial`` walk the
    same trials to the same winners;
  * the JSON a reference tuner writes (it rides inside checkpoints) loads
    into the port and writes back the same text, program plans included;
  * ``replan_for_mesh`` replays a reference tuner's winners onto a new
    topology exactly as the reference does: the same records, the same
    new entries and the same decision trail;
  * ``parse_call_site_key`` inverts ``call_site_key`` as the reference's;
  * the program-plan methods store, read and re-plan as the reference's
    (a stored plan without ops is kept and skipped by the replan); a
    tuner without plans replans without them.
"""

import dataclasses
import json

import pytest

from repro.core import cost_model as ref_cm
from repro.core import managed as ref_managed
from repro.core import tuner as ref_tuner
from repro_torch.core import cost_model as cm
from repro_torch.core import managed
from repro_torch.core import tuner


def _seed(t):
    """The same call sites on either package's tuner (every decide_*)."""
    return [
        t.decide("all_gather", (64, 128), "bfloat16", "model", 4,
                 nbytes=16384, compute_time_s=1e-5),
        t.decide("reduce_scatter", (512, 1024), "float32", "data", 8,
                 nbytes=1 << 21, collective="reduce_scatter"),
        t.decide_halo("x", 4, 1024, 256),
        t.decide_halo("x", 2, 4096, 4098, dtype_bytes=2,
                      dtype_str="bfloat16"),
        t.decide_attention("model", 4, 2, 2048, 32, 8, 128, 3072),
        t.decide_pipeline("pod", 4, 16, (8, 128, 64), 1e-3, 1 << 20),
        t.decide_pipeline("pod", 2, 32, (2, 1024, 3072), 5e-2, 25165824,
                          dtype_str="bfloat16"),
        t.decide_moe("model", 8, 4096, 2048, 64, 6, 1408),
        t.decide_serve(8, 160, 32, int(3.8e9), max_prompt=256),
        t.decide_preempt("serve", 8, 1 << 20, int(3.8e9), step_s=0.05),
        t.decide_ckpt("mesh", 4, 1 << 30, 0.1, mtbf_s=60.0),
        t.decide_ckpt("mesh", 1, 1 << 20, 0.05, mtbf_s=120.0,
                      write_bw=3e9, ckpt_cost_s=0.01, restore_s=0.02),
    ]


def _measure(t, entries):
    """Measured trials, the same on either side."""
    for i, e in enumerate(entries):
        trial = t.next_trial(e.key)
        n = 0
        while trial is not None and n < 3:
            t.record(e.key, trial[0], trial[1], 1e-3 * (1 + (i + n) % 3))
            trial = t.next_trial(e.key)
            n += 1


def _pair():
    ref = ref_tuner.ScheduleTuner(hw=ref_cm.TPU_V5E)
    port = tuner.ScheduleTuner(hw=cm.TPU_V5E)
    return ref, port


def test_decisions_equal_reference():
    ref, port = _pair()
    for want, got in zip(_seed(ref), _seed(port)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_record_and_next_trial_equal_reference():
    ref, port = _pair()
    r_entries, p_entries = _seed(ref), _seed(port)
    _measure(ref, r_entries)
    _measure(port, p_entries)
    assert {k: dataclasses.asdict(v) for k, v in port.entries.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.entries.items()}
    for e in r_entries:
        assert port.next_trial(e.key) == ref.next_trial(e.key)
    assert port.next_trial("pipeline|1x2|float32|pod2") == \
        ref.next_trial("pipeline|1x2|float32|pod2")


def test_tuner_decide_pipeline_seeds_and_adapts():
    t = tuner.ScheduleTuner()
    e = t.decide_pipeline("pod", 4, 16, (8, 128, 64), 1e-3, 1 << 20)
    assert e.mode in ("gpipe", "1f1b", "interleaved")
    t.record(e.key, "gpipe", 8, 2e-3)
    t.record(e.key, "interleaved", 8, 1e-3)
    assert (t.entries[e.key].mode, t.entries[e.key].chunks) == \
        ("interleaved", 8)
    seen = set()
    while True:
        trial = t.next_trial(e.key)
        if trial is None:
            break
        seen.add(trial)
        t.record(e.key, trial[0], trial[1], 5e-3)
    assert seen | {("gpipe", 8), ("interleaved", 8)} >= \
        set(tuner.ScheduleTuner.PIPELINE_CANDIDATES)


def _reference_json():
    ref = ref_tuner.ScheduleTuner(hw=ref_cm.TPU_V5E)
    _measure(ref, _seed(ref))
    blob = json.loads(ref.to_json())
    blob[ref_tuner.ScheduleTuner.PROGRAM_PLANS_KEY] = {
        "sig@data2xmodel2": {"signature": "sig", "ops": []}}
    return ref, blob


def test_reference_json_loads_and_writes_back(tmp_path):
    ref, blob = _reference_json()
    port = tuner.ScheduleTuner(hw=cm.TPU_V5E)
    port.load_entries(blob)
    ref2 = ref_tuner.ScheduleTuner(hw=ref_cm.TPU_V5E)
    ref2.load_entries(blob)
    assert port.to_json() == ref2.to_json()
    assert port.program_plans == ref2.program_plans
    path = tmp_path / "tuner.json"
    port.save(str(path))
    again = tuner.ScheduleTuner(hw=cm.TPU_V5E, path=str(path))
    assert again.to_json() == ref2.to_json()
    with pytest.raises(ValueError):
        tuner.ScheduleTuner().save()


@pytest.mark.parametrize("sizes", [
    {"x": 8, "mesh": 8, "model": 2, "pod": 4, "data": 4, "serve": 16},
    {"x": 2, "mesh": 1, "model": 16, "pod": 2},
    {}])
def test_replan_for_mesh_equals_reference(sizes):
    ref_json = _reference_json()[1]
    del ref_json[ref_tuner.ScheduleTuner.PROGRAM_PLANS_KEY]
    ref = ref_tuner.ScheduleTuner(hw=ref_cm.TPU_V5E)
    ref.load_entries(ref_json)
    port = tuner.ScheduleTuner(hw=cm.TPU_V5E)
    port.load_entries(ref_json)
    with ref_managed.use_config(ref_managed.MDMPConfig(hw=ref_cm.TPU_V5E)):
        ref_managed.clear_decision_log()
        want = ref_tuner.replan_for_mesh(ref, sizes, step_s=0.05,
                                         mtbf_s=60.0)
        want_log = [(r.op, r.axis, r.nbytes, r.mode, r.chunks,
                     r.predicted_bulk_s, r.predicted_interleaved_s)
                    for r in ref_managed.decision_log()]
    with managed.use_config(managed.MDMPConfig(hw=cm.TPU_V5E)):
        with managed.capture_decisions() as cap:
            got = tuner.replan_for_mesh(port, sizes, step_s=0.05,
                                        mtbf_s=60.0)
    # every entry but the two generic collectives' (no resolver replays
    # them, in either package)
    assert got == want and len(got) == len(_seed(port)) - 2
    assert [(r.op, r.axis, r.nbytes, r.mode, r.chunks, r.predicted_bulk_s,
             r.predicted_interleaved_s) for r in cap.records] == want_log
    assert port.to_json() == ref.to_json()
    for r in got:
        new = port.entries[r["new_key"]]
        assert (new.mode, new.chunks) == (r["mode"], r["chunks"])


def test_replan_for_mesh_replays_winners():
    t = tuner.ScheduleTuner()
    halo = t.decide_halo("x", 4, 1024, 256)
    t.record(halo.key, "aggregated", 4, 1e-3)
    t.record(halo.key, "bulk", 1, 2e-3)
    t.decide_ckpt("mesh", 4, 1 << 20, 0.05, mtbf_s=60.0)
    with managed.capture_decisions() as cap:
        recs = tuner.replan_for_mesh(t, {"x": 8, "mesh": 8}, step_s=0.05,
                                     mtbf_s=60.0)
    ops = {r["op"]: r for r in recs}
    assert set(ops) == {"halo_jacobi", "ckpt_interval"}
    r = ops["halo_jacobi"]
    assert (r["old_n"], r["new_n"]) == (4, 8)
    assert "x8" in r["new_key"] and "1024" not in r["new_key"].split("|")[1]
    new = t.entries[r["new_key"]]
    assert (new.mode, new.chunks) == ("aggregated", 4)
    assert new.measured_s == {}
    assert t.entries[halo.key].measured_s
    assert {"halo_aggregation", "ckpt_interval"} <= \
        {rec.op for rec in cap.records}


@pytest.mark.parametrize("key", [
    "pipeline|16x8x128x64|float32|pod4", "halo_jacobi|1024x256|float32|x4",
    "ckpt_interval|1048576|bytes|mesh1", "serve_schedule|8x160x32x3|b|s8",
    "op||int8|model16"])
def test_parse_call_site_key_equals_reference(key):
    assert tuner.parse_call_site_key(key) == \
        ref_tuner.parse_call_site_key(key)
    op, shape, dtype, axis, n = tuner.parse_call_site_key(key)
    assert tuner.call_site_key(op, shape, dtype, axis, n) == key


def test_bad_keys_are_skipped_by_replan():
    t = tuner.ScheduleTuner()
    t.record("not-a-call-site", "bulk", 1, 1.0)
    t.record("pipeline|8|float32|podX", "gpipe", 2, 1.0)
    assert tuner.replan_for_mesh(t, {"pod": 2}) == []
    with pytest.raises(ValueError):
        tuner.parse_call_site_key("a|1|f|nodigits")


def test_program_plan_methods_name_the_planner():
    t = tuner.ScheduleTuner(hw=cm.TPU_V5E)
    assert t.get_program_plan("sig", "data2") is None
    _, blob = _reference_json()
    t.load_entries(blob)
    ref = ref_tuner.ScheduleTuner(hw=ref_cm.TPU_V5E)
    ref.load_entries(blob)
    # the reference's blob holds a plan without ops: both replans keep
    # it and skip it, and replay the call sites alike
    assert tuner.replan_for_mesh(t, {"data": 2}) == \
        ref_tuner.replan_for_mesh(ref, {"data": 2})
    assert t.program_plans == ref.program_plans
    assert tuner.ScheduleTuner.program_plan_key("a", "b") == \
        ref_tuner.ScheduleTuner.program_plan_key("a", "b")
