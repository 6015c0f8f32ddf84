"""Managed fault tolerance in the port's training loop, held against the
reference on the CPU (the train-side mirror of tests/test_faults.py and
of tests/dist_suite/test_elastic.py, which passes when run alone).

Reduced granite-34b in f32 on a 1x1 mesh:

  * the fault plan's grammar and one-shot firing, and its training hook;
  * a restart after a transient fault, and one past a rank death and a
    corrupt checkpoint, replay the uninterrupted run's loss trajectory
    bit for bit (the optimizer, the data pipeline's state and the
    checkpoint's fallback past the corrupt step); the uninterrupted
    trajectory equals the reference's TrainLoop's within 1e-5 (the
    reference's weights);
  * a data-seed mismatch refuses to resume; the straggler detector's
    warm-up restarts after a restore; the retry budget still bounds a
    fault plan;
  * the managed (Young/Daly) cadence: ``ckpt_interval`` decisions logged,
    the interval below the fixed 25 at a 2 s MTBF, persisted through the
    tuner, and re-resolved once a save has been measured;
  * the elastic resume: a 1x1 checkpoint carrying tuner winners resumes
    on a 1x2 mesh of two gloo processes (file:// init); every winner is
    replayed onto the new topology and the continued run matches a
    straight 1x2 run (rtol 2e-4, atol 1e-5, the reference's tolerances);
  * ``launch.train --device cpu --reduced`` with ``--fault-plan`` and
    ``--ckpt-every auto`` (the decision and the fired events printed).
"""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLMData as RefData
from repro.models.model import Model as RefModel
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro.train.train_loop import TrainLoop as RefTrainLoop
from repro.train.train_loop import TrainLoopConfig as RefTrainLoopConfig
from repro.train.train_loop import build_train_step as ref_build_train_step
from repro_torch import bridge, configs
from repro_torch.checkpoint import ckpt
from repro_torch.core import managed
from repro_torch.core.faults import FaultError, FaultPlan, RankDeath
from repro_torch.core.tuner import ScheduleTuner
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "granite-34b"
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=200)


# ---------------------------------------------------------------------------
# FaultPlan grammar and one-shot semantics
# ---------------------------------------------------------------------------


def test_fault_plan_parse_fire_and_hook(tmp_path):
    plan = FaultPlan.parse("slow@9:0.5, transient@6;corrupt@14:32")
    assert [(e.kind, e.step, e.arg) for e in plan.events] == [
        ("transient", 6, 0.0), ("slow", 9, 0.5), ("corrupt", 14, 32.0)]
    assert plan.fire("transient", 5) is None
    ev = plan.fire("transient", 6)
    assert ev is not None and ev.fired
    assert plan.fire("transient", 6) is None        # exactly once
    assert len(plan.unfired()) == 2
    with pytest.raises(ValueError):
        FaultPlan.parse("meteor@3")
    with pytest.raises(ValueError):
        plan.train_hook()(14)                       # corrupt needs ckpt_dir
    hook = FaultPlan.parse("rank_death@1;transient@2;slow@3:0.01"
                           ).train_hook()
    hook(0)
    with pytest.raises(RankDeath):
        hook(1)
    with pytest.raises(FaultError):
        hook(2)
    t0 = time.monotonic()
    hook(3)
    assert time.monotonic() - t0 >= 0.01
    hook(1)                                          # fired already


def test_corrupt_hook_truncates_the_latest_checkpoint(tmp_path):
    from repro_torch.core.faults import corrupt_latest
    assert corrupt_latest(str(tmp_path)) is None
    for step in (3, 6):
        ckpt.save(str(tmp_path), step, {"w": torch.ones(64)})
    hook = FaultPlan.parse("corrupt@7:8").train_hook(ckpt_dir=str(tmp_path))
    with pytest.raises(RankDeath):
        hook(7)
    assert os.path.getsize(tmp_path / "step_00000006" / "arrays.npz") == 8
    assert os.path.getsize(tmp_path / "step_00000003" / "arrays.npz") > 8
    tree, _, step = ckpt.restore_latest(str(tmp_path), {"w": torch.zeros(64)})
    assert step == 3 and float(tree["w"].sum()) == 64.0
    # a save still in flight lands first (``settle``), and is the one hit
    hook = FaultPlan.parse("corrupt@9:8").train_hook(
        ckpt_dir=str(tmp_path),
        settle=lambda: ckpt.save(str(tmp_path), 8, {"w": torch.ones(64)}))
    with pytest.raises(RankDeath):
        hook(9)
    assert os.path.getsize(tmp_path / "step_00000008" / "arrays.npz") == 8


# ---------------------------------------------------------------------------
# Train-loop faults (one model and step across tests)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env():
    """The port's step on reduced granite in f32, and the reference's
    weights (the reference TrainLoop's ``init_state(seed=0)``)."""
    cfg = dataclasses.replace(configs.get_reduced(ARCH), dtype="float32")
    model = Model(cfg, MeshCtx(mdmp_mode="bulk"), device="cpu")
    opt_cfg = AdamWConfig(**OPT)
    step_fn = build_train_step(model, opt_cfg)
    ref_cfg = dataclasses.replace(ref_configs.get_reduced(ARCH),
                                  dtype="float32")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref_model = RefModel(ref_cfg, RefMeshCtx.from_mesh(mesh,
                                                       mdmp_mode="bulk"))
    ref_params = jax.tree.map(np.asarray, ref_model.init(jax.random.key(0)))
    return model, opt_cfg, step_fn, ref_model, mesh, ref_params


def _data(model, seed=0):
    return SyntheticLMData(DataConfig(
        vocab_size=model.cfg.vocab_size, seq_len=64, global_batch=4,
        seed=seed))


def _loop(env, loop_cfg, *, seed=0, **kw):
    model, opt_cfg, step_fn = env[:3]
    return TrainLoop(step_fn, model, opt_cfg, _data(model, seed), loop_cfg,
                     **kw)


def _start(env, loop):
    """The reference's weights and a zero optimizer state."""
    opt, s0 = loop.init_state()
    bridge.params_from_numpy(env[5], env[0])
    return opt, s0


def _trajectory(out):
    return {h["step"]: h["loss"] for h in out["history"]}   # last wins


@pytest.fixture(scope="module")
def oracle(env, tmp_path_factory):
    """The uninterrupted 12-step run's losses, the port's and the
    reference's."""
    tmp = tmp_path_factory.mktemp("oracle")
    loop = _loop(env, TrainLoopConfig(total_steps=12, ckpt_every=100,
                                      ckpt_dir=str(tmp / "port")))
    port = _trajectory(loop.run(*_start(env, loop)))
    _, _, _, ref_model, mesh, _ = env
    step, pshard, bshard = ref_build_train_step(
        ref_model, RefAdamWConfig(**OPT), mesh)
    ref_loop = RefTrainLoop(
        step, ref_model, RefAdamWConfig(**OPT),
        RefData(RefDataConfig(vocab_size=ref_model.cfg.vocab_size,
                              seq_len=64, global_batch=4)),
        RefTrainLoopConfig(total_steps=12, ckpt_every=100,
                           ckpt_dir=str(tmp / "ref")), pshard, bshard)
    ref = _trajectory(ref_loop.run(*ref_loop.init_state(seed=0)))
    return port, ref


def test_uninterrupted_trajectory_equals_reference(oracle):
    port, ref = oracle
    assert sorted(port) == sorted(ref) == list(range(12))
    np.testing.assert_allclose([port[s] for s in range(12)],
                               [ref[s] for s in range(12)], rtol=1e-5)


@pytest.mark.parametrize("spec,every,restarts", [
    ("transient@6", 4, 1), ("rank_death@5;corrupt@9", 2, 2)])
def test_resume_replays_the_trajectory_bit_for_bit(env, oracle, tmp_path,
                                                   spec, every, restarts):
    """A restart (after a transient fault; after a rank death and then a
    corrupt latest checkpoint) replays the uninterrupted run's losses bit
    for bit: parameters, optimizer and data-pipeline state all ride the
    checkpoint, and the restore falls back past the corrupt step."""
    seen, box = [], {}

    def observe(step):
        # the latest checkpoint once the save in flight has landed: the
        # one a corrupt event at this step attacks
        box["loop"].mgr.wait()
        seen.append((step, ckpt.latest_step(str(tmp_path))))

    loop = _loop(env, TrainLoopConfig(total_steps=12, ckpt_every=every,
                                      ckpt_dir=str(tmp_path)),
                 fault_plan=FaultPlan.parse(spec), fault_hook=observe)
    box["loop"] = loop
    out = loop.run(*_start(env, loop))
    assert out["restarts"] == restarts and out["step"] == 12
    assert not loop.fault_plan.unfired()
    got = _trajectory(out)
    for s in range(12):
        assert got[s] == oracle[0][s], f"step {s}: {got[s]} != {oracle[0][s]}"
    restored = [r.step for r in loop.ckpt_metrics.restores]
    assert len(restored) == restarts
    if "corrupt" in spec:
        # the corrupted checkpoint was the latest at step 9; the restore
        # after it took the one before
        latest = dict(seen)[9]
        assert restored[-1] < latest
        assert out["steps_executed"] > 12


def test_resume_rejects_data_seed_mismatch(env, tmp_path):
    a = _loop(env, TrainLoopConfig(total_steps=4, ckpt_every=4,
                                   ckpt_dir=str(tmp_path)))
    a.run(*a.init_state())
    b = _loop(env, TrainLoopConfig(total_steps=8, ckpt_every=4,
                                   ckpt_dir=str(tmp_path)), seed=1)
    with pytest.raises(ValueError, match="data seed mismatch"):
        b.resume_or_init()


def test_straggler_warmup_resets_after_restore(env, tmp_path):
    state = {"faulted": False, "slow": set()}

    def hook(step):
        if step == 8 and not state["faulted"]:
            state["faulted"] = True
            state["slow"] = {4, 5}      # ckpt_every=4 -> restore to 4
            raise RuntimeError("injected node failure")
        if step in state["slow"]:
            state["slow"].discard(step)
            time.sleep(1.0)             # >> factor x EWMA

    loop = _loop(env, TrainLoopConfig(total_steps=12, ckpt_every=4,
                                      ckpt_dir=str(tmp_path),
                                      straggler_factor=5.0),
                 fault_hook=hook)
    out = loop.run(*loop.init_state())
    assert out["restarts"] == 1 and out["step"] == 12
    assert out["stragglers"] == [], \
        "post-restore warmup steps flagged as stragglers"


def test_managed_cadence_decision(env, tmp_path):
    tuner = ScheduleTuner()
    loop = _loop(env, TrainLoopConfig(total_steps=8, ckpt_every=25,
                                      ckpt_dir=str(tmp_path),
                                      managed_cadence=True, mtbf_s=2.0),
                 tuner=tuner)
    with managed.capture_decisions() as cap:
        out = loop.run(*loop.init_state())
    recs = [r for r in cap.records if r.op == "ckpt_interval"]
    assert recs, "managed cadence logged no ckpt_interval decision"
    assert out["ckpt_interval"] == recs[-1].chunks
    assert out["ckpt_interval"] < 25, \
        "a 2s MTBF must shorten the cadence vs the fixed-25 baseline"
    keys = [k for k in tuner.entries if k.startswith("ckpt_interval|")]
    assert keys and tuner.entries[keys[0]].chunks >= 1
    assert loop.ckpt_metrics.saves, "no instrumented saves recorded"
    # the first decision priced the default bandwidth; the run re-resolved
    # from the first measured save
    assert loop.ckpt_decisions[0].write_bw == 2.0e9
    measured = [d for d in loop.ckpt_decisions
                if d.write_bw != 2.0e9]
    assert measured and measured[0].write_bw == pytest.approx(
        max(s.nbytes / (s.drain_s + s.write_s)
            for s in loop.ckpt_metrics.saves[:1]))


def test_transient_exhausts_retries(env, tmp_path):
    loop = _loop(env, TrainLoopConfig(total_steps=6, ckpt_every=100,
                                      ckpt_dir=str(tmp_path),
                                      max_retries=1),
                 fault_plan=FaultPlan.parse("transient@0;transient@0"))
    with pytest.raises(FaultError):
        loop.run(*loop.init_state())


# ---------------------------------------------------------------------------
# Elastic resume: a 1x1 checkpoint onto a 1x2 mesh of gloo processes
# ---------------------------------------------------------------------------

ELASTIC = dict(lr=1e-2)


def _elastic_cfg():
    return dataclasses.replace(configs.get_reduced(ARCH), dtype="float32")


def _elastic_data():
    return SyntheticLMData(DataConfig(
        vocab_size=_elastic_cfg().vocab_size, seq_len=32, global_batch=4))


def elastic_rank_main(rank, init, tmp):
    """One rank of the 1x2 mesh: the straight 4-step run from the 1x1
    run's initial weights, then the resume of the 1x1 checkpoint (copied
    to this rank's directory) to step 4."""
    import json

    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.model import flatten_specs
    from repro_torch.parallel.sharding import shard_of

    torch.set_num_threads(1)
    launch_mesh.init_distributed("cpu", init_method=init, rank=rank,
                                 world_size=2)
    ctx = MeshCtx.from_mesh(launch_mesh.make_mesh((1, 2),
                                                  ("data", "model"), "cpu"),
                            mdmp_mode="bulk")
    model = Model(_elastic_cfg(), ctx, device="cpu")
    opt_cfg = AdamWConfig(**ELASTIC)
    step_fn = build_train_step(model, opt_cfg)
    full = dict(np.load(os.path.join(tmp, "init.npz")))
    specs = flatten_specs(model.param_specs())

    def loop(ckpt_dir, total, tuner):
        return TrainLoop(step_fn, model, opt_cfg, _elastic_data(),
                         TrainLoopConfig(total_steps=total, ckpt_every=2,
                                         ckpt_dir=ckpt_dir), tuner=tuner)

    oracle = loop(os.path.join(tmp, f"oracle{rank}"), 4, ScheduleTuner())
    opt, s0 = oracle.init_state(seed=0)
    with torch.no_grad():
        for name, t in flatten_specs(model.params()).items():
            t.copy_(shard_of(torch.from_numpy(full[name]), specs[name], ctx))
    oracle.run(opt, s0)
    res = {f"oracle/{k}": v for k, v in flatten_specs(
        bridge.params_to_numpy_full(model)).items()}

    resumed = loop(os.path.join(tmp, f"elastic{rank}"), 4, ScheduleTuner())
    with managed.capture_decisions() as cap:
        opt, s0 = resumed.resume_or_init(seed=0)
    out = resumed.run(opt, s0)
    res.update({f"elastic/{k}": v for k, v in flatten_specs(
        bridge.params_to_numpy_full(model)).items()})
    meta = {"s0": s0, "step": out["step"], "replayed": resumed.replayed,
            "logged": sorted({r.op for r in cap.records}),
            "entries": {k: [e.mode, e.chunks, e.measured_s]
                        for k, e in resumed.tuner.entries.items()}}
    with open(os.path.join(tmp, f"elastic{rank}.json"), "w") as fh:
        json.dump(meta, fh)
    if rank == 0:
        np.savez(os.path.join(tmp, "elastic.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


WORKER = """
import sys
sys.path.insert(0, {tests!r})
from test_torch_faults import elastic_rank_main
elastic_rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
"""

CLI_FAULTS = ["--steps", "8", "--ckpt-every", "auto", "--mtbf", "5",
              "--fault-plan", "rank_death@3;corrupt@6", "--seq", "32",
              "--batch", "4"]


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """Phase 1 on 1x1 in this process (two steps, a checkpoint carrying
    tuner winners), then the two 1x2 ranks, and meanwhile the launcher
    with a fault plan."""
    import json

    from repro_torch.models.model import flatten_specs

    tmp = tmp_path_factory.mktemp("elastic")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "phi4-mini-3.8b", "--reduced", "--device", "cpu", "--ckpt",
         str(tmp / "cli")] + CLI_FAULTS, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    model = Model(_elastic_cfg(), MeshCtx(mdmp_mode="bulk"), device="cpu")
    opt_cfg = AdamWConfig(**ELASTIC)
    tuner = ScheduleTuner()
    halo = tuner.decide_halo("data", 1, 1024, 256)
    tuner.record(halo.key, "aggregated", 4, 1e-3)
    tuner.record(halo.key, "bulk", 1, 2e-3)
    moe = tuner.decide_moe("model", 1, 512, 64, 8, 2, 128)
    tuner.record(moe.key, "stream", 2, 1e-3)
    tuner.record(moe.key, "bulk", 1, 3e-3)
    tuner.decide_ckpt("mesh", 1, 1 << 20, 0.05, mtbf_s=120.0)
    loop = TrainLoop(build_train_step(model, opt_cfg), model, opt_cfg,
                     _elastic_data(),
                     TrainLoopConfig(total_steps=2, ckpt_every=2,
                                     ckpt_dir=str(tmp / "phase1")),
                     tuner=tuner)
    opt, s0 = loop.init_state(seed=0)
    np.savez(tmp / "init.npz", **{k: v.detach().numpy().copy()
                                  for k, v in flatten_specs(
                                      model.params()).items()})
    loop.run(opt, s0)
    for r in range(2):
        shutil.copytree(tmp / "phase1", tmp / f"elastic{r}")
    (tmp / "worker.py").write_text(WORKER.format(tests=str(ROOT / "tests")))
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r),
         "file://" + str(tmp / "init"), str(tmp)], env=env,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=420)[1] for p in procs]
        cli_out, cli_err = cli.communicate(timeout=420)
    finally:
        for p in procs + [cli]:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    meta = [json.loads((tmp / f"elastic{r}.json").read_text())
            for r in range(2)]
    return (dict(np.load(tmp / "elastic.npz")), meta,
            (cli.returncode, cli_out, cli_err))


def test_elastic_resume_replays_tuner_winners(elastic):
    _, meta, _ = elastic
    for m in meta:
        assert m["s0"] == 2 and m["step"] == 4
        ops = {r["op"]: r for r in m["replayed"]}
        assert {"halo_jacobi", "moe_dispatch", "ckpt_interval"} <= set(ops)
        assert (ops["halo_jacobi"]["old_n"], ops["halo_jacobi"]["new_n"]) \
            == (1, 1)
        assert "model2" in ops["moe_dispatch"]["new_key"]
        assert "mesh2" in ops["ckpt_interval"]["new_key"]
        mode, chunks, measured = m["entries"][ops["moe_dispatch"]["new_key"]]
        assert (mode, chunks, measured) == ("stream", 2, {})
        mode, chunks, _ = m["entries"][ops["halo_jacobi"]["new_key"]]
        assert (mode, chunks) == ("aggregated", 4)
        assert {"halo_aggregation", "moe_dispatch", "ckpt_interval"} <= \
            set(m["logged"])
    assert meta[0]["replayed"] == meta[1]["replayed"]


def test_elastic_resume_matches_the_straight_run(elastic):
    res, _, _ = elastic
    names = [k[len("oracle/"):] for k in res if k.startswith("oracle/")]
    assert names
    for name in names:
        np.testing.assert_allclose(res[f"elastic/{name}"],
                                   res[f"oracle/{name}"], rtol=2e-4,
                                   atol=1e-5, err_msg=f"elastic {name}")


def test_launcher_fault_plan_and_managed_cadence(elastic):
    rc, out, err = elastic[2]
    assert rc == 0, err[-4000:]
    assert "faults injected=2 unfired=0 restarts=2" in out, out
    assert "decision ckpt_interval(daly" in out, out
    assert "done at step 8" in out, out
