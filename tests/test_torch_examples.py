"""The port's main-path examples (``repro_torch.examples.quickstart`` and
``train_100m``) on the CPU.

  * The quickstart against the reference's ``examples/quickstart.py``,
    run as written (its checkpoints redirected to a temporary directory):
    both train reduced granite-34b for 30 steps from the reference's
    seed-0 weights (carried into the port), on the same synthetic
    batches, then continue a prompt by 8 greedy tokens.
      - In the config's bf16 the loss trajectory agrees within 1e-3 at
        every step, and the port's decode on the reference's trained
        weights gives the reference's continuation.  (The two bf16
        trainings differ by one ulp in about 0.2% of the weights a step,
        so the two trained models' own continuations part after a few
        tokens; their decode paths agree.)
      - With the config in f32 on both sides the whole example agrees:
        the loss trajectory within 1e-3 and the continuation equal.
  * ``train_100m --steps 2 --seq 32 --batch 2 --device cpu`` (the
    110M-parameter config): finite losses and a checkpoint on disk;
    ``--pipeline gpipe`` on one stage prints its schedule decision and
    trains; an unknown schedule is refused.
"""

import dataclasses
import importlib.util
import math
import os
import pathlib
import sys

import jax
import numpy as np
import pytest

from repro import configs as ref_configs
from repro.models.model import Model as RefModel
from repro.parallel.sharding import MeshCtx as RefMeshCtx
from repro_torch import bridge, configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.examples import quickstart, train_100m
from repro_torch.models.model import Model
from repro_torch.train.serve_loop import Generator

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 30


def _reference_quickstart(monkeypatch, capsys, ckpt_dir, dtype=None):
    """Run ``examples/quickstart.py`` as written (the reduced config's
    type replaced by ``dtype`` when given); returns (losses,
    continuation, trained params)."""
    spec = importlib.util.spec_from_file_location(
        "ref_quickstart", ROOT / "examples" / "quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = {}
    loop_cfg = mod.TrainLoopConfig
    get_reduced = ref_configs.get_reduced

    class Loop(mod.TrainLoop):
        def run(self, *args, **kwargs):
            seen.update(super().run(*args, **kwargs))
            return seen

    monkeypatch.setattr(mod, "TrainLoop", Loop)
    monkeypatch.setattr(mod, "TrainLoopConfig", lambda **kw: loop_cfg(
        **dict(kw, ckpt_dir=str(ckpt_dir))))
    if dtype is not None:
        monkeypatch.setattr(ref_configs, "get_reduced",
                            lambda arch: dataclasses.replace(
                                get_reduced(arch), dtype=dtype))
    monkeypatch.setattr(sys, "argv", ["quickstart.py", str(STEPS)])
    capsys.readouterr()
    mod.main()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("greedy continuation:")][0]
    cont = [int(t) for t in line.split(":", 1)[1].strip(" []").split(",")]
    return ([h["loss"] for h in seen["history"]], cont,
            jax.tree.map(np.asarray, seen["params"]))


def _seed_params(dtype=None):
    cfg = ref_configs.get_reduced("granite-34b")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    return jax.tree.map(np.asarray, RefModel(
        cfg, RefMeshCtx.from_mesh(mesh)).init(jax.random.key(0)))


def test_quickstart_tracks_the_reference(monkeypatch, capsys, tmp_path):
    want_losses, want_cont, trained = _reference_quickstart(
        monkeypatch, capsys, tmp_path / "ref")
    out = quickstart.run(STEPS, device="cpu", ckpt_dir=str(tmp_path / "port"),
                         params=_seed_params())
    got = [h["loss"] for h in out["history"]]
    assert len(got) == len(want_losses) == STEPS
    np.testing.assert_allclose(got, want_losses, rtol=0, atol=1e-3)
    assert got[-1] < got[0] and len(out["continuation"]) == 8
    # the port's decode on the reference's trained weights
    model = bridge.params_from_numpy(trained, Model(
        configs.get_reduced("granite-34b"), device="cpu"))
    gen = Generator(model, ShapeConfig("qs", seq_len=64, global_batch=2,
                                       kind="decode"))
    assert gen.generate(quickstart.PROMPT, n_new=8)[0].tolist() == want_cont


def test_quickstart_in_f32_equals_the_reference(monkeypatch, capsys,
                                                tmp_path):
    want_losses, want_cont, _ = _reference_quickstart(
        monkeypatch, capsys, tmp_path / "ref", dtype="float32")
    get_reduced = configs.get_reduced
    monkeypatch.setattr(quickstart.configs, "get_reduced",
                        lambda arch: dataclasses.replace(get_reduced(arch),
                                                         dtype="float32"))
    out = quickstart.run(STEPS, device="cpu", ckpt_dir=str(tmp_path / "port"),
                         params=_seed_params("float32"))
    got = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(got, want_losses, rtol=0, atol=1e-3)
    assert out["continuation"] == want_cont


def test_quickstart_cli_prints_its_lines(capsys, tmp_path):
    quickstart.main(["3", "--device", "cpu", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "loss: " in out and "over 3 steps (0 restarts" in out
    line = [ln for ln in out.splitlines()
            if ln.startswith("greedy continuation:")][0]
    assert len(line.split(":", 1)[1].strip(" []").split(",")) == 8


def test_train_100m_runs_and_checkpoints(capsys, tmp_path):
    out = train_100m.main(["--steps", "2", "--seq", "32", "--batch", "2",
                           "--device", "cpu", "--ckpt", str(tmp_path)])
    text = capsys.readouterr().out
    assert "model: 100M params" in text and "final loss" in text
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert out["step"] == 2
    assert any(os.scandir(tmp_path))


def test_train_100m_refuses_pipelines(capsys, tmp_path):
    """``--pipeline`` runs the pod axis as stages (one process: one
    stage) and prints the schedule decision; an unknown schedule is
    refused."""
    with pytest.raises(SystemExit):
        train_100m.main(["--pipeline", "zigzag", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err
    out = train_100m.main(["--pipeline", "gpipe", "--steps", "2", "--seq",
                           "32", "--batch", "2", "--device", "cpu",
                           "--ckpt", str(tmp_path)])
    assert "pipeline schedule: gpipe M=" in capsys.readouterr().out
    assert all(math.isfinite(h["loss"]) for h in out["history"])
