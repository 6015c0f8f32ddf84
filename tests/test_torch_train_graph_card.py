"""The training step as a captured CUDA graph, on the card.

``train.train_loop.build_train_step`` returns a ``TrainStep``; on a card
with every mesh axis of size 1 its first call runs the step and captures
it, and every later call replays the graph.  For reduced phi4-mini
(dense) and moonshot (MoE) in bf16, 4 steps as replays against the same
seed's 4 steps from Python (``run_eager``): losses, gradient norms,
parameters and AdamW moments equal bit for bit where two eager runs are
equal, otherwise within twice the spread measured between two eager runs;
the kernels' launch counters over the replays equal the eager steps'.
``TrainLoop`` under a ``FaultPlan`` failure binds and captures again after
its restore and replays the uninterrupted run's losses; under an
``instrument`` recorder the step runs eager and ``capture()`` raises.
These tests need a CUDA card and skip without one.  The file imports
neither jax nor the reference:

    PYTHONPATH=src python -m pytest --noconftest -m gpu \\
        tests/test_torch_train_graph_card.py
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import instrument
from repro_torch.core.faults import FaultPlan
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.kernels import counters
from repro_torch.models.model import Model, flatten_specs
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)

ARCHS = ["phi4-mini-3.8b", "moonshot-v1-16b-a3b"]
SEQ, BATCH, STEPS = 64, 4, 4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph and the kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _setup(arch):
    cfg = configs.get_reduced(arch)
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    opt_cfg = AdamWConfig(moment_dtype=cfg.moment_dtype, **OPT)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=SEQ, global_batch=BATCH))
    return model, opt_cfg, data


def _batch(data, i):
    return {k: torch.from_numpy(v).cuda()
            for k, v in data.global_batch_at(i).items()}


def _run(arch, graph: bool) -> dict:
    """STEPS steps from seed 0: as replays of the captured step, or from
    Python through ``run_eager``."""
    model, opt_cfg, data = _setup(arch)
    opt = adamw_init(model.params(), opt_cfg)
    step = build_train_step(model, opt_cfg)
    assert step.step_mode == "graph"
    losses, gnorms = [], []
    before = counters.launch_counts()
    for i in range(STEPS):
        if graph:
            opt, m = step(opt, _batch(data, i))
        else:
            step.load(opt, _batch(data, i))
            m = step.run_eager()
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    launches = counters.change_since(before)
    assert (step.graph is not None) == graph and step.bindings == 1
    leaves = {f"param/{k}": v.detach().float().clone()
              for k, v in flatten_specs(model.params()).items()}
    for which in ("mu", "nu"):
        leaves.update({f"{which}/{k}": v.float().clone()
                       for k, v in flatten_specs(opt[which]).items()})
    assert int(opt["step"]) == STEPS
    return {"losses": losses, "gnorms": gnorms, "leaves": leaves,
            "launches": launches}


def _spread(a: dict, b: dict) -> float:
    """The largest difference of two runs, relative to each value's
    magnitude (the leaves' largest magnitudes)."""
    worst = max(abs(x - y) / max(abs(y), 1e-30)
                for k in ("losses", "gnorms") for x, y in zip(a[k], b[k]))
    for name, t in a["leaves"].items():
        u = b["leaves"][name]
        worst = max(worst, ((t - u).abs().max()
                            / u.abs().max().clamp(min=1e-30)).item())
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_replays_equal_eager_steps(cuda, arch):
    eager = _run(arch, graph=False)
    eager2 = _run(arch, graph=False)
    graph = _run(arch, graph=True)
    spread = _spread(eager2, eager)
    got = _spread(graph, eager)
    print(f"{arch}: eager vs eager {spread:.3e}, replays vs eager "
          f"{got:.3e} (relative to each leaf's largest magnitude)")
    if spread == 0.0:
        assert got == 0.0, f"replays differ from eager by {got:.3e}"
    else:
        assert got <= 2 * spread, (got, spread)
    assert graph["launches"] == eager["launches"] != {}


@pytest.mark.gpu
def test_fault_loop_captures_again_after_restore(cuda, tmp_path):
    """A transient fault at step 3 restores the step-2 checkpoint: the
    step binds again (the restored moments are new tensors), captures
    again, and the losses replay the uninterrupted run's."""

    def loop(name, plan):
        model, opt_cfg, data = _setup("phi4-mini-3.8b")
        step = build_train_step(model, opt_cfg)
        lp = TrainLoop(step, model, opt_cfg, data,
                       TrainLoopConfig(total_steps=6, ckpt_every=2,
                                       ckpt_dir=str(tmp_path / name)),
                       fault_plan=FaultPlan.parse(plan) if plan else None)
        opt, s0 = lp.init_state(0)
        out = lp.run(opt, s0)
        return out, step

    clean, clean_step = loop("clean", None)
    again, _ = loop("again", None)
    hurt, hurt_step = loop("hurt", "transient@3")
    assert clean_step.bindings == 1 and hurt_step.bindings == 2
    assert hurt["restarts"] == 1 and hurt_step.graph is not None
    losses = lambda out: {h["step"]: h["loss"] for h in out["history"]}
    want, spread = losses(clean), losses(again)
    for s, loss in losses(hurt).items():
        tol = 2 * abs(spread[s] - want[s])
        assert abs(loss - want[s]) <= tol, (s, loss, want[s], tol)


@pytest.mark.gpu
def test_recorder_runs_the_step_eager(cuda):
    model, opt_cfg, data = _setup("phi4-mini-3.8b")
    opt = adamw_init(model.params(), opt_cfg)
    step = build_train_step(model, opt_cfg)
    seen = []

    def region(_x):
        seen.append(step.step_mode)
        seen.append(step(opt, _batch(data, 0))[1]["loss"])
        with pytest.raises(RuntimeError, match="recorder"):
            step.capture()

    instrument.analyze_region(region, torch.zeros(1, device="cuda"))
    assert seen[0] == "eager" and step.graph is None
    assert torch.isfinite(seen[1]) and int(opt["step"]) == 1
    assert step.step_mode == "graph"
