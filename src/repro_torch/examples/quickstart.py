"""Quickstart: train a tiny decoder with the full MDMP stack (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [STEPS] \\
        [--device cpu]

Demonstrates: config -> Model -> train step (every collective a managed
MDMP op; the identity on this 1x1 mesh) -> fault-tolerant TrainLoop with
checkpoints -> greedy decode from the trained weights.  Runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch import bridge, configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.train.serve_loop import Generator
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)

PROMPT = np.array([[5, 6, 7, 8]] * 2, np.int32)


def run(steps: int = 30, *, device: str = "cuda",
        ckpt_dir: str | None = None, params: dict | None = None) -> dict:
    """Train reduced granite-34b for ``steps`` steps and continue a prompt
    greedily.  ``params`` (a numpy tree at the reference's layout) starts
    from those weights instead of resuming or drawing seed 0.  Returns the
    loop's output with ``continuation`` (8 tokens) added."""
    ctx = MeshCtx({"data": 1, "model": 1}, mdmp_mode="auto")
    cfg = configs.get_reduced("granite-34b")
    model = Model(cfg, ctx, device=resolve_device(device))
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=steps)
    step_fn = build_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=128, global_batch=8))
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_quickstart_ckpt")
    loop = TrainLoop(step_fn, model, opt_cfg, data,
                     TrainLoopConfig(total_steps=steps, ckpt_every=10,
                                     ckpt_dir=ckpt_dir))
    if params is None:
        opt, s0 = loop.resume_or_init()
    else:
        opt, s0 = loop.init_state()
        bridge.params_from_numpy(params, model)
    out = loop.run(opt, s0)
    out["step_mode"] = step_fn.step_mode
    gen = Generator(model, ShapeConfig("qs", seq_len=64, global_batch=2,
                                       kind="decode"))
    out["continuation"] = gen.generate(PROMPT, n_new=8)[0].tolist()
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: under the "
                         "system's temporary directory)")
    args = ap.parse_args(argv)
    out = run(args.steps, device=args.device, ckpt_dir=args.ckpt)
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    print(f"loss: {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"({out['restarts']} restarts, {len(out['stragglers'])} "
          f"stragglers)")
    print(f"train step: {out['step_mode']}")
    print("greedy continuation:", out["continuation"])
    return out


if __name__ == "__main__":
    main()
