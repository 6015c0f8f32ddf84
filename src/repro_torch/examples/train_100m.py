"""End to end: train a ~110M-parameter decoder with the production
stack — managed collectives, the FSDP layout, the fault-tolerant loop,
async checkpoints (port of ``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300

Runs on ``cuda`` unless ``--device cpu`` is given, on a (1, 1) mesh.
``--pipeline`` other than ``none`` (the pod axis as pipeline stages) is
ROADMAP Queue 1 slice 9 and is refused.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import MeshCtx
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)

CONFIG_100M = ModelConfig(
    name="repro-110m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
    mlp="swiglu",
    tie_embeddings=True,
    tp_multiple=1,
    remat=True,
)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "train100m_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--pipeline", default="none",
                    choices=["none", "gpipe", "1f1b", "interleaved",
                             "auto"],
                    help="the pod axis as pipeline stages (ROADMAP Queue 1 "
                         "slice 9)")
    args = ap.parse_args(argv)
    if args.pipeline != "none":
        ap.error(f"--pipeline {args.pipeline}: pipeline parallelism is "
                 "ROADMAP Queue 1 slice 9")

    cfg = CONFIG_100M
    print(f"model: {cfg.param_count()/1e6:.0f}M params")
    ctx = MeshCtx({"data": 1, "model": 1}, mdmp_mode="auto")
    model = Model(cfg, ctx, device=resolve_device(args.device))
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    step_fn = build_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    loop = TrainLoop(step_fn, model, opt_cfg, data,
                     TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                                     ckpt_dir=args.ckpt))
    opt, s0 = (loop.resume_or_init() if args.resume else loop.init_state())
    out = loop.run(opt, s0)
    hist = out["history"]
    for h in hist[:: max(1, len(hist) // 12)]:
        print(f"  step {h['step']:4d} loss {h['loss']:.4f} "
              f"{h['time_s']:.2f}s")
    print(f"final loss {hist[-1]['loss']:.4f} at step {out['step']}")
    return out


if __name__ == "__main__":
    main()
