"""End to end: train a ~110M-parameter decoder with the production
stack — managed collectives, the FSDP layout, the fault-tolerant loop,
async checkpoints (port of ``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300

Runs on ``cuda`` unless ``--device cpu`` is given, on a (1, 1) mesh.
``--pipeline gpipe|1f1b|interleaved|auto`` runs a (P, 1, 1) mesh whose
pod axis is the pipeline's stages, P the world size (one process, or one
per rank under torchrun: ``torchrun --nproc-per-node 2 -m
repro_torch.examples.train_100m --pipeline 1f1b --device cpu``), and
prints the ``pipeline_schedule`` decision.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.core import managed
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as launch_mesh
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
                    help="run the pod axis as pipeline stages; 'auto' "
                         "lets the managed runtime pick the schedule "
                         "(cost model + decision trail)")
    args = ap.parse_args(argv)

    cfg = CONFIG_100M
    device = resolve_device(args.device)
    say = print if launch_mesh.is_main() else (lambda *a, **k: None)
    say(f"model: {cfg.param_count()/1e6:.0f}M params")
    if args.pipeline != "none":
        world = int(os.environ.get("WORLD_SIZE", "1"))
        ctx = launch_mesh.mesh_ctx(f"{world}x1x1", device, "auto")
    else:
        ctx = MeshCtx({"data": 1, "model": 1}, mdmp_mode="auto")
    model = Model(cfg, ctx, device=device)
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    managed.clear_decision_log()
    step_fn = build_train_step(model, opt_cfg, pipeline=args.pipeline,
                               global_batch=args.batch, seq_len=args.seq)
    say(f"train step: {step_fn.step_mode}")
    for rec in managed.decision_log():
        if rec.op == "pipeline_schedule":
            say(f"pipeline schedule: {rec.mode} M={rec.chunks} "
                f"(bulk {rec.predicted_bulk_s * 1e3:.2f}ms -> "
                f"{rec.predicted_interleaved_s * 1e3:.2f}ms)")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    ckpt_dir = args.ckpt
    if launch_mesh.dist.is_initialized():
        # every rank checkpoints its own state
        ckpt_dir = os.path.join(ckpt_dir,
                                f"rank{launch_mesh.dist.get_rank()}")
    loop = TrainLoop(step_fn, model, opt_cfg, data,
                     TrainLoopConfig(total_steps=args.steps, ckpt_every=50,
                                     ckpt_dir=ckpt_dir))
    opt, s0 = (loop.resume_or_init() if args.resume else loop.init_state())
    out = loop.run(opt, s0)
    hist = out["history"]
    for h in hist[:: max(1, len(hist) // 12)]:
        say(f"  step {h['step']:4d} loss {h['loss']:.4f} "
            f"{h['time_s']:.2f}s")
    say(f"final loss {hist[-1]['loss']:.4f} at step {out['step']}")
    return out


if __name__ == "__main__":
    main()
