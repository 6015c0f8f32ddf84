"""Training CLI — the fault-tolerant train loop on one CUDA card (port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --reduced --device cpu --steps 5

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when no card
is there.  Weights are random, drawn from ``--seed`` (over a mesh each
rank draws its shards); the batches come from the synthetic, resumable
data pipeline.  ``--mesh DxM`` (or ``PxDxM``) above 1x1 runs one process
per rank under torchrun, e.g.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-34b --reduced --device cpu --mesh 2x2

(gloo on the CPU or where ranks share a card, NCCL with a card per
rank; launch/mesh.py).  Flags of later slices are refused with
the slice that brings them: ``--pipeline`` other than ``none`` (slice
9), ``--fault-plan``, ``--ckpt-every auto`` and ``--compress-pod``
(slices 10 and 9), and the whole-program planner, the static verifier
and ``--trace`` (slice 11): ``--plan local`` and ``--verify off`` only.
``--moe-dispatch`` pins the MoE dispatch schedule of an MoE arch
(``auto`` lets the managed cost model pick) and prints the decisions.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch import configs
from repro_torch.core import managed
from repro_torch.data.pipeline import DataConfig, SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.launch import mesh as launch_mesh
from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                          build_train_step)

#: flag -> the ROADMAP Queue 1 slice that brings it
LATER = {"--compress-pod": 9, "--fault-plan": 10, "--trace": 11}


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mdmp-mode", default="auto",
                    choices=["auto", "bulk", "interleaved"])
    ap.add_argument("--pipeline", default="none", choices=["none"],
                    help="pipeline stages come with a later slice")
    ap.add_argument("--plan", default="local", choices=["local"],
                    help="communication planning scope (the program "
                         "planner comes with a later slice)")
    ap.add_argument("--verify", default="off", choices=["off"],
                    help="static-verifier preflight (comes with a later "
                         "slice)")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM; above 1x1 under torchrun with a "
                         "matching WORLD_SIZE")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: under the "
                         "system's temporary directory)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", default=None,
                    help="checkpoint interval in steps")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=["bulk", "stream", "dense", "auto"],
                    help="MoE expert-dispatch schedule (auto = managed "
                         "cost-model decision)")
    ap.add_argument("--compress-pod", action="store_true")
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    for flag, slice_ in LATER.items():
        if getattr(args, flag[2:].replace("-", "_")):
            ap.error(f"{flag} comes with ROADMAP Queue 1 slice {slice_}")
    if args.ckpt_every == "auto":
        ap.error("--ckpt-every auto (the managed cadence) comes with "
                 "ROADMAP Queue 1 slice 10")

    device = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    if args.moe_dispatch is not None:
        if cfg.moe is None:
            ap.error(f"--moe-dispatch set but {args.arch} has no MoE "
                     "layers")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=args.moe_dispatch))
    ctx = launch_mesh.mesh_ctx(args.mesh, device, args.mdmp_mode)
    say = print if launch_mesh.is_main() else (lambda *a, **k: None)
    model = Model(cfg, ctx, device=device)
    say(f"arch={args.arch} params={cfg.param_count() / 1e6:.1f}M "
        f"mesh={tuple(ctx.axis_sizes.values())} device={device} "
        f"mdmp={args.mdmp_mode}")

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                          total_steps=args.steps,
                          moment_dtype=cfg.moment_dtype)
    step_fn = build_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    ckpt_every = (max(5, args.steps // 4) if args.ckpt_every is None
                  else int(args.ckpt_every))
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               ckpt_every=ckpt_every)
    if args.ckpt is not None:
        loop_cfg.ckpt_dir = args.ckpt
    if launch_mesh.dist.is_initialized():
        # every rank checkpoints its own shards
        loop_cfg.ckpt_dir = os.path.join(
            loop_cfg.ckpt_dir, f"rank{launch_mesh.dist.get_rank()}")
    loop = TrainLoop(step_fn, model, opt_cfg, data, loop_cfg)
    opt, s0 = (loop.resume_or_init(args.seed) if args.resume
               else loop.init_state(args.seed))
    out = loop.run(opt, s0)
    if args.moe_dispatch is not None:
        seen = set()
        for rec in managed.decision_log():
            key = (rec.op, rec.mode, rec.chunks, rec.nbytes)
            if rec.op == "moe_dispatch" and key not in seen:
                seen.add(key)
                say(f"decision moe_dispatch({rec.mode} g={rec.chunks} "
                      f"axis={rec.axis} a2a={rec.nbytes / 1e3:.1f}kB "
                      f"bulk={rec.predicted_bulk_s * 1e3:.3f}ms "
                      f"chosen={rec.predicted_interleaved_s * 1e3:.3f}ms)")
    for h in out["history"][:: max(1, len(out["history"]) // 10)]:
        say(f"  step {h['step']:4d} loss {h['loss']:.4f} "
              f"{h['time_s']:.2f}s")
    say(f"done at step {out['step']}, final loss "
          f"{out['history'][-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
