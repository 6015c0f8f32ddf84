#!/usr/bin/env python3
"""Time the port's full-width phi4-mini training step in several
checkouts, in turns.

    python3 scripts/train_step_turns.py CHECKOUT ...

Each argument is the root of a checkout of this repository (for example a
``git archive`` of another commit unpacked under ``build/``).  The
checkouts run one after another, each in its own process, in the order
given, so list them in turns (A B B A).  Each process builds its flash
kernels into its checkout's ``build/``, draws phi4-mini-3.8b at its
published size (bf16, seed 0) and runs ``chip_smoke.py`` phase 5's step
(``build_train_step``, AdamW with f32 moments, B=2, S=1024): 2 warm-up
steps, ``STEPS`` timed ones (host wall, after a device synchronize), and
one more under ``torch.profiler`` for its device time by kind.  Needs one
CUDA card and about 55 GB of it.  Prints one JSON line per process and a
table of medians by checkout at the end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


def one(root: str) -> dict:
    """Build, run and time the training step of the checkout at root."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SEED, TRAIN_ATTN, device_ms_by_kernel, kind_of
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import build
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import build_train_step

    built_s = build.build_all(["flash_attention"])["flash_attention"]
    cfg = configs.get_config("phi4-mini-3.8b")
    b, s = TRAIN_ATTN["b"], TRAIN_ATTN["s"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Model(cfg, device="cuda").init(gen)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                          moment_dtype=cfg.moment_dtype)
    opt = adamw_init(model.params(), opt_cfg)
    step = build_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))

    def batch(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in data.global_batch_at(i).items()}

    walls, losses = [], []
    for i in range(2 + STEPS):
        x = batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, metrics = step(opt, x)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    x = batch(2 + STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt, metrics = step(opt, x)
        float(metrics["loss"])
        torch.cuda.synchronize()
    per_kernel = device_ms_by_kernel(torch, prof, 1)
    kinds: dict[str, float] = {}
    for name, ms in per_kernel.items():
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms
    walls.sort()
    return {"checkout": root, "built_s": built_s,
            "card": torch.cuda.get_device_name(0),
            "wall_ms": {"median": walls[len(walls) // 2], "min": walls[0],
                        "max": walls[-1]},
            "device_ms": sum(per_kernel.values()),
            "by_kind_ms": {k: round(v, 2) for k, v in sorted(kinds.items())},
            "losses": losses}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    results = []
    for root in argv:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True,
                             text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    print(f"phi4-mini-3.8b training step (B=2, S=1024, bf16, f32 AdamW "
          f"moments), median of {STEPS} after 2 warm-up steps; {card}:")
    for r in results:
        print(f"  {r['checkout']}: host wall {r['wall_ms']['median']:.1f} ms "
              f"({r['wall_ms']['min']:.1f}-{r['wall_ms']['max']:.1f}), "
              f"device {r['device_ms']:.1f} ms, by kind {r['by_kind_ms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
