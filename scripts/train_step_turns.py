#!/usr/bin/env python3
"""Time the port's training step in several checkouts, in turns.

    python3 scripts/train_step_turns.py [--cells A,B,...] CHECKOUT ...

Each argument is the root of a checkout of this repository (for example a
``git archive`` of another commit unpacked under ``build/``).  The
checkouts run one after another in the order given, so list them in turns
(A B B A).  For each checkout every cell runs in a process of its own,
which builds the flash and grouped-expert kernels into the checkout's
``build/``, draws the cell's model from seed 0 and runs its
``build_train_step`` (AdamW, f32 moments): 2 warm-up steps, ``steps``
timed ones (host wall, after a device synchronize, while another thread
reads the SM clock with nvidia-smi), and one more under
``torch.profiler`` for its device time by kind.  The cells (``--cells``,
default all three):

  * ``phi4``: phi4-mini-3.8b at its published size, bf16, B=2, S=1024
    (``chip_smoke.py`` phase 5's step; about 55 GB of the card);
  * ``moonshot4``: moonshot-v1-16b-a3b at full width, 4 of its 48 layers,
    bf16, B=2, S=1024 (phase 8's step);
  * ``train_100m``: ``examples/train_100m.py``'s model and defaults, bf16,
    B=8, S=256 (phase 10's step).

A checkout whose step object has a ``step_mode`` (a captured CUDA graph or
eager) prints it; an older checkout's step runs from Python.  Prints one
JSON line per process (host wall median and range, profiled host wall and
device time, device time by kind, peak memory allocated and reserved over
the steps, the losses, the SM clock's range) and a table by checkout and
cell at the end.  Needs one CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: cell -> timed steps
CELLS = {"phi4": 6, "moonshot4": 6, "train_100m": 20}


def setup(cell: str):
    """(model, opt_cfg, data) of a cell, on the card."""
    import torch

    from chip_smoke import SEED, TRAIN_ATTN
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if cell == "train_100m":
        from repro_torch.examples.train_100m import CONFIG_100M
        from repro_torch.parallel.sharding import MeshCtx

        cfg, b, s = CONFIG_100M, 8, 256
        ctx = MeshCtx({"data": 1, "model": 1}, mdmp_mode="auto")
        model = Model(cfg, ctx, device="cuda").init(gen)
        opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=300)
    else:
        cfg = configs.get_config("phi4-mini-3.8b" if cell == "phi4"
                                 else "moonshot-v1-16b-a3b")
        if cell == "moonshot4":
            cfg = dataclasses.replace(cfg, n_layers=4)
        b, s = TRAIN_ATTN["b"], TRAIN_ATTN["s"]
        model = Model(cfg, device="cuda").init(gen)
        opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                              moment_dtype=cfg.moment_dtype)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))
    return model, opt_cfg, data


def one(root: str, cell: str) -> dict:
    """Build, run and time one cell's training step of the checkout at
    root."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms_by_kernel, kind_of, with_clocks
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.train_loop import build_train_step

    built = build.build_all(["flash_attention", "grouped_matmul"])
    model, opt_cfg, data = setup(cell)
    opt = adamw_init(model.params(), opt_cfg)
    step = build_train_step(model, opt_cfg)
    n_steps = CELLS[cell]

    def batch(i):
        return {k: torch.from_numpy(v).to("cuda")
                for k, v in data.global_batch_at(i).items()}

    walls, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        nonlocal opt
        for i in range(2 + n_steps):
            x = batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt, metrics = step(opt, x)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)

    _, clocks = with_clocks(run)
    peak = (torch.cuda.max_memory_allocated() / 1e9,
            torch.cuda.max_memory_reserved() / 1e9)
    x = batch(2 + n_steps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, metrics = step(opt, x)
        float(metrics["loss"])
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    per_kernel = device_ms_by_kernel(torch, prof, 1)
    kinds: dict[str, float] = {}
    for name, ms in per_kernel.items():
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms
    walls.sort()
    mhz = [c[1] for c in clocks]
    return {"checkout": root, "cell": cell, "built_s": built,
            "card": torch.cuda.get_device_name(0),
            "step_mode": getattr(step, "step_mode", "eager (no TrainStep)"),
            "wall_ms": {"median": walls[len(walls) // 2], "min": walls[0],
                        "max": walls[-1]},
            "profiled_wall_ms": prof_wall,
            "device_ms": sum(per_kernel.values()),
            "by_kind_ms": {k: round(v, 2) for k, v in sorted(kinds.items())},
            "peak_allocated_gb": round(peak[0], 2),
            "peak_reserved_gb": round(peak[1], 2),
            "sm_mhz": [min(mhz), max(mhz)] if mhz else None,
            "losses": losses}


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]), argv[2])),
              flush=True)
        return 0
    cells = list(CELLS)
    if argv and argv[0] == "--cells":
        cells = argv[1].split(",")
        argv = argv[2:]
    if not argv or any(c not in CELLS for c in cells):
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    results = []
    for root in argv:
        for cell in cells:
            out = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--one", root, cell], capture_output=True,
                                 text=True, timeout=1200)
            if out.returncode != 0:
                print(out.stdout[-2000:], out.stderr[-4000:],
                      file=sys.stderr)
                return out.returncode
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            results.append(json.loads(line))
    print(f"training steps after 2 warm-up steps (median, range); {card}:")
    for r in results:
        busy = r["device_ms"] / r["profiled_wall_ms"] * 100
        print(f"  {r['checkout']} {r['cell']} ({r['step_mode']}): host wall "
              f"{r['wall_ms']['median']:.2f} ms ({r['wall_ms']['min']:.2f}-"
              f"{r['wall_ms']['max']:.2f}); profiled step "
              f"{r['profiled_wall_ms']:.2f} ms host, {r['device_ms']:.2f} ms "
              f"device (busy {busy:.1f}%); peak {r['peak_allocated_gb']} GB "
              f"allocated, {r['peak_reserved_gb']} GB reserved; SM "
              f"{r['sm_mhz']} MHz; "
              f"by kind {r['by_kind_ms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
