#!/usr/bin/env python3
"""Time the flash backward on its SIMT kernels in several checkouts, in
turns.

    python3 scripts/simt_bwd_turns.py CHECKOUT ...

Each argument is the root of a checkout of this repository (for example a
``git archive`` of another commit unpacked under ``build/``).  The
checkouts run one after another, each in its own process, in the order
given, so list them in turns (A B B A).  Each process builds its flash
kernels into its checkout's ``build/`` and times
``flash_attention_bwd`` (the dsum pre-pass, the dK/dV kernel and the dQ
kernel) wherever it runs the SIMT kernels: bf16 at head_dim 16 (the
reduced configs; the quickstart's call and a 2 x 2048 call) and f32 at
head_dim 16, 64 and 128 (the oracle; 128 at the training shape).  Each
time is device milliseconds per call: ``CALLS`` calls captured in one
CUDA graph (``chip_smoke.graph_timer``), replayed ``REPS`` times, the
median of ``TURNS`` such readings.  Needs one CUDA card.  Prints one JSON
line per process and a table by checkout at the end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (dtype, B, S, H, KV, hd), causal
SHAPES = (("bfloat16", 8, 128, 4, 1, 16),
          ("bfloat16", 2, 2048, 8, 2, 16),
          ("float32", 2, 2048, 8, 2, 16),
          ("float32", 1, 1024, 16, 4, 64),
          ("float32", 2, 1024, 32, 8, 128))
CALLS = 10
REPS = 10
TURNS = 5


def label(shape) -> str:
    dtype, b, s, h, kvh, hd = shape
    return f"{dtype} hd {hd} B={b} S={s} {h}/{kvh}"


def one(root: str) -> dict:
    """Build the checkout's flash kernels and time its SIMT backward."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from chip_smoke import SEED, graph_timer
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    built_s = build.build_all(["flash_attention"])["flash_attention"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ms = {}
    for shape in SHAPES:
        dtype, b, s, h, kvh, hd = shape
        q, k, v, dout = (torch.randn(dims, generator=gen, device="cuda").to(
            getattr(torch, dtype)) for dims in ((b, s, h, hd), (b, s, kvh, hd),
                                                (b, s, kvh, hd), (b, s, h, hd)))
        out, lse = fa.flash_attention_fwd(q, k, v)
        timer = graph_timer(torch, [
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout)] * CALLS)
        readings = sorted(timer(REPS) for _ in range(TURNS))
        ms[label(shape)] = readings[TURNS // 2]
    return {"checkout": root, "built_s": built_s,
            "card": torch.cuda.get_device_name(0), "bwd_ms": ms}


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
    print(f"flash_attention_bwd on the SIMT kernels, causal, device ms per "
          f"call (median of {TURNS} replays of {REPS} x {CALLS} calls in a "
          f"CUDA graph); {card}:")
    for shape in SHAPES:
        cells = ", ".join(f"{r['checkout']} {r['bwd_ms'][label(shape)]:.4f}"
                          for r in results)
        print(f"  {label(shape)}: {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
