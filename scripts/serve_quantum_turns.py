#!/usr/bin/env python3
"""The serving path's decode steps of several checkouts, in turns, on one card.

    python3 scripts/serve_quantum_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding a checkout's ``chip_smoke.py`` and
``src/`` (a ``git archive`` unpacked under ``build/``, which ``.gitignore``
lists).  For each one, in the order given, a process of its own builds that
checkout's paged-attention kernel (into its own ``build/``) and, through
that checkout's ``chip_smoke.serve`` and ``chip_smoke.profile_decode_step``,
serves three cells one after another, bf16, seeded weights:

  * phi4-mini-3.8b uncut, phase 3's 8 requests (64-256 + 32 tokens);
  * moonshot-v1-16b-a3b uncut, phase 8's 8 requests (+ 16 tokens);
  * nemotron-4-340b at full width, 2 of 96 layers, phase 3's requests.

For each cell it prints the engine's way of running a quantum, the host
wall of ``ServeEngine.run`` (warm-up included) over its decode steps, mean
TTFT and TPOT, the quanta and the chosen C, the paged launches, a digest of
the served tokens (equal digests: equal tokens) and the SM clock's range
while it served (nvidia-smi, read by another thread); then the checkout's
profile of one decode step (host wall, device time by kind, busy share).
The last lines are one summary line a run and cell.  List the checkouts in
turns (``build/parent build/final build/final build/parent``): two versions
compare only within one call, on one card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

RUN = r"""
import dataclasses, os, sys, time, zlib
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import numpy as np
import torch
from repro_torch.kernels import build
build.build_all(["paged_attention"])
import chip_smoke as cs
from repro_torch import configs
from repro_torch.core import managed
from repro_torch.models.model import Model

print(f"card: {cs.card_line()}", flush=True)
for arch, layers, make, new in (("phi4-mini-3.8b", None, "make_prompts", 32),
                                ("moonshot-v1-16b-a3b", None, "moe_prompts",
                                 16),
                                ("nemotron-4-340b", 2, "make_prompts", 32)):
    cfg = configs.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(cs.SEED))
    prompts = getattr(cs, make)(cfg.vocab_size)
    with managed.capture_decisions() as cap:
        (got, eng, wall, launches), clocks = cs.with_clocks(
            lambda: cs.serve(torch, model, prompts, new, schedule="auto"))
    s = eng.metrics.summary()
    chunks = [r.chunks for r in cap.records if r.op == "serve_schedule"]
    mhz = [c[1] for c in clocks] or [0.0]
    digest = zlib.crc32(np.concatenate(got).astype(np.int32).tobytes())
    print(f"cell {arch} x {cfg.n_layers} layers: quantum "
          f"{getattr(eng, 'quantum_mode', 'python loop')}; run {wall:.4f} s "
          f"over {eng.decode_steps} decode steps = "
          f"{wall / eng.decode_steps * 1e3:.3f} ms host wall a step; TTFT "
          f"{s['mean_ttft_s'] * 1e3:.3f} ms, TPOT "
          f"{s['mean_tpot_s'] * 1e3:.3f} ms; {s['quanta']} quanta, C "
          f"{chunks}; paged launches {launches}; tokens crc32 {digest:08x}; "
          f"SM {min(mhz):.0f}-{max(mhz):.0f} MHz", flush=True)
    del eng, got
    torch.cuda.empty_cache()
    cs.profile_decode_step(torch, model)
    del model
    torch.cuda.empty_cache()
"""


def summary(lines: list[str]) -> list[str]:
    """One line a cell: its serving line, then each profiled step's wall,
    device time and busy share."""
    out, cell = [], None
    for line in lines:
        if line.startswith("cell "):
            cell = [line[5:]]
            out.append(cell)
            continue
        m = re.search(r"one decode step \(([^)]*)\)(?:, ([^:]*))?: "
                      r"([\d.]+) ms host wall, ([\d.]+) ms device time.*?"
                      r"busy share ([\d.]+)%", line)
        if m and cell is not None:
            cell.append(f"step {m.group(2) or 'eager'} ({m.group(1)}): "
                        f"{m.group(3)} ms host, {m.group(4)} ms device, "
                        f"busy {m.group(5)}%")
    return ["; ".join(c) for c in out]


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    out = []
    for i, checkout in enumerate(argv):
        name = os.path.basename(os.path.normpath(checkout))
        proc = subprocess.run([sys.executable, "-c", RUN, checkout],
                              capture_output=True, text=True, timeout=1800)
        lines = proc.stdout.splitlines()
        for line in lines:
            print(f"[{i} {name}] {line}", flush=True)
        if proc.returncode != 0:
            print(f"[{i} {name}] exited {proc.returncode}: "
                  f"{proc.stderr[-3000:]}", flush=True)
            return 1
        out += [f"run {i} {name}: {s}" for s in summary(lines)]
    for line in out:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
