#!/usr/bin/env python3
"""Phase 8's MoE training step of several checkouts, in turns, on one card.

    python3 scripts/moe_train_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is a directory holding a checkout's ``chip_smoke.py`` and
``src/`` (a ``git archive`` unpacked under ``build/``, which ``.gitignore``
lists).  For each one, in the order given, a process of its own builds
that checkout's flash and grouped-expert kernels (into its own
``build/``) and runs its ``chip_smoke.phase_moe_train``:
moonshot-v1-16b-a3b at full width, 4 layers, bf16, B=2 x S=1024, three
AdamW steps and a fourth under ``torch.profiler``.  Its lines are printed
as they come, each behind the checkout's name, then one summary line a
run: host wall per step, the profiled step's host wall and device time,
the device time of each kind of kernel and the peak memory.  List the
checkouts in turns (``build/parent build/final build/final
build/parent``): two versions compare only within one call, on one card.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

RUN = r"""
import os, sys
root = os.path.abspath(sys.argv[1])
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
from repro_torch.kernels import build
build.build_all(["flash_attention", "grouped_matmul"])
import chip_smoke
chip_smoke.phase_moe_train(torch)
"""


def summary(lines: list[str]) -> str:
    """The run's numbers, read from phase_moe_train's lines."""
    text = "\n".join(lines)
    walls = re.search(r"host wall per step \[([^\]]*)\] ms", text)
    peak = re.search(r"peak memory ([\d.]+) GB", text)
    # the first profiled step: the step's only one before the step was a
    # CUDA graph, its replay since
    prof = re.search(r"under torch.profiler:? ([\d.]+) ms host wall, "
                     r"([\d.]+) ms device time", text)
    kinds = re.search(r"MoE training step(?: \(one CUDA graph replay\))? "
                      r"device time by kind: (.*)", text)
    return (f"host wall per step [{walls.group(1) if walls else '?'}] ms; "
            f"profiled step {prof.group(1) if prof else '?'} ms host wall, "
            f"{prof.group(2) if prof else '?'} ms device; peak "
            f"{peak.group(1) if peak else '?'} GB; by kind: "
            f"{kinds.group(1) if kinds else '?'}")


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
        out.append(f"run {i} {name}: {summary(lines)}")
    for line in out:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
