#!/usr/bin/env python3
"""Measure how far a resumed training run lies from uninterrupted ones,
and how far a broken restore would move it.

    python3 scripts/fault_spread.py [RUNS] [--broken]

Runs ``chip_smoke.py`` phase 14 (d)'s training on one CUDA card:
train_100m's model uncut in bf16 through ``TrainLoop`` with the managed
checkpoint cadence, ``FAULT_STEPS`` steps of 8 x 256 from seed 0.  First
RUNS uninterrupted runs (default 4), then one under the phase's
``OwnSavesPlan`` (a rank death the step after the first save, a corrupt
event the step after the next), and with ``--broken`` that faulted run
again under three restores broken on purpose: the optimizer state
dropped, only its moments dropped, and the step counter one back.
Prints each run's saves, restores and plan, the largest loss gap of
every pair of uninterrupted runs (the bf16 flash backward sums in an
order that varies from run to run), and each faulted run's largest gap
from each uninterrupted run.  ``chip_smoke.py``'s
``FAULT_SPREAD_FACTOR`` is set from these numbers.  Needs about 10 GB of
the card and 2-3 minutes with ``--broken``.
"""

from __future__ import annotations

import itertools
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("fault_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import adamw_init

    runs = int(next((a for a in argv if a.isdigit()), 4))
    t0 = time.perf_counter()
    print(cs.card_line(), flush=True)
    build.build_all(["flash_attention"])

    class BrokenRestore(cs.OwnSavesPlan):
        """The phase's plan over a loop whose restores are broken."""

        def __init__(self, kind):
            super().__init__()
            self.kind = kind

        def attach(self, loop):
            super().attach(loop)
            resume = loop.resume_or_init

            def broken(seed=0):
                opt, step = resume(seed)
                fresh = adamw_init(loop.model.params(), loop.opt_cfg)
                if self.kind == "optimizer state dropped":
                    opt = fresh
                elif self.kind == "moments dropped":
                    opt = dict(fresh, step=opt["step"])
                else:
                    step -= 1
                return opt, step

            loop.resume_or_init = broken

    plans = {f"uninterrupted {i}": None for i in range(runs)}
    plans["resumed"] = cs.OwnSavesPlan()
    if "--broken" in argv:
        for kind in ("optimizer state dropped", "moments dropped",
                     "step counter one back"):
            plans[f"resumed, {kind}"] = BrokenRestore(kind)
    losses = {}
    tmp = tempfile.mkdtemp(prefix="fault_spread_")
    try:
        for i, (name, plan) in enumerate(plans.items()):
            loop, out, losses[name], _, _ = cs.fault_run(
                torch, tmp, f"r{i}", plan)
            print(f"{name}: saves {[r.step for r in loop.ckpt_metrics.saves]}"
                  f", restores {[r.step for r in loop.ckpt_metrics.restores]}"
                  f", plan {plan.spec if plan else None!r}, intervals "
                  f"{[d.interval for d in loop.ckpt_decisions]}, host wall "
                  f"{out['wall_s']:.2f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def gap(x, y):
        return max(abs(p - q) for p, q in zip(x, y))

    base = [losses[f"uninterrupted {i}"] for i in range(runs)]
    pairs = [gap(x, y) for x, y in itertools.combinations(base, 2)]
    print(f"uninterrupted pairs: {pairs}")
    for name in plans:
        if name.startswith("resumed"):
            print(f"{name}: {[gap(x, losses[name]) for x in base]}")
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
