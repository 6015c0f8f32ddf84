#!/usr/bin/env python3
"""Time the grouped-expert FFN's tensor-core backward of several checkouts
in turns, at moonshot-v1-16b-a3b's training call, step by step.

    python3 scripts/grouped_bwd_turns.py CHECKOUT ...

Each argument is the root of a checkout of this repository (for example a
``git archive`` of another commit unpacked under ``build/``, which
``.gitignore`` lists and pytest does not collect).  The checkouts run one
after another, each in its own process, in the order given, so list them
in turns (A B B A).  Each process builds its ``csrc/grouped_matmul.cu``
into its checkout's ``build/`` and, at the training call of
``chip_smoke.MOE_TRAIN`` (G = E = 64, C = 240, D 2048, F 1408, swiglu,
bf16, valid counts from ``chip_smoke.routed_counts``):

  * times ``grouped_expert_ffn_bwd`` (two input sets, so that a call does
    not find the last call's weights in L2), the all-empty call (every
    ``valid`` 0), the call at ``PHASE8_COUNTS`` (the skewed counts of the
    4-layer training step's router) and the yardstick of
    ``chip_smoke.phase_grouped_bwd`` (autograd through three bf16
    ``torch.bmm`` on the padded buffers), in
    ``TURNS`` turns of ``REPS`` CUDA-graph replays each, while
    ``chip_smoke.with_clocks`` reads the SM clock;
  * profiles ``PROFILED`` calls of each with ``torch.profiler`` and gives
    each kernel's device time a call, summed into the backward's three
    steps by name (``act``: step 1, ``dh``: step 2, ``dw``: step 3);
  * profiles the forward (``grouped_expert_ffn``) at the same call, by
    kernel: its up launch is step 1's tile and walk without dact;
  * reads registers, stack and local memory of every backward kernel with
    ``cuobjdump -res-usage`` from the built library.

Needs one CUDA card.  Prints one JSON line per process, then a table by
checkout with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = 5
REPS = 10
PROFILED = 4
#: the valid counts of phase 8's last backward call of its second step
#: (moonshot at 4 layers, seed 0, the router at its initial weights:
#: 4,255 kept rows, 13 groups full and 8 empty), timed as a second call
PHASE8_COUNTS = (
    8, 41, 5, 240, 60, 17, 3, 1, 42, 14, 1, 7, 44, 87, 0, 8, 71, 69, 0, 5, 3,
    95, 240, 0, 240, 240, 4, 1, 240, 113, 240, 240, 2, 6, 240, 30, 5, 240,
    77, 54, 3, 14, 12, 97, 19, 0, 21, 240, 3, 23, 240, 0, 8, 1, 240, 240,
    35, 2, 0, 0, 0, 19, 1, 4)
def one(root: str) -> dict:
    """Build the checkout's grouped kernels, then time and profile them."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as gm

    built_s = build.build_all(["grouped_matmul"])["grouped_matmul"]
    p = cs.MOE_TRAIN
    shape = (p["e"], p["c"], p["d"], p["f"], p["e"])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 20)
    rng = np.random.default_rng(cs.SEED + 20)
    sets = []
    for _ in range(2):
        valid = cs.routed_counts(torch, rng, p)
        sets.append((*cs.grouped_bwd_inputs(torch, gen, shape,
                                            torch.bfloat16, valid), valid))
    empty = torch.zeros_like(sets[0][5])
    skewed = torch.tensor(PHASE8_COUNTS, dtype=torch.int32, device="cuda")
    kept = sum(int(s[5].sum()) for s in sets) / len(sets)

    def autograd_bmm3(s):
        hh, a, b, c2, y = s[:5]
        leaves = [t.detach().requires_grad_() for t in (hh, a, b, c2)]
        out = torch.bmm(torch.bmm(leaves[0], leaves[1])
                        * torch.bmm(leaves[0], leaves[2]), leaves[3])
        return torch.autograd.grad(out, leaves, y)

    calls = {
        "kernel": [lambda s=s: gm.grouped_expert_ffn_bwd(*s[:4], s[5], s[4],
                                                         "swiglu")
                   for s in sets],
        "empty": [lambda s=s: gm.grouped_expert_ffn_bwd(*s[:4], empty, s[4],
                                                        "swiglu")
                  for s in sets],
        "phase8": [lambda s=s: gm.grouped_expert_ffn_bwd(*s[:4], skewed,
                                                         s[4], "swiglu")
                   for s in sets],
        "yardstick": [lambda s=s: autograd_bmm3(s) for s in sets],
    }
    timers = {k: cs.graph_timer(torch, fns * 2) for k, fns in calls.items()}

    def turns():
        got = {k: [] for k in timers}
        for _ in range(TURNS):
            for k, t in timers.items():
                got[k].append(t(REPS))
        return got

    got, clocks = cs.with_clocks(turns)
    profiled = {}
    for k in ("kernel", "empty", "phase8"):
        steps, kernels = cs.bwd_step_ms(torch, calls[k], PROFILED)
        profiled[k] = {"kernels": kernels, "steps": steps}
    forward = [lambda s=s: gm.grouped_expert_ffn(*s[:4], s[5], mlp="swiglu")
               for s in sets]
    for f in forward:
        f()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILED):
            forward[i % 2]()
        torch.cuda.synchronize()
    fwd_kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        found = re.search(r"ffn_(?:up|down)_\w+_kernel<[^>]*>", ev.key)
        if us and found:
            fwd_kernels[found.group(0)] = us / 1e3 / PROFILED
    flops, nbytes = gm.grouped_bwd_work(kept, *shape, 2)
    bound_ms, bound_by = cs.roof_ms(flops, nbytes, "bfloat16")
    # the all-empty call's least work: dh and every weight gradient
    # written once as zeros
    zeros = (shape[0] * shape[1] * shape[2] + 3 * shape[4] * shape[2]
             * shape[3]) * 2
    usage = cs.res_usage(build, "grouped_matmul",
                         r"ffn_bwd_[a-z]+_w?g?mma_kernel")
    return {"checkout": root, "built_s": built_s,
            "card": torch.cuda.get_device_name(0), "kept": kept,
            "ms": {k: statistics.median(v) for k, v in got.items()},
            "turns": got, "bound_ms": bound_ms, "bound_by": bound_by,
            "empty_write_bound_ms": zeros / cs.HBM_BW * 1e3,
            "sm_mhz": [min(c[1] for c in clocks), max(c[1] for c in clocks)]
            if clocks else None,
            "profiled": profiled, "forward": fwd_kernels,
            "res_usage": usage}


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
    print(f"grouped_expert_ffn_bwd at moonshot's training call (G = E = 64, "
          f"C = 240, D 2048, F 1408, swiglu, bf16), device ms a call: the "
          f"median of {TURNS} turns of {REPS} replays of 4 calls in a CUDA "
          f"graph; steps from torch.profiler over {PROFILED} calls; {card}:")
    for r in results:
        ms, pk, pe = r["ms"], r["profiled"]["kernel"], r["profiled"]["empty"]
        steps = ", ".join(f"{s} {v:.4f}" for s, v in pk["steps"].items())
        esteps = ", ".join(f"{s} {v:.4f}" for s, v in pe["steps"].items())
        p8 = ", ".join(f"{s} {v:.4f}" for s, v in
                       r["profiled"]["phase8"]["steps"].items())
        regs = "; ".join(f"{k} {v}"
                         for k, v in sorted(r["res_usage"].items()))
        print(f"  {r['checkout']}: backward {ms['kernel']:.4f} "
              f"({min(r['turns']['kernel']):.4f}-"
              f"{max(r['turns']['kernel']):.4f}; {steps}), bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}, "
              f"{r['bound_ms'] / ms['kernel'] * 100:.1f}%), all-empty "
              f"{ms['empty']:.4f} ({esteps}; write bound "
              f"{r['empty_write_bound_ms']:.4f}), yardstick "
              f"{ms['yardstick']:.4f}; phase 8's counts "
              f"{ms['phase8']:.4f} ({p8}); the forward by kernel "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["forward"].items())
              + f"; SM {r['sm_mhz']} MHz; {regs}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
