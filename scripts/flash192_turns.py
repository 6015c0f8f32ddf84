#!/usr/bin/env python3
"""Time the bf16 flash kernels at head_dim 192 (forward, carry step,
backward, block backward) in several checkouts, in turns, beside SDPA's
forward and backward, and the same at head_dim 128 as a control.

    python3 scripts/flash192_turns.py CHECKOUT ...

Each argument is the root of a checkout of this repository (for example a
``git archive`` of another commit unpacked under ``build/``, which
``.gitignore`` lists and pytest does not collect).  The checkouts run one
after another, each in its own process, in the order given, so list them
in turns (A B B A).  Each process builds its ``csrc/flash_attention.cu``
into its checkout's ``build/`` and times, in bf16 and causal:

  * nemotron-4-340b's call (B=1, S=4096, 96/8 heads, hd 192);
  * the reduced config's training call widened to hd 192 (2 x 2048, 4/2);
  * the head sweep at 1 x 4096, hd 192: 12/1, 24/2 and 48/4 heads (one
    to four kv groups; Q, dO and the f32 dQ workspace grow from ~75 MB
    to ~300 MB against the card's 50 MB L2);
  * the hd-128 controls: phi4-mini's training call (2 x 1024, 32/8) and
    ring attention's prefill call (1 x 8192, 32/8).

At each call it times ``flash_attention_fwd``, ``flash_attention_carry``
(from an empty carry), ``flash_attention_bwd`` and
``flash_attention_bwd_block`` and, in the same process and turns,
``F.scaled_dot_product_attention``'s forward and backward (autograd of
the call in a CUDA graph less the forward's graph).  Each time is device
milliseconds per call: ``CALLS`` calls over two input sets (so that a
call does not find its inputs in L2) captured in one CUDA graph
(``chip_smoke.graph_timer``), replayed ``REPS`` times, the median of
``TURNS`` readings, while ``chip_smoke.with_clocks`` samples the SM
clock.  Needs one CUDA card.  Prints one JSON line per process, then a
table by call and checkout with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (label, B, S, H, KV, hd); causal, bf16
CALLS_AT = (("nemotron 1x4096 96/8", 1, 4096, 96, 8, 192),
            ("training 2x2048 4/2", 2, 2048, 4, 2, 192),
            ("sweep 1x4096 12/1", 1, 4096, 12, 1, 192),
            ("sweep 1x4096 24/2", 1, 4096, 24, 2, 192),
            ("sweep 1x4096 48/4", 1, 4096, 48, 4, 192),
            ("hd 128 training 2x1024 32/8", 2, 1024, 32, 8, 128),
            ("hd 128 ring 1x8192 32/8", 1, 8192, 32, 8, 128))
CALLS = 4
REPS = 3
TURNS = 5
#: the kernels and SDPA's calls, in the order each turn times them
KINDS = ("fwd", "carry", "bwd", "bwd_block", "sdpa_fwd", "sdpa_fwd_bwd")


def one(root: str) -> dict:
    """Build the checkout's flash kernels and time them at each call."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    import torch.nn.functional as F

    from chip_smoke import SEED, graph_timer, with_clocks
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    built_s = build.build_all(["flash_attention"])["flash_attention"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = {}
    for label, b, s, h, kvh, hd in CALLS_AT:
        sets = [[torch.randn(dims, generator=gen, device="cuda").to(
            torch.bfloat16) for dims in ((b, s, h, hd), (b, s, kvh, hd),
                                         (b, s, kvh, hd), (b, s, h, hd))]
                for _ in range(2)]
        fwd = [fa.flash_attention_fwd(*st[:3]) for st in sets]
        blk = [(*st, r[1], (st[3].float() * r[0].float()).sum(-1))
               for st, r in zip(sets, fwd)]
        carry = [(*st[:3], *fa.init_partials(b, s, h, hd, device="cuda"))
                 for st in sets]
        lib_in = [[x.transpose(1, 2).contiguous() for x in st] for st in sets]
        leaves = [[x.detach().requires_grad_() for x in st[:3]]
                  for st in lib_in]
        calls = {
            "fwd": [lambda st=st: fa.flash_attention_fwd(*st[:3])
                    for st in sets],
            "carry": [lambda a=a: fa.flash_attention_carry(*a, causal=True)
                      for a in carry],
            "bwd": [lambda st=st, r=r: fa.flash_attention_bwd(*st[:3], *r,
                                                              st[3])
                    for st, r in zip(sets, fwd)],
            "bwd_block": [lambda a=a: fa.flash_attention_bwd_block(
                *a, causal=True) for a in blk],
            "sdpa_fwd": [lambda st=st: F.scaled_dot_product_attention(
                *st[:3], is_causal=True, enable_gqa=True) for st in lib_in],
            "sdpa_fwd_bwd": [lambda st=st, lv=lv: torch.autograd.grad(
                F.scaled_dot_product_attention(*lv, is_causal=True,
                                               enable_gqa=True),
                lv, st[3]) for st, lv in zip(lib_in, leaves)],
        }
        timers = {k: graph_timer(torch, calls[k] * (CALLS // 2))
                  for k in KINDS}

        def turns(timers=timers):
            got = {k: [] for k in timers}
            for _ in range(TURNS):
                for k, t in timers.items():
                    got[k].append(t(REPS))
            return got

        got, clocks = with_clocks(turns)
        med = {k: statistics.median(v) for k, v in got.items()}
        rows[label] = {
            "fwd_ms": med["fwd"], "carry_ms": med["carry"],
            "sdpa_fwd_ms": med["sdpa_fwd"],
            "bwd_ms": med["bwd"], "bwd_block_ms": med["bwd_block"],
            "sdpa_bwd_ms": med["sdpa_fwd_bwd"] - med["sdpa_fwd"],
            "bwd_ms_per_head": med["bwd"] / (b * h),
            "sm_mhz": statistics.median(c[1] for c in clocks) if clocks
            else None,
            "turns": {k: got[k] for k in ("fwd", "carry", "bwd")}}
        del sets, fwd, blk, carry, lib_in, leaves, calls, timers
        torch.cuda.empty_cache()
    return {"checkout": root, "built_s": built_s,
            "card": torch.cuda.get_device_name(0), "calls": rows}


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
    print(f"flash forward / carry / SDPA forward, backward / block backward "
          f"/ SDPA backward, bf16, causal, device ms per call (median of "
          f"{TURNS} replays of {REPS} x {CALLS} calls in a CUDA graph; SM "
          f"clock the median nvidia-smi reading); {card}:")
    for label, *_ in CALLS_AT:
        print(f"  {label}:")
        for r in results:
            c = r["calls"][label]
            print(f"    {r['checkout']}: fwd {c['fwd_ms']:.4f}, carry "
                  f"{c['carry_ms']:.4f}, SDPA fwd {c['sdpa_fwd_ms']:.4f}; "
                  f"bwd {c['bwd_ms']:.4f} ({c['bwd_ms_per_head'] * 1e3:.2f} "
                  f"us a head), block {c['bwd_block_ms']:.4f}, SDPA bwd "
                  f"{c['sdpa_bwd_ms']:.4f}; SM {c['sm_mhz']} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
