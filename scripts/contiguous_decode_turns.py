#!/usr/bin/env python3
"""Time the contiguous decode (``Generator.generate``) of several
checkouts, in turns, on one card.

    python3 scripts/contiguous_decode_turns.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (a ``git
archive`` of another commit unpacked under ``build/``, which
``.gitignore`` lists).  For each one, in the order given, a process of
its own draws phi4-mini-3.8b at its published size (32 layers, bf16,
seed ``chip_smoke.SEED``) from that checkout's ``src/`` and runs this
repository's ``chip_smoke.contiguous_decode_modes`` on it: 8 prompts of
96 tokens, 64 new tokens, a 256-position cache, each decode step as a
replay of the captured step ("graph") and from Python ("eager"), two
timed generations a mode in turns while another thread reads the SM
clock, a short generation a mode under torch.profiler, and (graph mode)
the f32 copies of the whole K/V cache a step alone in a graph.  A checkout
whose ``Generator`` has no step object decodes "eager" only.  Prints one
JSON line a checkout (host wall a decode step by turn, the SM clock over
each turn, the profiled host wall and device time a step, device time by
kind, a digest of the tokens: equal digests, equal tokens) and a table at
the end.  List the checkouts in turns (``build/parent build/final
build/final build/parent``): two versions compare only within one call.
Needs one CUDA card; no kernel is built (the contiguous decode launches
none).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one(root: str) -> dict:
    """The contiguous decode of the checkout at ``root``, both ways."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models.model import Model

    model = Model(configs.get_config("phi4-mini-3.8b"), device="cuda").init(
        torch.Generator(device="cuda").manual_seed(cs.SEED))
    res = cs.contiguous_decode_modes(
        torch, model, order=("graph", "eager", "eager", "graph"))
    out = {"checkout": root, "card": cs.card_line(), "modes": {}}
    for m in ("graph", "eager"):
        if m not in res:
            continue
        r = res[m]
        kinds: dict[str, float] = {}
        for name, ms in r["per_kernel"].items():
            kinds[cs.kind_of(name)] = kinds.get(cs.kind_of(name), 0.0) + ms
        out["modes"][m] = {
            "wall_ms": r["wall_ms"], "sm_mhz": r["mhz"],
            "prof_wall_ms": r["prof_wall_ms"], "device_ms": r["device_ms"],
            "by_kind_ms": {k: round(v, 4) for k, v in sorted(kinds.items())},
            "tokens_crc32": zlib.crc32(r["tokens"].tobytes()),
            "f32_cache_copies_ms": r.get("f32_cache_copies_ms")}
    out["peak_allocated_gb"] = round(torch.cuda.max_memory_allocated() / 1e9,
                                     2)
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
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
    print(f"contiguous decode, phi4-mini-3.8b bf16, 8 x (96 + 64), a "
          f"256-position cache; {results[0]['card']}:")
    for r in results:
        for m, v in r["modes"].items():
            turns = ", ".join(f"{w:.3f}" for w in v["wall_ms"])
            print(f"  {r['checkout']} {m}: host wall a step {turns} ms; "
                  f"profiled {v['prof_wall_ms']:.3f} ms host, "
                  f"{v['device_ms']:.3f} ms device; SM {v['sm_mhz']} MHz; "
                  f"tokens crc32 {v['tokens_crc32']:08x}; by kind "
                  f"{v['by_kind_ms']}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
