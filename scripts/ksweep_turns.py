#!/usr/bin/env python3
"""Time the port's Jacobi stencil kernels in several checkouts, in turns.

    python3 scripts/ksweep_turns.py CHECKOUT ...

Each argument is the root of a checkout of this repository (for example a
``git archive`` of another commit unpacked under ``build/``, which
``.gitignore`` lists and pytest does not collect).  The checkouts run one
after another, each in its own process, in the order given, so list them
in turns (A B B A).  Each process builds its ``csrc/stencil.cu`` into its
checkout's ``build/``, holds the k-sweep kernel at 16386 x 16386 f32 (zero
ghost rows frozen, the main path's call) to its plain version bit for bit
at each k, then times ``jacobi_step`` (one sweep, zero halo rows) and
``jacobi_ksweep_parts`` at each k with ``chip_smoke.py``'s CUDA-graph
timer, while its nvidia-smi reader samples the SM clock and power.  Needs
one CUDA card.  Prints one JSON line per process and a table of medians by
checkout at the end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16386
KS = (2, 4, 8)
TURNS = 5          # timing turns inside one process
REPS = 5           # graph replays (of 4 calls) a turn


def one(root: str) -> dict:
    """Build, check and time the stencil kernels of the checkout at root."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from chip_smoke import graph_timer, with_clocks
    from repro_torch.kernels import build
    from repro_torch.kernels import stencil as st

    built_s = build.build_all(["stencil"])["stencil"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((N, N), generator=gen, device="cuda")
    f = torch.randn((N, N), generator=gen, device="cuda")
    out = torch.empty_like(u)
    z1 = torch.zeros((1, N), device="cuda")
    zk = {k: torch.zeros((k, N), device="cuda") for k in KS}

    def ksweep(k, **kw):
        return st.jacobi_ksweep_parts(zk[k], u, zk[k], zk[k], f, zk[k], k,
                                      k, k, **kw)

    for k in KS:
        got = ksweep(k)
        want = ksweep(k, engine="torch")
        if not torch.equal(got, want):
            raise SystemExit(f"{root}: jacobi_ksweep k={k} differs from the "
                             f"plain version: max|err| "
                             f"{(got - want).abs().max().item():.3e}")
        del got, want
        torch.cuda.empty_cache()

    timers = {"step": graph_timer(torch, [lambda: st.jacobi_step(
        u, f, lo=z1, hi=z1, out=out)] * 4)}
    timers |= {f"k{k}": graph_timer(torch, [lambda k=k: ksweep(k, out=out)]
                                    * 4) for k in KS}
    turns, clocks = with_clocks(lambda: [
        {name: t(REPS) for name, t in timers.items()} for _ in range(TURNS)])
    result = {"checkout": root, "built_s": built_s,
              "card": torch.cuda.get_device_name(0)}
    for name in timers:
        got = sorted(turn[name] for turn in turns)
        result[name] = {"median_ms": got[len(got) // 2], "min_ms": got[0],
                        "max_ms": got[-1]}
    for key, i in (("sm_mhz", 1), ("watts", 2)):
        vals = [c[i] for c in clocks]
        result[key] = [min(vals), max(vals)] if vals else None
    return result


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    from chip_smoke import card_line

    card = card_line()
    print(f"card: {card}", flush=True)
    rows = []
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    names = ["step"] + [f"k{k}" for k in KS]
    print(f"medians of each process's median turn, ms per call ({card}):")
    print("  " + " | ".join(["checkout"] + names))
    for root in dict.fromkeys(argv):
        got = [row for row in rows if row["checkout"] == root]
        cells = [" / ".join(f"{v:.4f}" for v in sorted(
            r[name]["median_ms"] for r in got)) for name in names]
        print("  " + " | ".join([root] + cells))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
