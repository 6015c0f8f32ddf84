#!/usr/bin/env python3
"""Where a kv tile's time goes in the bf16 flash forward and carry step at
head_dim 192: ``clock()`` sums a phase, in a generated copy of a checkout's
kernel.

    python3 scripts/flash192_fwd_phases.py CHECKOUT ...

Each argument is the root of a checkout of this repository (a ``git
archive`` of a commit unpacked under ``build/``, or the repository
itself).  For each, in its own process: its ``src/`` is copied to
``build/phases/<n>/src`` (the checkout is left as it is), the hd-192
forward kernel in the copy's ``csrc/flash_attention.cu`` gets 32-bit
``%clock`` reads around its phases and a ``__device__`` array that lane
0 of every consumer warp adds its sums to, the copy is built, and the
forward and the carry step (empty carry) run at nemotron-4-340b's call
(B=1, S=4096, 96/8 heads, causal) and at the hd-192 training call (2 x
2048, 4/2), ``REPS`` calls each after one warm-up call.  The probes
go into the kernel the source runs at hd 192 (``flash_fwd_wgmma_skip_kernel``,
or in an older checkout ``flash_fwd_wgmma_kernel``): both have a producer
warpgroup and two consumers taking turns on the tensor cores.  The
probes cost registers and issue slots (at 168 registers a thread they
may spill), so the sums show shares, not the kernel's own time; ptxas's
registers and spills of the probed build are printed beside them.

Prints one JSON line per checkout, then cycles a warp-tile by phase, the
cycles a warp spends before its first S and in its epilogue (and their
share of the warp's whole time), and the share of warp-tiles whose every
alpha was exactly 1.0 (the running max of none of the warp's 16 rows
moved), with the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (label, B, S, H, KV); hd 192, causal, bf16
CALLS_AT = (("nemotron 1x4096 96/8", 1, 4096, 96, 8),
            ("training 2x2048 4/2", 2, 2048, 4, 2))
HD = 192
REPS = 3
#: slots of the device array: cycle sums by phase, then warp-tiles,
#: warp-tiles with every alpha 1.0, warps
N_SLOTS = 16
TILES, ONES, WARPS = 13, 14, 15

_CLOCK = ("__device__ __forceinline__ unsigned pf_clock() {\n"
          "  unsigned c;\n"
          "  asm volatile(\"mov.u32 %0, %%clock;\" : \"=r\"(c) :: \"memory\");\n"
          "  return c;\n"
          "}\n"
          "__device__ unsigned long long g_fa_prof[2][16];\n")
_FLUSH = ("  if (lane == 0) {\n"
          "    pf[PF_EPI] += pf_clock() - pf_e;\n"
          "    pf[PF_ALL] += pf_clock() - pf_t0;\n"
          "    for (int x = 0; x < 13; ++x)\n"
          "      atomicAdd(&g_fa_prof[kCarry][x], (unsigned long long)pf[x]);\n"
          "    atomicAdd(&g_fa_prof[kCarry][13], (unsigned long long)pf_tiles);\n"
          "    atomicAdd(&g_fa_prof[kCarry][14], (unsigned long long)pf_one);\n"
          "    atomicAdd(&g_fa_prof[kCarry][15], 1ull);\n"
          "  }\n")
_READ = ("\nextern \"C\" int flash_fa_prof_read(unsigned long long* out) {\n"
         "  cudaError_t e = cudaMemcpyFromSymbol(out, tc::g_fa_prof,\n"
         "                                       sizeof(tc::g_fa_prof));\n"
         "  if (e != cudaSuccess) return (int)e;\n"
         "  static const unsigned long long zero[32] = {};\n"
         "  return (int)cudaMemcpyToSymbol(tc::g_fa_prof, zero, sizeof(zero));\n"
         "}\n")
_DECL = ("  unsigned pf[13] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  unsigned pf_tiles = 0, pf_one = 0, pc = 0, pn = 0;\n")

#: (phase names by slot, [(anchor, replacement)]) of the kernel of turns:
#: a producer warpgroup and two consumers taking turns on the tensor
#: cores, each turn P V of the previous tile then S of this one.  Every
#: anchor must occur exactly once in the kernel's own text
TURNS = (
    {0: "K full wait", 1: "turn wait", 2: "V full wait", 3: "P V",
     4: "S = Q K^T", 5: "softmax", 11: "before the first S",
     10: "epilogue", 12: "whole warp"},
    [("  constexpr int kN = L::kN;\n",
      "  constexpr int kN = L::kN;\n  const unsigned pf_t0 = pf_clock();\n"),
     ("  const bool elected = lane == 0;\n",
      "  const bool elected = lane == 0;\n" + _DECL),
     ("      if (i < n_tiles) mbar_wait(k_full + 8 * st, (i / STAGES) & 1);\n"
      "      turn_wait(mine);\n",
      "      pc = pf_clock();\n"
      "      if (i < n_tiles) mbar_wait(k_full + 8 * st, (i / STAGES) & 1);\n"
      "      pn = pf_clock();\n      pf[0] += pn - pc;\n"
      "      turn_wait(mine);\n"
      "      pc = pf_clock();\n      pf[1] += pc - pn;\n"),
     ("        mbar_wait(v_full + 8 * pst, ((i - 1) / STAGES) & 1);\n",
      "        mbar_wait(v_full + 8 * pst, ((i - 1) / STAGES) & 1);\n"
      "        pn = pf_clock();\n        pf[2] += pn - pc;\n"),
     ("        wgmma_wait<0>();\n        pin(acc);\n",
      "        wgmma_wait<0>();\n        pin(acc);\n"
      "        pc = pf_clock();\n        pf[3] += pc - pn;\n"),
     ("      wgmma_fence();                     // S = Q K^T of this tile\n",
      "      pc = pf_clock();\n      if (i == 0) pf[11] += pc - pf_t0;\n"
      "      wgmma_fence();                     // S = Q K^T of this tile\n"),
     ("      wgmma_wait<0>();\n      pin(s);\n",
      "      wgmma_wait<0>();\n      pin(s);\n"
      "      pn = pf_clock();\n      pf[4] += pn - pc;\n"
      "      const float pm0 = m[0], pm1 = m[1];\n"),
     ("scale);\n    }\n  }\n",
      "scale);\n"
      "      pc = pf_clock();\n      pf[5] += pc - pn;\n      ++pf_tiles;\n"
      "      pf_one += __all_sync(0xffffffffu, pm0 == m[0] && pm1 == m[1]);\n"
      "    }\n  }\n  const unsigned pf_e = pf_clock();\n"),
     ])
_SUMS = _FLUSH.replace("PF_EPI", "10").replace("PF_ALL", "12")

#: the hd-192 forward of each design: its kernel, the name of its stage
#: count and the probes of its exits (flash_fwd_wgmma_kernel, run at hd
#: 192 by older checkouts, whose carry and forward leave at the end; its
#: copy with the exact rescale skip and the forward's output by TMA
#: stores, whose carry returns early)
DESIGNS = {
    "flash_fwd_wgmma_skip_kernel": ("kSkStages", [
        ("        carry.l_out[row] = l[r];\n      }\n    }\n    return;\n",
         "        carry.l_out[row] = l[r];\n      }\n    }\n" + _SUMS +
         "    return;\n"),
        ('"memory");\n  }\n}\n', '"memory");\n  }\n' + _SUMS + "}\n")]),
    "flash_fwd_wgmma_kernel": ("kStages", [
        ("    if (tq == 0) lse[row] = m[r] + logf(l_safe);\n  }\n}\n",
         "    if (tq == 0) lse[row] = m[r] + logf(l_safe);\n  }\n" + _SUMS +
         "}\n")])}


def design_of(src: str) -> str:
    """The kernel a source runs for the hd-192 bf16 forward: the first of
    DESIGNS it defines."""
    for name in DESIGNS:
        if f"\n{name}(" in src:
            return name
    raise SystemExit("no hd-192 forward kernel found")


def probed(src: str) -> tuple[str, dict[int, str]]:
    """``src`` with the probes inserted into its hd-192 forward kernel
    (from its template line to its closing brace), and the names of the
    phase slots."""
    name = design_of(src)
    start = src.rindex("template <int HD, bool kCarry>", 0,
                       src.index(f"\n{name}("))
    end = src.index("\n}\n", src.index(f"\n{name}(")) + 3
    kernel = src[start:end]
    names, patches = TURNS
    stages, exits = DESIGNS[name]
    for old, new in patches + exits:
        old, new = (x.replace("STAGES", stages) for x in (old, new))
        n = kernel.count(old)
        if n != 1:
            raise SystemExit(f"probe anchor found {n} times in {name}, not "
                             f"once:\n{old}")
        kernel = kernel.replace(old, new)
    return src[:start] + _CLOCK + kernel + src[end:] + _READ, names


def copy_of(root: str, n: int) -> str:
    """``root``'s src/ copied under build/phases/<n> with the probes in;
    returns the copy's root."""
    dst = os.path.join(ROOT, "build", "phases", str(n))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "src"), os.path.join(dst, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = os.path.join(dst, "src", "repro_torch", "kernels", "csrc",
                      "flash_attention.cu")
    with open(cu) as f:
        src, names = probed(f.read())
    with open(cu, "w") as f:
        f.write(src)
    with open(os.path.join(dst, "phases.json"), "w") as f:
        json.dump({str(k): v for k, v in names.items()}, f)
    return dst


def one(copy: str) -> dict:
    """Build the probed copy and read its sums at each call."""
    import ctypes

    sys.path.insert(0, os.path.join(copy, "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    with open(os.path.join(copy, "phases.json")) as f:
        names = {int(k): v for k, v in json.load(f).items()}
    build.build_all(["flash_attention"])
    log = build.BUILD_LOG.get("flash_attention", (0.0, ""))[1]
    ptxas = [ln.strip() for ln in log.splitlines()
             if "Used" in ln or "spill" in ln or "C75" in ln]
    lib = fa._lib()
    lib.flash_fa_prof_read.argtypes = [ctypes.c_void_p]
    lib.flash_fa_prof_read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 32)()

    def read() -> list[list[int]]:
        torch.cuda.synchronize()
        if lib.flash_fa_prof_read(ctypes.addressof(buf)) != 0:
            raise RuntimeError("flash_fa_prof_read failed")
        return [list(buf[:N_SLOTS]), list(buf[N_SLOTS:])]

    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {}
    for label, b, s, h, kvh in CALLS_AT:
        q, k, v = (torch.randn(dims, generator=gen, device="cuda").to(
            torch.bfloat16) for dims in ((b, s, h, HD), (b, s, kvh, HD),
                                         (b, s, kvh, HD)))
        empty = fa.init_partials(b, s, h, HD, device="cuda")
        runs = {"fwd": lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                "carry": lambda: fa.flash_attention_carry(q, k, v, *empty,
                                                          causal=True)}
        got = {}
        for kind, fn in runs.items():
            fn()
            read()
            for _ in range(REPS):
                fn()
            sums = read()[1 if kind == "carry" else 0]
            tiles, warps = max(1, sums[TILES]), max(1, sums[WARPS])
            got[kind] = {
                "cycles_a_warp_tile": {
                    names[x]: sums[x] / tiles for x in sorted(names)
                    if x < 10},
                "cycles_a_warp": {names[x]: sums[x] / warps
                                  for x in sorted(names) if x >= 10},
                "set_up_share": (sums[10] + sums[11]) / max(1, sums[12]),
                "alpha_one_share": sums[ONES] / tiles,
                "warp_tiles": sums[TILES] // REPS,
                "warps": sums[WARPS] // REPS}
        calls[label] = got
        del q, k, v, empty
        torch.cuda.empty_cache()
    return {"copy": copy, "ptxas": ptxas, "calls": calls,
            "card": torch.cuda.get_device_name(0)}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    copies = [copy_of(os.path.abspath(r), n) for n, r in enumerate(argv)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for root, copy in zip(argv, copies):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", copy], capture_output=True,
                             text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        r = json.loads(line)
        print(f"{root} (probed copy {copy}), {card}; ptxas of the probed "
              f"build:", flush=True)
        for ln in r["ptxas"]:
            print(f"    {ln}")
        for label, got in r["calls"].items():
            for kind, g in got.items():
                tile = ", ".join(f"{k} {v:.0f}"
                                 for k, v in g["cycles_a_warp_tile"].items())
                warp = ", ".join(f"{k} {v:.0f}"
                                 for k, v in g["cycles_a_warp"].items())
                print(f"  {label} {kind}: cycles a warp-tile: {tile}; "
                      f"cycles a warp: {warp} (set-up share "
                      f"{g['set_up_share'] * 100:.1f}%); every alpha 1.0 on "
                      f"{g['alpha_one_share'] * 100:.1f}% of "
                      f"{g['warp_tiles']} warp-tiles ({g['warps']} warps)",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
