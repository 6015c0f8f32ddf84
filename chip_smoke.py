#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
the CUDA toolkit.  Drives the port only — never ``jax`` or ``repro`` —
in phases, one line each, and stops with a non-zero exit at the first
phase that fails:

  1. build   — compile every kernel under src/repro_torch/kernels/csrc
               with nvcc (one process per source, all at once), print
               ptxas's registers, spills and stack, and count the
               tensor-core (HGMMA) instructions of each flash kernel in its
               SASS: the bf16 forward, carry, backward and block-backward
               kernels must have some;
  2. kernel  — each kernel's wrapper against its plain PyTorch version on
               the card at the stated tolerances (paged attention; flash
               attention forward and backward), then timed beside its
               bound, the plain version and a library yardstick;
  3. serve   — phi4-mini-3.8b at its published size (32 layers, bf16,
               seeded random weights) through ServeEngine; the kernel's
               launch count must equal n_layers x decode steps;
  4. e2e     — the same prompts through the engine at full width, 2
               layers, f32, once with the kernel and once with the plain
               version pinned: the greedy tokens must be equal;
  5. train   — phi4-mini-3.8b at its published size (32 layers, bf16,
               B=2, S=1024, AdamW with f32 moments, remat) for 5 steps of
               build_train_step: finite losses, and exactly 64 forward
               (32 layers + 32 recomputed) and 32 backward flash launches
               per step; then prefill_sp on 2 prompts of 1024 tokens;
  6. parity  — training, prefill and generation at full width, 2 layers,
               f32, TF32 off, with the flash kernels and with the plain
               versions pinned: gradients, 3 steps' losses and updates,
               and greedy tokens agree; the contiguous Generator's tokens
               equal the paged engine's; TrainLoop recovers from an
               injected failure through its checkpoints;
  7. jacobi  — the paper's Jacobi solve at 16386 x 16386 f32 on one rank
               through halo.jacobi_solve: 256 sweeps each of bulk,
               interleaved, and aggregated at the k that
               managed.resolve_halo_aggregation picks and at k = 2, 4, 8,
               with exact stencil launch counts; aggregated equals bulk,
               and at 2050 x 2050 the kernel path equals the plain path
               in every schedule;
  8. moe     — moonshot-v1-16b-a3b (MoE, 64 experts top-6) uncut (48
               layers, bf16, 56 GB of seeded random weights): prefill_sp
               of 4 x 1024 tokens with exactly 48 grouped-expert and 48
               flash launches; 8 requests served through ServeEngine
               (paged launches = 48 x decode steps); 3 training steps at
               full width and 4 layers with exactly 8 grouped launches per
               step; and at 2 layers in f32 the kernel path against the
               plain path (loss, gradients, prefill logits) and the
               contiguous Generator against the paged engine;
  9. ring    — ring attention (context parallelism) on phi4-mini-3.8b
               uncut with attn_impl="ring" at one rank: prefill_sp of
               1 x 8192 tokens with exactly 32 carry-kernel launches and
               no flash launch, its logits against the megatron prefill
               of the same tokens, 16 greedy tokens from its cache; 3
               training steps (B=2, S=1024) with exactly 64 carry launches
               (32 layers + 32 recomputed) and 32 block-backward launches
               per step; and at 2 layers in f32 the ring with the kernels,
               the ring with the plain step and its plain backward, and
               megatron with the flash kernels agree in loss, gradients,
               prefill logits and greedy tokens.

Phase 2 also holds the two stencil kernels (one sweep; k sweeps per round
trip), the grouped-expert FFN, the ring's block backward (bf16 in, f32
out, at the ring training step's shape) and the ring-attention carry step
(its variants, and a virtual 4-rank ring folded on one card against the
flash forward) to their plain versions and times them at the Jacobi
shape, at moonshot's prefill call, at the training shape and at ring
attention's 8192-token prefill call.

The lines before the last hold one JSON object of kernel measurements and
the card's name and power limit as nvidia-smi reports them; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BW = 3.35e12                      # H100 SXM data sheet, bytes/s
PEAK = {"bfloat16": 989e12,           # dense tensor-core rate, flop/s
        "float32": 67e12}             # f32 outside the tensor cores
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def hgmma_counts(build) -> dict[str, int]:
    """HGMMA instructions in each flash kernel of the built library, from
    ``cuobjdump -sass``, by kernel (template arguments spelled out)."""
    import re
    from pathlib import Path

    lib = build._target("flash_attention")
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"(flash_[a-z_]+_kernel)I(.*?)E(?:Ev|EE)", line)
            name = None
            if found:
                args = re.sub(r"Li(\d+)E", r"\1, ", found.group(2) + "E")
                args = re.sub(r"Lb([01])E", lambda b: ("false", "true")[
                    int(b.group(1))] + ", ", args)
                args = args.replace("13__nv_bfloat16", "bf16, ")
                args = re.sub(r"^f", "float, ", args)
                name = f"{found.group(1)}<{args.rstrip(', ')}>"
                counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def eager_ms(torch, fns, reps: int) -> float:
    """Milliseconds per call of the calls in ``fns``, each issued from
    Python ``reps`` times (CUDA events around the loop): the device time
    or, where launching is slower than the work, the host's launch cost."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for f in fns:
            f()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def graph_ms(torch, fns, reps: int) -> float:
    """Device milliseconds per call: the calls in ``fns`` captured once in
    a CUDA graph and replayed ``reps`` times between CUDA events, so no
    host launch cost enters the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:                         # warm up outside the capture
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


# ---------------------------------------------------------------------------
# phase 2: paged attention, kernel vs plain, and its times
# ---------------------------------------------------------------------------


def paged_inputs(torch, rng, *, b, h, kvh, hd, page, lens, n_pages, dtype):
    """Pools of ``n_pages`` pages, each slot's chain drawn without
    replacement, and garbage ids past each chain's end."""
    dev = torch.device("cuda")
    pmax = max(1, -(-int(max(lens)) // page))
    perm = rng.permutation(n_pages)
    table = np.zeros((b, pmax), np.int32)
    off = 0
    for i, n in enumerate(lens):
        used = -(-int(n) // page)
        table[i, :used] = perm[off:off + used]
        table[i, used:] = rng.integers(0, n_pages, size=pmax - used)
        off += used
    if off > n_pages:
        raise ValueError("pool too small for the chains")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_pages, page, kvh, hd), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_pages, page, kvh, hd), generator=gen,
                     device=dev).to(dtype)
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.tensor(np.asarray(lens, np.int32), device=dev))


def paged_bound(lens, window, h, kvh, hd, page, dtype_name, itemsize):
    """Least time for one call: K/V bytes the call needs (each input read
    once, the output written once) over HBM, against the flops over the
    peak of the inputs' type.  Returns (ms, 'bytes'|'operations')."""
    b = len(lens)
    need = sum(min(int(n), window) if window else int(n) for n in lens)
    pmax = max(1, -(-int(max(lens)) // page))
    nbytes = (need * kvh * hd * 2 * itemsize          # K and V
              + 2 * b * h * hd * itemsize             # q in, out
              + 4 * b * (1 + pmax))                   # lens, table
    flops = 4.0 * h * hd * need                       # q.k and p.v
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as paged

    rng = np.random.default_rng(SEED)
    page, hd = 16, 128
    ragged = [0, 1, 16, 17, 32, 100, 255, 288]        # 0, 1, page edges
    errs = {}
    cases = [(32, 8, 0), (32, 8, 64), (48, 1, 0)]     # (H, KV, window)
    for dtype, tol in ((torch.float32, dict(atol=1e-4, rtol=0.0)),
                       (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))):
        for h, kvh, window in cases:
            q, kp, vp, table, lens = paged_inputs(
                torch, rng, b=8, h=h, kvh=kvh, hd=hd, page=page,
                lens=ragged, n_pages=160, dtype=dtype)
            got = paged.paged_attention(q, kp, vp, table, lens,
                                        window=window)
            torch.cuda.synchronize()
            want = paged.paged_attention_torch(
                q.float(), kp.float(), vp.float(), table, lens,
                window=window)
            err = (got.float() - want).abs().max().item()
            name = f"{str(dtype)[6:]} H={h} KV={kvh} window={window}"
            errs[name] = err
            if not torch.isfinite(got.float()).all():
                fail(f"kernel output not finite ({name})")
            if not torch.equal(got[0].float(),
                               torch.zeros_like(got[0].float())):
                fail(f"lens == 0 slot is not exactly zero ({name})")
            try:
                torch.testing.assert_close(got.float(), want, **tol)
            except AssertionError as e:
                fail(f"kernel disagrees with the plain version ({name}): {e}")
            print(f"  kernel vs plain {name}: max|err| {err:.3e} "
                  f"(atol {tol['atol']}, rtol {tol['rtol']})", flush=True)

    def measure(label, *, b, lens, n_pages, copies, calls, reps,
                plain_reps):
        h, kvh = 32, 8
        sets = [paged_inputs(torch, rng, b=b, h=h, kvh=kvh, hd=hd,
                             page=page, lens=lens, n_pages=n_pages,
                             dtype=torch.bfloat16) for _ in range(copies)]
        lmax = int(max(lens))
        # library yardstick: SDPA on K/V already gathered contiguous
        # [B, KV, Lmax, hd] with a length mask (the port never calls it)
        gathered = []
        for q, kp, vp, table, lns in sets:
            pos = torch.arange(lmax, device=q.device)
            pid = table.long()[:, pos // page]                # [B, Lmax]
            k = kp[pid, pos % page].permute(0, 2, 1, 3).contiguous()
            v = vp[pid, pos % page].permute(0, 2, 1, 3).contiguous()
            mask = (pos[None, :] < lns[:, None].long())[:, None, None, :]
            gathered.append((q[:, :, None, :], k, v, mask))

        def sdpa(i):
            qq, k, v, mask = gathered[i % copies]
            return F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        kernel = [lambda s=s: paged.paged_attention(*s) for s in sets]
        plain = [lambda s=s: paged.paged_attention_torch(*s) for s in sets]
        lib = [lambda i=i: sdpa(i) for i in range(copies)]
        ms = graph_ms(torch, kernel * calls, reps)
        call_ms = eager_ms(torch, kernel, reps * calls)
        plain_ms = graph_ms(torch, plain, plain_reps)
        lib_ms = graph_ms(torch, lib * calls, reps)
        bound_ms, bound_by = paged_bound(lens, 0, h, kvh, hd, page,
                                         "bfloat16", 2)
        print(f"  paged_attention {label}: kernel {ms:.4f} ms on the "
              f"device ({call_ms:.4f} ms per call issued from Python), "
              f"bound {bound_ms:.4f} ms ({bound_by}; the kernel reaches "
              f"{bound_ms / ms * 100:.1f}% of it), plain {plain_ms:.4f} ms, "
              f"library yardstick F.scaled_dot_product_attention on "
              f"pre-gathered K/V {lib_ms:.4f} ms", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms)

    # the serving phase's shape: 8 slots, phi4-mini's heads, 16-token
    # pages, 256 + 1 pool pages, chains of 64..288 positions; enough pool
    # copies to exceed the 50 MB L2, as consecutive layers do
    serve_lens = [int(x) for x in rng.integers(64, 289, size=8)]
    main = measure("serve shape (B=8, bf16, lens 64-288)", b=8,
                   lens=serve_lens, n_pages=257, copies=4, calls=8,
                   reps=10, plain_reps=5)
    long_lens = [int(x) for x in rng.integers(2048, 8193, size=32)]
    measure("long context (B=32, bf16, lens 2048-8192)", b=32,
            lens=long_lens, n_pages=sum(-(-n // page) for n in long_lens),
            copies=1, calls=4, reps=5, plain_reps=2)
    bf16_err = max(v for k, v in errs.items() if k.startswith("bfloat16"))
    return main, bf16_err


# ---------------------------------------------------------------------------
# phase 2: flash attention forward and backward, kernel vs plain, and times
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, KV, causal, window, q_offset), head_dim 128: GQA 32/8
#: and MQA 48/1 (granite-34b's heads), causal and not, windows 0 and 64,
#: q_offset > 0 with Sq < Skv, and Sq, Skv that are not multiples of 64;
#: then the edges of the bf16 kernel's 128-row tiles (127, 129, 257, a
#: window of 100, the diagonal mid-tile)
FLASH_CASES = [
    (2, 256, 256, 32, 8, True, 0, 0),
    (1, 200, 200, 32, 8, False, 0, 0),
    (2, 130, 130, 32, 8, True, 64, 0),
    (1, 77, 141, 32, 8, False, 64, 0),
    (1, 96, 300, 48, 1, True, 0, 204),
    (1, 45, 190, 48, 1, True, 64, 120),
    (1, 100, 100, 48, 1, False, 0, 0),
    (1, 127, 129, 32, 8, True, 0, 2),
    (1, 257, 257, 32, 8, True, 100, 0),
    (1, 129, 257, 32, 8, True, 0, 60),
]
#: the training phase's attention: phi4-mini at B=2, S=1024, causal
TRAIN_ATTN = dict(b=2, s=1024, h=32, kvh=8, hd=128)
#: the block backward's f32 outputs against the plain version in f32, of
#: the largest magnitude of each: P and dS are kept as bf16 hi/lo pairs
BLOCK_TOL = 1e-4


def flash_bounds(b, s, h, kvh, hd, itemsize):
    """Least times at the training shape (causal, each input read once,
    each output written once): the forward's QK^T and PV over the
    unmasked pairs; the backward's recomputed QK^T, dP, dV, dK and dQ.
    Returns {"fwd"|"bwd": (ms, 'bytes'|'operations')}."""
    pairs = b * h * s * (s + 1) // 2
    q_bytes = b * s * h * hd * itemsize
    kv_bytes = 2 * b * s * kvh * hd * itemsize
    lse_bytes = b * s * h * 4
    out = {}
    for name, flops, nbytes in (
            ("fwd", 4.0 * pairs * hd, 2 * q_bytes + kv_bytes + lse_bytes),
            ("bwd", 10.0 * pairs * hd,
             4 * q_bytes + 2 * kv_bytes + lse_bytes)):
        t_ops = flops / PEAK["bfloat16"]
        t_bytes = nbytes / HBM_BW
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def block_bwd_bound(b, s, h, kvh, hd, itemsize):
    """Least time of ring attention's block backward over [B, S] with an
    S-long causal block: the backward's 10 flop per (pair, hd) at the bf16
    tensor-core rate, against q, dout, k, v, lse and dsum read once and
    the f32 dq, dk, dv written once.  Returns (ms, 'bytes'|'operations')."""
    pairs = b * h * s * (s + 1) // 2
    nbytes = (2 * b * s * h * hd * itemsize + 2 * b * s * kvh * hd * itemsize
              + 2 * b * s * h * 4 + (b * s * h * hd + 2 * b * s * kvh * hd) * 4)
    t_ops = 10.0 * pairs * hd / PEAK["bfloat16"]
    t_bytes = nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def flash_inputs(torch, gen, b, sq, skv, h, kvh, hd, dtype):
    dev = torch.device("cuda")
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                          (b, skv, kvh, hd), (b, sq, h, hd))]


def phase_flash(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for b, sq, skv, h, kvh, causal, window, q_off in FLASH_CASES:
            q, k, v, dout = flash_inputs(torch, gen, b, sq, skv, h, kvh,
                                         128, dtype)
            kw = dict(causal=causal, window=window, q_offset=q_off)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            want_out, want_lse = fa.flash_attention_torch(
                q.float(), k.float(), v.float(), **kw)
            wants = fa.flash_attention_bwd_torch(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **kw)
            name = (f"{str(dtype)[6:]} B={b} Sq={sq} Skv={skv} H={h} "
                    f"KV={kvh} causal={causal} window={window} "
                    f"q_offset={q_off}")
            line = []
            for what, got, want, t in (
                    ("out", out, want_out, tol), ("lse", lse, want_lse, 1e-4),
                    ("dq", grads[0], wants[0], tol),
                    ("dk", grads[1], wants[1], tol),
                    ("dv", grads[2], wants[2], tol)):
                if not torch.isfinite(got.float()).all():
                    fail(f"flash {what} not finite ({name})")
                err = (got.float() - want).abs().max().item()
                scale = max(1.0, want.abs().max().item())
                if err > t * scale:
                    fail(f"flash kernel {what} disagrees with the plain "
                         f"version ({name}): max|err| {err:.3e} > {t} x "
                         f"{scale:.3g}")
                line.append(f"{what} {err:.2e}")
                if dtype == torch.bfloat16 and what != "lse":
                    key = "fwd" if what == "out" else "bwd"
                    errs[key] = max(errs[key], err)
            print(f"  flash kernels vs plain {name}: max|err| "
                  f"{', '.join(line)} (tolerance {tol} x max(1, max|want|),"
                  f" lse 1e-4)", flush=True)

    # times at the training shape, bf16, causal; two input sets so that
    # consecutive calls do not find their inputs in the 50 MB L2
    t = TRAIN_ATTN
    sets = [flash_inputs(torch, gen, t["b"], t["s"], t["s"], t["h"],
                         t["kvh"], t["hd"], torch.bfloat16)
            for _ in range(2)]
    fwd_res = []
    for q, k, v, _ in sets:
        fwd_res.append(fa.flash_attention_fwd(q, k, v))
    kernel_fwd = [lambda s=s: fa.flash_attention_fwd(*s[:3]) for s in sets]
    plain_fwd = [lambda s=s: fa.flash_attention_torch(*s[:3]) for s in sets]
    kernel_bwd = [lambda s=s, r=r: fa.flash_attention_bwd(*s[:3], *r, s[3])
                  for s, r in zip(sets, fwd_res)]
    plain_bwd = [lambda s=s, r=r: fa.flash_attention_bwd_torch(
        *s[:3], *r, s[3]) for s, r in zip(sets, fwd_res)]
    lib_in = [[x.transpose(1, 2).contiguous() for x in s] for s in sets]
    lib_fwd = [lambda s=s: F.scaled_dot_product_attention(
        *s[:3], is_causal=True, enable_gqa=True) for s in lib_in]
    # the library backward in a CUDA graph: autograd runs a backward op on
    # its forward's stream, so the captured call is SDPA's forward and
    # backward together, and the backward's time is that graph's time less
    # the forward's graph time
    leaves = [[x.detach().requires_grad_() for x in s[:3]] for s in lib_in]
    lib_fwd_bwd = [lambda s=s, lv=lv: torch.autograd.grad(
        F.scaled_dot_product_attention(*lv, is_causal=True, enable_gqa=True),
        lv, s[3]) for s, lv in zip(lib_in, leaves)]
    lib_fwd_ms = graph_ms(torch, lib_fwd * 4, 5)
    times = {
        "fwd": dict(ms=graph_ms(torch, kernel_fwd * 4, 5),
                    plain_ms=graph_ms(torch, plain_fwd, 3),
                    library_ms=lib_fwd_ms),
        "bwd": dict(ms=graph_ms(torch, kernel_bwd * 2, 5),
                    plain_ms=graph_ms(torch, plain_bwd, 3),
                    library_ms=graph_ms(torch, lib_fwd_bwd * 2, 5)
                    - lib_fwd_ms),
    }
    bounds = flash_bounds(t["b"], t["s"], t["h"], t["kvh"], t["hd"], 2)
    pairs = t["b"] * t["h"] * t["s"] * (t["s"] + 1) // 2
    for name, what, per_pair in (("fwd", "forward", 4), ("bwd", "backward",
                                                         10)):
        tm = times[name]
        tm["bound_ms"], tm["bound_by"] = bounds[name]
        tflops = per_pair * pairs * t["hd"] / (tm["ms"] * 1e-3) / 1e12
        lib = ("F.scaled_dot_product_attention(is_causal=True, "
               "enable_gqa=True)" if name == "fwd" else
               "the backward of that call (autograd.grad of the call, in a "
               "CUDA graph, less the call's own graph time)")
        print(f"  flash_attention {what} at the training shape (B=2, "
              f"S=1024, 32/8 heads, hd 128, causal, bf16): kernel "
              f"{tm['ms']:.4f} ms ({tflops:.1f} TFLOP/s over the unmasked "
              f"pairs), bound {tm['bound_ms']:.4f} ms "
              f"({tm['bound_by']}; the kernel reaches "
              f"{tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
              f"{tm['plain_ms']:.4f} ms, library yardstick {lib} "
              f"{tm['library_ms']:.4f} ms", flush=True)

    # ring attention's block backward at the ring training step's shape
    # (one rank: one block over the whole sequence, offsets 0), bf16 in,
    # f32 out, against the plain version in f32, then timed
    blk_in = [(*s[:3], s[3], r[1], (s[3].float() * r[0].float()).sum(-1))
              for s, r in zip(sets, fwd_res)]
    got = fa.flash_attention_bwd_block(*blk_in[0], causal=True)
    torch.cuda.synchronize()
    q, k, v, dout, lse, dsum = blk_in[0]
    want = fa.flash_attention_bwd_block_torch(
        q.float(), k.float(), v.float(), dout.float(), lse, dsum,
        causal=True)
    line = []
    for what, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.dtype != torch.float32 or not torch.isfinite(g).all():
            fail(f"block backward {what} is not finite f32")
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        if err > BLOCK_TOL * scale:
            fail(f"block backward {what} disagrees with the plain version: "
                 f"max|err| {err:.3e} > {BLOCK_TOL} x {scale:.3g}")
        errs["bwd_block"] = max(errs.get("bwd_block", 0.0), err)
        line.append(f"{what} {err:.2e} (of {scale:.3g})")
    del got, want
    kernel_blk = [lambda a=a: fa.flash_attention_bwd_block(*a, causal=True)
                  for a in blk_in]
    plain_blk = [lambda a=a: fa.flash_attention_bwd_block_torch(
        *a, causal=True) for a in blk_in]
    tm = dict(ms=graph_ms(torch, kernel_blk * 2, 5),
              plain_ms=graph_ms(torch, plain_blk, 3),
              library_ms=times["bwd"]["library_ms"])
    tm["bound_ms"], tm["bound_by"] = block_bwd_bound(
        t["b"], t["s"], t["h"], t["kvh"], t["hd"], 2)
    times["bwd_block"] = tm
    tflops = 10 * pairs * t["hd"] / (tm["ms"] * 1e-3) / 1e12
    print(f"  flash_attention_bwd_block vs plain at the ring training "
          f"step's shape (B=2, S=1024, 32/8 heads, hd 128, causal, offsets "
          f"0, bf16 in, f32 out): max|err| {', '.join(line)} (tolerance "
          f"{BLOCK_TOL} of the largest magnitude); kernel {tm['ms']:.4f} ms "
          f"({tflops:.1f} TFLOP/s over the unmasked pairs), bound "
          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}; the kernel reaches "
          f"{tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
          f"{tm['plain_ms']:.4f} ms, library yardstick the SDPA backward "
          f"above {tm['library_ms']:.4f} ms", flush=True)
    return times, errs


# ---------------------------------------------------------------------------
# phase 2: the Jacobi stencil kernels, kernel vs plain, and their times
# ---------------------------------------------------------------------------

#: the Jacobi phase's grid (interior 16384^2, f32, 1.07 GB per array) and
#: sweeps per schedule
JACOBI_N = 16386
JACOBI_ITERS = 256
#: ragged, tiny, and the kernel-vs-plain solve's shape
STENCIL_SHAPES = [(1000, 777), (3, 3), (5, 130), (2050, 2050)]
STENCIL_TOL = (("float32", 1e-6), ("bfloat16", 2e-2))


def stencil_bound(m, n, itemsize, sweeps, u_ghost=0, f_ghost=0):
    """Least time for one call that leaves ``sweeps`` sweeps on an [m, n]
    block: u with its ``u_ghost`` ghost rows and f with its ``f_ghost``
    read once, u' written once, over HBM, against the 5 f32 operations of
    each needed interior update over the f32 peak.  Returns
    (ms, 'bytes'|'operations')."""
    nbytes = ((m + u_ghost) + (m + f_ghost) + m) * n * itemsize
    flops = 5.0 * m * max(n - 2, 0) * sweeps
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK["float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def stencil_check(torch, got, want, tol, name):
    """max|got - want| within tol of the largest magnitude; returns it."""
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: output not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    if err > tol * scale:
        fail(f"{name}: kernel disagrees with the plain version: max|err| "
             f"{err:.3e} > {tol} x {scale:.3g}")
    return err


def phase_stencil(torch):
    from repro_torch.kernels import stencil as st

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    errs = {"step": 0.0, "ksweep": 0.0}
    for dname, tol in STENCIL_TOL:
        dtype = getattr(torch, dname)
        for m, n in STENCIL_SHAPES:
            u, f = rand((m, n), dtype), rand((m, n), dtype)
            lo, hi = rand((1, n), dtype), rand((1, n), dtype)
            line = []
            for what, kw in (("dirichlet", {}),
                             ("halo", {"lo": lo, "hi": hi}),
                             ("interior", {"rows": ((1, m - 1),)}),
                             ("edges", {"lo": lo, "hi": hi,
                                        "rows": ((0, 1), (m - 1, m))})):
                got = torch.full_like(u, 7.0)
                want = torch.full_like(u, 7.0)
                st.jacobi_step(u, f, out=got, **kw)
                torch.cuda.synchronize()
                st.jacobi_step(u, f, out=want, engine="torch", **kw)
                err = stencil_check(torch, got, want, tol,
                                    f"jacobi_step {dname} {m}x{n} {what}")
                errs["step"] = max(errs["step"], err)
                line.append(f"{what} {err:.1e}")
            print(f"  jacobi_step vs plain {dname} {m}x{n}: max|err| "
                  f"{', '.join(line)} (tolerance {tol} x max(1, max|want|))",
                  flush=True)
        for k in (1, 2, 3, 4, 8):
            line = []
            for m, n in ((64, 130), (1000, 777), (5, 130)):
                big, fbig = rand((m + 2 * k, n), dtype), rand((m + 2 * k, n),
                                                              dtype)
                for ft, fb in ((0, 0), (k, k), (k + 1, k + 1)):
                    got = st.jacobi_ksweep(big, fbig, k, ft, fb)
                    torch.cuda.synchronize()
                    want = st.jacobi_ksweep(big, fbig, k, ft, fb,
                                            engine="torch")
                    err = stencil_check(
                        torch, got, want, tol, f"jacobi_ksweep {dname} "
                        f"{m}x{n} k={k} frozen=({ft}, {fb})")
                    errs["ksweep"] = max(errs["ksweep"], err)
                    line.append(err)
                if dtype == torch.float32:
                    # the live apron: k sweeps of the larger grid in which
                    # every row updates, restricted to the centre
                    oracle = big.clone()
                    z = torch.zeros((1, n), device="cuda")
                    for _ in range(k):
                        up = torch.cat([z, oracle, z])
                        oracle[:, 1:-1] = 0.25 * (
                            up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2]
                            + up[1:-1, 2:] - fbig[:, 1:-1])
                    got = st.jacobi_ksweep(big, fbig, k, 0, 0)
                    line.append(stencil_check(
                        torch, got, oracle[k:-k], tol,
                        f"jacobi_ksweep slab interior {m}x{n} k={k}"))
            print(f"  jacobi_ksweep vs plain {dname} k={k} (64x130, "
                  f"1000x777, 5x130; frozen (0,0), (k,k), (k+1,k+1)"
                  f"{'; live-apron oracle' if dtype == torch.float32 else ''}"
                  f"): max|err| {max(line):.1e} (tolerance {tol} x max(1, "
                  f"max|want|))", flush=True)

    # times at the Jacobi phase's shape, one rank: the bulk sweep (zero
    # halo rows) and the aggregated call at k = 8 (frozen zero ghost rows)
    n, k = JACOBI_N, 8
    u, f = rand((n, n), torch.float32), rand((n, n), torch.float32)
    out = torch.empty_like(u)
    z1 = torch.zeros((1, n), device="cuda")
    zk = torch.zeros((k, n), device="cuda")
    times = {
        "step": dict(
            ms=graph_ms(torch, [lambda: st.jacobi_step(
                u, f, lo=z1, hi=z1, out=out)] * 4, 5),
            plain_ms=graph_ms(torch, [lambda: st.jacobi_step(
                u, f, lo=z1, hi=z1, out=out, engine="torch")], 3),
            library_ms=None),
        "ksweep": dict(
            ms=graph_ms(torch, [lambda: st.jacobi_ksweep_parts(
                zk, u, zk, zk, f, zk, k, k, k, out=out)] * 4, 5),
            plain_ms=graph_ms(torch, [lambda: st.jacobi_ksweep_parts(
                zk, u, zk, zk, f, zk, k, k, k, out=out,
                engine="torch")], 2),
            library_ms=None),
    }
    # the same calls, kernel against plain, at this shape
    for name, call, tol in (
            ("step", lambda **kw: st.jacobi_step(u, f, lo=z1, hi=z1, **kw),
             STENCIL_TOL[0][1]),
            ("ksweep", lambda **kw: st.jacobi_ksweep_parts(
                zk, u, zk, zk, f, zk, k, k, k, **kw), STENCIL_TOL[0][1])):
        got = call()
        torch.cuda.synchronize()
        want = call(engine="torch")
        err = stencil_check(torch, got, want, tol,
                            f"jacobi_{name} float32 {n}x{n}")
        errs[name] = max(errs[name], err)
        print(f"  jacobi_{name} vs plain float32 {n}x{n} (the main path's "
              f"call): max|err| {err:.1e} (tolerance {tol} x max(1, "
              f"max|want|))", flush=True)
        del got, want
    for name, (sweeps, ghosts) in (("step", (1, (2, 0))),
                                   ("ksweep", (k, (2 * k, 2 * k)))):
        tm = times[name]
        tm["bound_ms"], tm["bound_by"] = stencil_bound(n, n, 4, sweeps,
                                                       *ghosts)
        print(f"  jacobi_{name} at {n}x{n} f32 ({sweeps} sweep"
              f"{'s' if sweeps > 1 else ''} per call): kernel "
              f"{tm['ms']:.4f} ms ({tm['ms'] / sweeps:.4f} ms per sweep), "
              f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}; the kernel "
              f"reaches {tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
              f"{tm['plain_ms']:.4f} ms; no single library call computes it",
              flush=True)
    del u, f, out
    torch.cuda.empty_cache()
    return times, errs


# ---------------------------------------------------------------------------
# phase 2: the grouped-expert FFN, kernel vs plain, and its times
# ---------------------------------------------------------------------------

#: (G, C, D, F, E): one group per expert, gpe = 2 and 4, sizes that are no
#: multiple of the kernel's tiles
GROUPED_SHAPES = [(4, 16, 8, 12, 4), (8, 32, 8, 16, 4), (8, 32, 8, 16, 2),
                  (3, 257, 130, 70, 3), (6, 100, 200, 77, 3)]
GROUPED_TOL = (("float32", 1e-5), ("bfloat16", 2e-2))
#: moonshot-v1-16b-a3b's prefill call: B=4 x S=1024 tokens, top-6 of 64
#: experts, capacity ceil(4096 * 6 * 1.25 / 64) = 480
MOE_PREFILL = dict(b=4, s=1024, e=64, k=6, c=480, d=2048, f=1408)


def grouped_inputs(torch, gen, shape, dtype, valid):
    """h with 1e3-scale garbage past each group's valid count; weights
    ~ 0.1 N(0, 1)."""
    g, c, d, f, e = shape
    h = torch.randn((g, c, d), generator=gen, device="cuda")
    rows = torch.arange(c, device="cuda")[None, :, None]
    junk = 1e3 * torch.randn((g, c, d), generator=gen, device="cuda")
    h = torch.where(rows < valid[:, None, None], h, junk)
    ws = [0.1 * torch.randn(s, generator=gen, device="cuda")
          for s in ((e, d, f), (e, d, f), (e, f, d))]
    return [t.to(dtype) for t in (h, *ws)]


def routed_counts(torch, rng):
    """Kept rows per expert of one prefill call: each token's top-6
    distinct experts drawn uniformly, loads clamped at the capacity."""
    p = MOE_PREFILL
    picks = np.argsort(rng.random((p["b"] * p["s"], p["e"])), axis=1)
    load = np.bincount(picks[:, :p["k"]].ravel(), minlength=p["e"])
    return torch.tensor(np.minimum(load, p["c"]).astype(np.int32),
                        device="cuda")


def grouped_bound(kept, c, d, f, e, itemsize, gated=True):
    """Least time for one call that keeps ``kept`` rows: the first
    products in the inputs' type on the tensor cores, the second in f32
    outside them, against the kept rows of h, the expert weights and the
    whole output over HBM.  Returns (ms, 'bytes'|'operations')."""
    mults = 2 if gated else 1
    t_ops = (2.0 * mults * d * f * kept / PEAK["bfloat16"]
             + 2.0 * f * d * kept / PEAK["float32"])
    nbytes = ((kept * d + (mults + 1) * e * d * f) * itemsize
              + e * c * d * itemsize + 4 * e)
    t_bytes = nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def grouped_check(torch, got, want, valid, tol, name):
    """Within tol x max(1, max|want|), padded rows exactly zero; returns
    max|err|."""
    err = stencil_check(torch, got, want, tol, name)
    pad = (torch.arange(got.shape[1], device="cuda")[None, :, None]
           >= valid[:, None, None]).expand_as(got)
    if not torch.equal(got[pad].float(), torch.zeros_like(got[pad].float())):
        fail(f"{name}: padded rows are not exactly zero")
    return err


def phase_grouped(torch):
    from repro_torch.kernels import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    err_bf16 = 0.0
    for dname, tol in GROUPED_TOL:
        dtype = getattr(torch, dname)
        for mlp in ("swiglu", "geglu", "relu2", "gelu"):
            line = []
            for shape in GROUPED_SHAPES:
                g, c = shape[:2]
                valid = torch.tensor(rng.integers(0, c + 1, size=g),
                                     dtype=torch.int32, device="cuda")
                valid[0], valid[-1] = 0, c
                h, w1, w1g, w2 = grouped_inputs(torch, gen, shape, dtype,
                                                valid)
                w1g = w1g if gm.gated(mlp) else None
                got = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp=mlp)
                torch.cuda.synchronize()
                want = gm.grouped_expert_ffn_torch(
                    h.float(), w1.float(),
                    None if w1g is None else w1g.float(), w2.float(),
                    valid, mlp)
                err = grouped_check(torch, got, want, valid, tol,
                                    f"grouped_expert_ffn {dname} {mlp} "
                                    f"{shape}")
                line.append(err)
                if dtype == torch.bfloat16:
                    err_bf16 = max(err_bf16, err)
            print(f"  grouped_expert_ffn vs plain {dname} {mlp} (G, C, D, "
                  f"F, E) in {GROUPED_SHAPES}, valid 0, C and between: "
                  f"max|err| {max(line):.2e} (tolerance {tol} x max(1, "
                  f"max|want|)); padded rows exactly 0", flush=True)

    # the prefill's own call, kernel against plain, then its times; two
    # input sets so consecutive calls do not find the weights in L2
    p = MOE_PREFILL
    shape = (p["e"], p["c"], p["d"], p["f"], p["e"])
    sets = []
    for _ in range(2):
        valid = routed_counts(torch, rng)
        sets.append((*grouped_inputs(torch, gen, shape, torch.bfloat16,
                                     valid), valid))
    h, w1, w1g, w2, valid = sets[0]
    got = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp="swiglu")
    torch.cuda.synchronize()
    want = gm.grouped_expert_ffn_torch(h, w1, w1g, w2, valid, "swiglu")
    err = grouped_check(torch, got, want, valid, GROUPED_TOL[1][1],
                        f"grouped_expert_ffn bf16 prefill call {shape}")
    err_bf16 = max(err_bf16, err)
    kept = int(valid.sum())
    print(f"  grouped_expert_ffn vs plain bf16 at the moonshot prefill call "
          f"(G = E = 64, C = 480, D = 2048, F = 1408, swiglu, {kept} kept "
          f"rows): max|err| {err:.2e} (tolerance {GROUPED_TOL[1][1]} x "
          f"max(1, max|want|)); padded rows exactly 0", flush=True)
    del got, want

    def bmm3(s):
        hh, a, b, c2, _ = s
        return torch.bmm(torch.bmm(hh, a) * torch.bmm(hh, b), c2)

    kernel = [lambda s=s: gm.grouped_expert_ffn(*s[:4], s[4], mlp="swiglu")
              for s in sets]
    plain = [lambda s=s: gm.grouped_expert_ffn_torch(*s[:4], s[4],
                                                     "swiglu")
             for s in sets]
    yard = [lambda s=s: bmm3(s) for s in sets]
    tm = dict(ms=graph_ms(torch, kernel * 2, 5),
              plain_ms=graph_ms(torch, plain, 3), library_ms=None)
    yard_ms = graph_ms(torch, yard * 2, 5)
    kept_mean = sum(int(s[4].sum()) for s in sets) / len(sets)
    tm["bound_ms"], tm["bound_by"] = grouped_bound(
        kept_mean, p["c"], p["d"], p["f"], p["e"], 2)
    print(f"  grouped_expert_ffn at the moonshot prefill call (bf16, "
          f"{kept_mean:.0f} kept rows of {p['e'] * p['c']}): kernel "
          f"{tm['ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms "
          f"({tm['bound_by']}; the kernel reaches "
          f"{tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
          f"{tm['plain_ms']:.4f} ms; no single library call computes it; "
          f"yardstick: three torch.bmm on the padded buffers in bf16 "
          f"(cuBLAS, padding included, one elementwise product in place of "
          f"the activation) {yard_ms:.4f} ms", flush=True)
    del sets, h, w1, w1g, w2, kernel, plain, yard
    torch.cuda.empty_cache()
    return tm, err_bf16


# ---------------------------------------------------------------------------
# phase 2: the ring-attention carry step, kernel vs plain, and its times
# ---------------------------------------------------------------------------

#: ring attention's prefill call: phi4-mini at B=1, S=8192, causal, empty
#: carry (one rank: one step over the whole sequence)
RING_PREFILL = dict(b=1, s=8192, h=32, kvh=8, hd=128)
#: (B, Sq, Skv, H, KV, hd, causal, window, q_offset, k_offset, carried):
#: causal and not, a window of 1536, ragged Skv = 1000, hd 64, a block
#: after the q rows (nothing visible), carried states; the diagonal
#: mid-tile (d = 50) and MQA 48/1 at hd 64 with a window of 100
CARRY_CASES = [
    (1, 1024, 1024, 32, 8, 128, True, 0, 0, 0, False),
    (1, 1024, 1024, 32, 8, 128, False, 0, 1024, 0, True),
    (1, 2048, 2048, 32, 8, 128, True, 1536, 2048, 1024, True),
    (2, 512, 1000, 32, 8, 128, True, 0, 1000, 0, True),
    (1, 512, 512, 32, 8, 128, True, 0, 0, 512, True),
    (1, 1024, 1024, 16, 4, 64, False, 1536, 1536, 0, True),
    (1, 129, 257, 32, 8, 128, True, 0, 300, 250, True),
    (1, 257, 257, 48, 1, 64, True, 100, 0, 0, False),
]
#: of the largest magnitude of m, l and acc: the kernel and the plain
#: version do f32 math on the same upcast values
CARRY_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
#: the virtual ring: one card folds 4 ranks' blocks of 1024 in ring order
VRING = dict(n=4, blk=1024, h=32, kvh=8, hd=128)


def carry_bounds(b, s, h, kvh, hd, itemsize):
    """Least time of one causal carry step over [B, S] with an S-long kv
    block: QK^T and PV over the unmasked pairs at the bf16 tensor-core
    rate, against q, k, v read once and the f32 carry (m, l, acc) read
    and written once.  Returns (ms, 'bytes'|'operations')."""
    pairs = b * h * s * (s + 1) // 2
    nbytes = (b * s * h * hd * itemsize + 2 * b * s * kvh * hd * itemsize
              + 2 * (b * s * h * hd * 4 + 2 * b * s * h * 4))
    t_ops = 4.0 * pairs * hd / PEAK["bfloat16"]
    t_bytes = nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def carry_inputs(torch, gen, b, sq, skv, h, kvh, hd, dtype, carried):
    """q, k, v in ``dtype`` and an f32 carry: empty, or the plain step of
    an earlier random block."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = flash_inputs(torch, gen, b, sq, skv, h, kvh, hd, dtype)
    carry = fa.init_partials(b, sq, h, hd, device=q.device)
    if carried:
        _, k0, v0, _ = flash_inputs(torch, gen, b, sq, 256, h, kvh, hd,
                                    torch.float32)
        carry = fa.flash_attention_step_torch(q.float(), k0, v0, *carry,
                                              causal=False)
    return q, k, v, carry


def carry_check(torch, got, want, tol, name):
    """m, l, acc within ``tol`` of the largest magnitude of each; rows
    that see nothing keep m = -1e30 exactly.  Returns the largest
    absolute error of the three."""
    dead = want[0] <= -1e29
    if not torch.equal(got[0][dead], want[0][dead]):
        fail(f"carry kernel changed the m of rows that see nothing ({name})")
    worst = 0.0
    for what, g, w in (("m", got[0][~dead], want[0][~dead]),
                       ("l", got[1], want[1]), ("acc", got[2], want[2])):
        if w.numel() == 0:
            continue
        if not torch.isfinite(g).all():
            fail(f"carry {what} not finite ({name})")
        err = (g - w).abs().max().item()
        scale = max(w.abs().max().item(), 1e-30)
        if err > tol * scale:
            fail(f"carry kernel {what} disagrees with the plain version "
                 f"({name}): max|err| {err:.3e} > {tol} x {scale:.3g}")
        worst = max(worst, err)
    return worst


def phase_carry(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    err_bf16 = 0.0
    for dname, tol in CARRY_TOL.items():
        dtype = getattr(torch, dname)
        line = []
        for case in CARRY_CASES:
            b, sq, skv, h, kvh, hd, causal, window, qo, ko, carried = case
            q, k, v, carry = carry_inputs(torch, gen, b, sq, skv, h, kvh, hd,
                                          dtype, carried)
            kw = dict(causal=causal, window=window, q_offset=qo,
                      k_offset=ko)
            got = fa.flash_attention_carry(q, k, v, *carry, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_step_torch(q.float(), k.float(),
                                                 v.float(), *carry, **kw)
            err = carry_check(torch, got, want, tol, f"{dname} {case}")
            if qo + sq <= ko and causal:          # nothing visible
                if not all(torch.equal(g, c) for g, c in zip(got, carry)):
                    fail(f"an invisible block changed the carry ({case})")
            line.append(err)
        if dtype == torch.bfloat16:
            err_bf16 = max(err_bf16, max(line))
        print(f"  flash_attention_carry vs plain {dname}, (B, Sq, Skv, H, "
              f"KV, hd, causal, window, q_offset, k_offset, carried) in "
              f"{CARRY_CASES}: max|err| {max(line):.2e} over m, l, acc "
              f"(tolerance {tol} x the largest magnitude of each); an "
              f"invisible block leaves the carry bit for bit", flush=True)

        # the virtual ring: 4 ranks' blocks folded in ring order, each step
        # against the plain step, finalized against the flash forward
        r = VRING
        n, blk = r["n"], r["blk"]
        q, k, v, _ = flash_inputs(torch, gen, 1, n * blk, n * blk, r["h"],
                                  r["kvh"], r["hd"], dtype)
        want_out, want_lse = fa.flash_attention_fwd(q, k, v, causal=True)
        outs, lses, step_err, steps = [], [], 0.0, 0
        for rank in range(n):
            qb = q[:, rank * blk:(rank + 1) * blk].contiguous()
            carry = fa.init_partials(1, blk, r["h"], r["hd"], device="cuda")
            for s in range(n):
                lo = ((rank - s) % n) * blk
                if lo > rank * blk + blk - 1:     # after the q rows: skip
                    continue
                kb = k[:, lo:lo + blk].contiguous()
                vb = v[:, lo:lo + blk].contiguous()
                kw = dict(causal=True, q_offset=rank * blk, k_offset=lo)
                nxt = fa.flash_attention_carry(qb, kb, vb, *carry, **kw)
                want = fa.flash_attention_step_torch(
                    qb.float(), kb.float(), vb.float(), *carry, **kw)
                step_err = max(step_err, carry_check(
                    torch, nxt, want, tol, f"virtual ring {dname} rank "
                    f"{rank} step {s}"))
                carry, steps = nxt, steps + 1
            out, lse = fa.finalize_partials(*carry)
            outs.append(out)
            lses.append(lse)
        torch.cuda.synchronize()
        out, lse = torch.cat(outs, dim=1), torch.cat(lses, dim=1)
        out_tol = 2e-5 if dtype == torch.float32 else 2e-2
        out_err = (out - want_out.float()).abs().max().item()
        out_scale = want_out.float().abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if out_err > out_tol * out_scale or lse_err > 1e-4 * max(
                1.0, want_lse.abs().max().item()):
            fail(f"virtual ring {dname}: finalized carry differs from "
                 f"flash_attention_fwd by {out_err:.3e} (out) / "
                 f"{lse_err:.3e} (lse)")
        if dtype == torch.bfloat16:
            err_bf16 = max(err_bf16, step_err)
        print(f"  virtual 4-rank ring ({dname}, S = {n * blk} in blocks of "
              f"{blk}, causal, {steps} visible steps of {n * n}): every "
              f"step within {step_err:.2e} (absolute) of the plain step; "
              f"finalized, "
              f"out within {out_err:.2e} and lse within {lse_err:.2e} of "
              f"flash_attention_fwd over the whole sequence (tolerances "
              f"{out_tol} x {out_scale:.3g}, 1e-4)", flush=True)
        del q, k, v, outs, lses, out, lse, want_out, want_lse

    # the prefill call, kernel against plain, then times; two input sets
    # so that consecutive calls do not find their inputs in the 50 MB L2
    p = RING_PREFILL
    sets = []
    for _ in range(2):
        q, k, v, carry = carry_inputs(torch, gen, p["b"], p["s"], p["s"],
                                      p["h"], p["kvh"], p["hd"],
                                      torch.bfloat16, False)
        sets.append((q, k, v, *carry))
    got = fa.flash_attention_carry(*sets[0])
    # in bf16 the forward and the carry step are one kernel: at an empty
    # carry, finalized, the carry must give the forward bit for bit (the
    # one-rank ring prefill equals megatron's because of it)
    fwd_out, fwd_lse = fa.flash_attention_fwd(*sets[0][:3], causal=True)
    fin_out, fin_lse = fa.finalize_partials(*got, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    if not (torch.equal(fwd_out, fin_out) and torch.equal(fwd_lse, fin_lse)):
        fail("at ring attention's prefill call the finalized empty-carry "
             "step differs from flash_attention_fwd")
    del fwd_out, fwd_lse, fin_out, fin_lse
    q, k, v = (x.float() for x in sets[0][:3])
    want = fa.flash_attention_step_torch(q, k, v, *sets[0][3:])
    err = carry_check(torch, got, want, CARRY_TOL["bfloat16"],
                      "the prefill call")
    err_bf16 = max(err_bf16, err)
    del got, want, q, k, v
    print(f"  flash_attention_carry vs plain bf16 at ring attention's "
          f"prefill call (B=1, S=8192, 32/8 heads, hd 128, causal, empty "
          f"carry): max|err| {err:.2e} over m, l, acc (tolerance "
          f"{CARRY_TOL['bfloat16']} x the largest magnitude of each); "
          f"finalized, it equals flash_attention_fwd bit for bit",
          flush=True)
    kernel = [lambda s=s: fa.flash_attention_carry(*s) for s in sets]
    plain = [lambda s=s: fa.flash_attention_step_torch(*s) for s in sets]
    lib_in = [[x.transpose(1, 2).contiguous() for x in s[:3]] for s in sets]
    lib = [lambda s=s: F.scaled_dot_product_attention(
        *s, is_causal=True, enable_gqa=True) for s in lib_in]
    tm = dict(ms=graph_ms(torch, kernel * 2, 3),
              plain_ms=graph_ms(torch, plain, 2),
              library_ms=graph_ms(torch, lib * 4, 5))
    tm["bound_ms"], tm["bound_by"] = carry_bounds(p["b"], p["s"], p["h"],
                                                  p["kvh"], p["hd"], 2)
    pairs = p["b"] * p["h"] * p["s"] * (p["s"] + 1) // 2
    tflops = 4 * pairs * p["hd"] / (tm["ms"] * 1e-3) / 1e12
    print(f"  flash_attention_carry at ring attention's prefill call: "
          f"kernel {tm['ms']:.4f} ms ({tflops:.1f} TFLOP/s over the "
          f"unmasked pairs), bound {tm['bound_ms']:.4f} ms "
          f"({tm['bound_by']}; the kernel reaches "
          f"{tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
          f"{tm['plain_ms']:.4f} ms, library yardstick "
          f"F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
          f"on the same q, k, v (the step at an empty carry, finalized) "
          f"{tm['library_ms']:.4f} ms", flush=True)
    del sets, lib_in, kernel, plain, lib
    torch.cuda.empty_cache()
    return tm, err_bf16


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving path
# ---------------------------------------------------------------------------


def make_prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 1)
    plens = rng.integers(64, 257, size=8)
    return [rng.integers(0, vocab - 1, size=int(p)).astype(np.int32)
            for p in plens]


def serve(torch, model, prompts, n_new, **kw):
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, slots=8, page_size=16, max_seq=512, **kw)
    rids = [eng.submit(p, n_new) for p in prompts]
    paged.LAUNCHES = 0                # counts of this run only
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged.LAUNCHES
    return [out[r] for r in rids], eng, wall, launches


def profile_decode_step(torch, model, slots: int = 8, page: int = 16,
                        pos: int = 192) -> None:
    """Where one serving decode step's time goes: host wall per step (no
    profiler), device time per step by kernel from torch.profiler, and the
    device's busy share.  Every slot is active at position ``pos``."""
    from torch.profiler import ProfilerActivity, profile

    dev = model.device
    pmax = 512 // page
    specs = model.paged_cache_specs(slots, slots * pmax, page)
    cache = {k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in specs.items()}
    table = torch.arange(slots * pmax, dtype=torch.int32,
                         device=dev).reshape(slots, pmax)
    tok = torch.arange(slots, dtype=torch.int32, device=dev)
    posv = torch.full((slots,), pos, dtype=torch.int32, device=dev)
    act = torch.ones(slots, dtype=torch.bool, device=dev)

    def step():
        return model.decode_step_paged(cache, table, tok, posv, act)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    per_kernel = device_ms_by_kernel(torch, prof, n)
    dev_ms = sum(per_kernel.values())
    print(f"  one decode step (8 slots at position {pos}): {wall_ms:.2f} ms "
          f"host wall, {dev_ms:.2f} ms device time by torch.profiler "
          f"(busy share {dev_ms / wall_ms * 100:.1f}%; weights-streaming "
          f"bound {model.cfg.param_count() * 2 / HBM_BW * 1e3:.2f} ms)",
          flush=True)
    print_by_kind(per_kernel, "decode step")


def phase_serve(torch):
    from repro_torch import configs
    from repro_torch.core import managed
    from repro_torch.models.model import Model

    cfg = configs.get_config("phi4-mini-3.8b")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(gen)
    torch.cuda.synchronize()
    print(f"  phi4-mini-3.8b: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.padded_heads} heads ({cfg.n_heads} padded), "
          f"{cfg.param_count() / 1e9:.2f} B params, bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = make_prompts(cfg.vocab_size)
    with managed.capture_decisions() as cap:
        got, eng, wall, launches = serve(torch, model, prompts, 32,
                                         schedule="auto")
    for i, toks in enumerate(got):
        if len(toks) != 32 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"request {i} returned {len(toks)} tokens "
                 f"in [{toks.min()}, {toks.max()}]")
    want = cfg.n_layers * eng.decode_steps
    if launches != want:
        fail(f"paged-attention launches {launches} != n_layers x decode "
             f"steps = {cfg.n_layers} x {eng.decode_steps}")
    s = eng.metrics.summary()
    tokens = sum(len(p) for p in prompts) + sum(len(t) for t in got)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  served 8 requests (prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))}, 32 new each): {tokens} tokens in "
          f"{wall:.2f} s = {tokens / wall:.1f} tok/s end to end, "
          f"{s['useful_tok_s']:.1f} useful tok/s; mean TTFT "
          f"{s['mean_ttft_s'] * 1e3:.1f} ms, mean TPOT "
          f"{s['mean_tpot_s'] * 1e3:.2f} ms, {s['quanta']} quanta, "
          f"{eng.decode_steps} decode steps, peak memory {peak_gb:.2f} GB",
          flush=True)
    for rec in cap.records:
        if rec.op == "serve_schedule":
            print(f"  decision serve_schedule({rec.mode}, C={rec.chunks}) "
                  f"pred static={rec.predicted_bulk_s * 1e6:.1f}us/tok "
                  f"chosen={rec.predicted_interleaved_s * 1e6:.1f}us/tok",
                  flush=True)
    print(f"  paged_attention launches {launches} = {cfg.n_layers} layers "
          f"x {eng.decode_steps} decode steps; {wall / eng.decode_steps * 1e3:.2f}"
          f" ms host wall per decode step", flush=True)
    profile_decode_step(torch, model)
    del model, eng
    torch.cuda.empty_cache()
    return launches


def phase_e2e(torch):
    from repro_torch import configs
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("phi4-mini-3.8b"),
                              n_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Model(cfg, device="cuda").init(gen)
    prompts = make_prompts(cfg.vocab_size)
    runs = {}
    for engine in ("auto", "torch"):
        model.paged_engine = engine
        got, eng, _, launches = serve(torch, model, prompts, 32,
                                      schedule="continuous", chunk=16)
        want = cfg.n_layers * eng.decode_steps if engine == "auto" else 0
        if launches != want:
            fail(f"{engine}: paged-attention launches {launches} != {want}")
        runs[engine] = got
    for i, (a, b) in enumerate(zip(runs["auto"], runs["torch"])):
        if not np.array_equal(a, b):
            fail(f"request {i}: kernel path {a.tolist()} != plain path "
                 f"{b.tolist()}")
    print(f"  phi4-mini-3.8b full width, 2 layers, f32 (TF32 off): greedy "
          f"tokens of 8 requests equal between the kernel path and the "
          f"plain path", flush=True)


# ---------------------------------------------------------------------------
# phases 5 and 6: the training path
# ---------------------------------------------------------------------------


def device_ms_by_kernel(torch, prof, n: int) -> dict[str, float]:
    """Device milliseconds per step by kernel name from a profile of ``n``
    steps."""
    per_kernel: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type.name == "CUDA":
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / n
    return per_kernel


def kind_of(name: str) -> str:
    """The kind of a profiled kernel, by its name."""
    return ("grouped expert FFN" if "ffn_up" in name or "ffn_down" in name
            else "flash carry step" if "flash_fwd" in name
            and "true>" in name
            else "flash block backward" if "flash_bwd_wgmma" in name
            and "true>" in name
            else "flash backward" if "flash_bwd" in name
            or "flash_dsum" in name or "to_bf16_kernel" in name
            else "flash forward" if "flash_" in name
            else "paged attention" if "paged" in name
            else "GEMM" if any(t in name for t in ("nvjet", "gemm", "xmma",
                                                   "cutlass", "Kernel2"))
            else "copies" if "copy" in name or "Memcpy" in name
            else "other elementwise, sorts and reductions")


def print_by_kind(per_kernel: dict[str, float], what: str) -> None:
    """Device time of a profile by kind of kernel, then the top six."""
    if not per_kernel:
        print("  torch.profiler recorded no device time", flush=True)
        return
    dev_ms = sum(per_kernel.values())
    groups: dict[str, float] = {}
    for name, ms in per_kernel.items():
        groups[kind_of(name)] = groups.get(kind_of(name), 0.0) + ms
    print(f"  {what} device time by kind: " + "; ".join(
        f"{g} {ms:.2f} ms ({ms / max(dev_ms, 1e-9) * 100:.1f}%)"
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])),
        flush=True)
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {ms:.3f} ms ({ms / max(dev_ms, 1e-9) * 100:.1f}%) "
              f"{name[:90]}", flush=True)


def train_batch(torch, data, step):
    return {k: torch.from_numpy(v).to("cuda")
            for k, v in data.global_batch_at(step).items()}


def phase_train(torch):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import build_train_step

    cfg = configs.get_config("phi4-mini-3.8b")
    b, s = TRAIN_ATTN["b"], TRAIN_ATTN["s"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Model(cfg, device="cuda").init(gen)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                          moment_dtype=cfg.moment_dtype)
    opt = adamw_init(model.params(), opt_cfg)
    step = build_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))
    print(f"  phi4-mini-3.8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.2f} B params in bf16, f32 AdamW "
          f"moments, remat={cfg.remat}; B={b}, S={s}", flush=True)
    losses, walls, counts = [], [], []
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0     # counts of this run only
    for i in range(5):
        batch = train_batch(torch, data, i)
        f0, b0 = fa.FWD_LAUNCHES, fa.BWD_LAUNCHES
        t0 = time.perf_counter()
        opt, metrics = step(opt, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        counts.append((fa.FWD_LAUNCHES - f0, fa.BWD_LAUNCHES - b0))
        print(f"  step {i}: loss {loss:.4f}, {walls[-1] * 1e3:.1f} ms host "
              f"wall, grad norm {float(metrics['grad_norm']):.4f}, flash "
              f"launches {counts[-1][0]} forward / {counts[-1][1]} "
              f"backward", flush=True)
    launches = {"fwd": fa.FWD_LAUNCHES, "bwd": fa.BWD_LAUNCHES}
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    want = (2 * cfg.n_layers, cfg.n_layers)
    if any(c != want for c in counts):
        fail(f"flash launches per step {counts} != {want} (layers + "
             "remat recompute forward, layers backward)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tok_s = b * s * 3 / sum(walls[2:])
    print(f"  5 steps: losses {[round(x, 4) for x in losses]}; after 2 "
          f"warm-up steps {sum(walls[2:]) / 3 * 1e3:.1f} ms per step = "
          f"{tok_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB",
          flush=True)

    # where one step's device time goes (a sixth step, outside the counts)
    batch = train_batch(torch, data, 5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, metrics = step(opt, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    per_kernel = device_ms_by_kernel(torch, prof, 1)
    dev_ms = sum(per_kernel.values())
    flash_ms = sum(v for k, v in per_kernel.items() if "flash_" in k)
    print(f"  one step under torch.profiler: {prof_wall * 1e3:.1f} ms host "
          f"wall, {dev_ms:.1f} ms device time (busy share "
          f"{dev_ms / (prof_wall * 1e3) * 100:.1f}%), flash kernels "
          f"{flash_ms:.1f} ms ({flash_ms / max(dev_ms, 1e-9) * 100:.1f}%)",
          flush=True)
    print_by_kind(per_kernel, "training step")

    # prefill of 2 prompts of 1024 tokens through the same weights
    del opt, step, batch, metrics
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(data.global_batch_at(6)["tokens"]).cuda()
    model.prefill_sp({"tokens": tokens})                  # warm-up
    f0 = fa.FWD_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    if fa.FWD_LAUNCHES - f0 != cfg.n_layers:
        fail(f"prefill launched the flash forward "
             f"{fa.FWD_LAUNCHES - f0} times, not {cfg.n_layers}")
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (
            b, cfg.padded_vocab):
        fail(f"prefill logits {tuple(logits.shape)} not finite")
    print(f"  prefill_sp of {b} prompts x {s} tokens: {pre_ms:.1f} ms "
          f"({b * s / pre_ms * 1e3:.0f} tokens/s), cache "
          f"{tuple(cache['kv'][0].shape)} x 2", flush=True)
    del model, logits, cache
    torch.cuda.empty_cache()
    return launches


def check_loss_and_grads(a: dict, b: dict, what: str) -> tuple:
    """The kernel path's loss within rtol 1e-5 of the plain path's and
    every gradient within 1e-4 of its largest magnitude; returns the worst
    (relative error, name)."""
    if abs(a["loss"] - b["loss"]) > 1e-5 * abs(b["loss"]):
        fail(f"{what}: loss {a['loss']} (kernels) != {b['loss']} (plain)")
    worst = max(((g - b["grads"][k]).abs().max().item()
                 / max(b["grads"][k].abs().max().item(), 1e-30), k)
                for k, g in a["grads"].items())
    if worst[0] > 1e-4:
        fail(f"{what}: gradient {worst[1]} differs by {worst[0]:.2e} of "
             "its largest magnitude between kernels and plain")
    return worst


def phase_parity(torch):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.serve_loop import Generator
    from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                              build_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("phi4-mini-3.8b"),
                              n_layers=2, dtype="float32")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_ATTN["s"],
                                      global_batch=TRAIN_ATTN["b"],
                                      seed=SEED))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    runs = {}
    for engine in ("auto", "torch"):
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model = Model(cfg, device="cuda", attn_engine=engine).init(gen)
        p0 = {k: v.detach().clone() for k, v in
              flatten_specs(model.params()).items()}
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        loss, _ = model.loss_sp(train_batch(torch, data, 0))
        grads = torch.autograd.grad(
            loss, list(flatten_specs(model.params()).values()))
        grads = dict(zip(flatten_specs(model.params()), grads))
        want = (2 * cfg.n_layers, cfg.n_layers) if engine == "auto" \
            else (0, 0)
        if (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) != want:
            fail(f"{engine}: flash launches {fa.FWD_LAUNCHES} / "
                 f"{fa.BWD_LAUNCHES} for one loss and gradient, not {want}")
        step = build_train_step(model, opt_cfg)
        opt = adamw_init(model.params(), opt_cfg)
        losses = []
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        for i in range(3):
            opt, m = step(opt, train_batch(torch, data, i))
            losses.append(float(m["loss"]))
        if (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) != tuple(3 * w for w in want):
            fail(f"{engine}: flash launches {fa.FWD_LAUNCHES} / "
                 f"{fa.BWD_LAUNCHES} in 3 steps, not {3 * want[0]} / "
                 f"{3 * want[1]}")
        upd = {k: (v.detach() - p0[k]) for k, v in
               flatten_specs(model.params()).items()}
        prompts = data.global_batch_at(9)["tokens"][:, :256]
        logits, _ = model.prefill_sp({"tokens": torch.from_numpy(
            prompts).cuda()})
        runs[engine] = dict(loss=loss.item(), grads=grads, losses=losses,
                            upd=upd, greedy=logits.argmax(-1).cpu())
        if engine == "auto":
            kernel_model = model
        else:
            del model
        del opt, step, p0
        torch.cuda.empty_cache()
    a, b = runs["auto"], runs["torch"]
    worst = check_loss_and_grads(a, b, "phi4-mini-3.8b")
    if not np.allclose(a["losses"], b["losses"], rtol=1e-5, atol=0):
        fail(f"3-step losses {a['losses']} != {b['losses']}")
    upd_err = max(((u - b["upd"][k]).norm() / max(b["upd"][k].norm(),
                                                  1e-30)).item()
                  for k, u in a["upd"].items())
    if upd_err > 1e-3:
        fail(f"parameter updates after 3 steps differ by {upd_err:.2e} "
             "(relative norm) between kernels and plain")
    if not torch.equal(a["greedy"], b["greedy"]):
        fail(f"prefill greedy tokens {a['greedy'].tolist()} (kernels) != "
             f"{b['greedy'].tolist()} (plain)")
    print(f"  phi4-mini-3.8b full width, 2 layers, f32 (TF32 off), "
          f"B={TRAIN_ATTN['b']}, S={TRAIN_ATTN['s']}: loss "
          f"{a['loss']:.6f} vs {b['loss']:.6f}; every "
          f"gradient within {worst[0]:.2e} of its largest magnitude "
          f"(tolerance 1e-4); 3 steps' losses {a['losses']} vs "
          f"{b['losses']} (rtol 1e-5); updates within {upd_err:.2e} "
          f"(relative norm, tolerance 1e-3); prefill greedy tokens equal",
          flush=True)

    # the contiguous Generator against the paged ServeEngine, kernel model
    prompts = data.global_batch_at(10)["tokens"][:, :96]
    shape = ShapeConfig("smoke", 256, prompts.shape[0], "decode")
    contiguous = Generator(kernel_model, shape).generate(prompts, 16)
    paged = Generator(kernel_model, shape, engine="paged",
                      page_size=16).generate(prompts, 16)
    if not np.array_equal(contiguous, paged):
        fail(f"contiguous Generator {contiguous.tolist()} != paged engine "
             f"{paged.tolist()}")
    print(f"  Generator: contiguous cache and paged ServeEngine give the "
          f"same {paged.shape[1]} greedy tokens for {paged.shape[0]} "
          f"prompts of {prompts.shape[1]}", flush=True)

    # TrainLoop with an injected failure, checkpoints in a temporary dir
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        boom = {"armed": True}

        def fault(i):
            if i == 2 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected failure")

        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
        loop = TrainLoop(build_train_step(kernel_model, opt_cfg),
                         kernel_model, opt_cfg, data,
                         TrainLoopConfig(total_steps=3, ckpt_every=2,
                                         ckpt_dir=ckpt_dir, keep=1),
                         fault_hook=fault)
        t0 = time.perf_counter()
        opt, s0 = loop.init_state(SEED)
        out = loop.run(opt, s0)
        wall = time.perf_counter() - t0
        if out["step"] != 3 or out["restarts"] != 1 or not all(
                np.isfinite(h["loss"]) for h in out["history"]):
            fail(f"TrainLoop ended at {out['step']} with "
                 f"{out['restarts']} restarts: {out['history']}")
        saves = loop.ckpt_metrics.saves
        print(f"  TrainLoop: 3 steps, a failure at step 2 restored from "
              f"the step-2 checkpoint ({len(saves)} saves of "
              f"{saves[-1].nbytes / 1e9:.2f} GB, snapshot "
              f"{saves[-1].snapshot_s:.2f} s, drain {saves[-1].drain_s:.2f}"
              f" s, write {saves[-1].write_s:.2f} s); {wall:.1f} s in all",
              flush=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del kernel_model, loop, opt, out
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: the paper's Jacobi solve
# ---------------------------------------------------------------------------


def jacobi_launches(mode, k, iters):
    """(jacobi_step, jacobi_ksweep) launches of one solve on one rank."""
    if mode == "bulk":
        return iters, 0
    if mode == "interleaved":
        return 2 * iters, 0                   # interior pass + edge rows
    return iters % k, iters // k


def phase_jacobi(torch):
    from repro_torch.core import halo, managed
    from repro_torch.kernels import stencil as st

    n, iters = JACOBI_N, JACOBI_ITERS
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    u = torch.randn((n, n), generator=gen, device="cuda")
    f = torch.randn((n, n), generator=gen, device="cuda")
    with managed.capture_decisions() as cap:
        decision = managed.resolve_halo_aggregation("x", 1, n, n)
    rec = cap.records[-1]
    print(f"  grid {n} x {n} f32 (interior {n - 2}^2, "
          f"{u.numel() * 4 / 1e9:.2f} GB per array), one rank, {iters} "
          f"sweeps per schedule; decision (H100 model, axis size 1): "
          f"{rec}", flush=True)
    print(f"  predicted per sweep: " + ", ".join(
        f"k={k} {t * 1e3:.4f} ms" for k, t in decision.per_sweep_s.items()),
        flush=True)
    runs = [("bulk", 1), ("interleaved", 1), ("aggregated", decision.k)]
    runs += [("aggregated", k) for k in (2, 4, 8)]
    for mode, k in runs:                       # warm-up: libraries, opt-ins
        halo.jacobi_solve(u[:258], f[:258], None, 2 * k, mode, k=k)
    torch.cuda.synchronize()
    st.STEP_LAUNCHES = st.KSWEEP_LAUNCHES = 0  # counts of this run only
    bulk, peak_gb = None, 0.0
    for mode, k in runs:
        s0, k0 = st.STEP_LAUNCHES, st.KSWEEP_LAUNCHES
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = halo.jacobi_solve(u, f, None, iters, mode, k=k)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
        got = (st.STEP_LAUNCHES - s0, st.KSWEEP_LAUNCHES - k0)
        want = jacobi_launches(mode, k, iters)
        name = mode if mode != "aggregated" else f"aggregated k={k}"
        if got != want:
            fail(f"{name}: (jacobi_step, jacobi_ksweep) launches {got} != "
                 f"{want}")
        if not torch.isfinite(out).all():
            fail(f"{name}: solution not finite")
        sweeps_of_one = iters % k if mode == "aggregated" else iters
        moved = (sweeps_of_one * (3 * n + 2)
                 + got[1] * (3 * n + 4 * k)) * n * 4
        line = (f"  {name}: {wall / iters * 1e3:.4f} ms per sweep "
                f"({wall:.3f} s host wall for {iters}), {moved / wall / 1e9:.1f}"
                f" GB/s effective HBM, launches {got[0]} jacobi_step + "
                f"{got[1]} jacobi_ksweep")
        if bulk is None:
            bulk = out
        else:
            err = (out - bulk).abs().max().item()
            try:
                torch.testing.assert_close(out, bulk, rtol=1e-5, atol=1e-5)
            except AssertionError as e:
                fail(f"{name} disagrees with bulk: {e}")
            line += f"; max|x - bulk| {err:.1e} (rtol = atol = 1e-5)"
        print(line, flush=True)
        del out
    launches = {"step": st.STEP_LAUNCHES, "ksweep": st.KSWEEP_LAUNCHES}
    print(f"  peak device memory of a solve {peak_gb:.2f} GB (u, f, two "
          f"ping-pong buffers and the bulk result kept for the checks); "
          f"max|u| after {iters} sweeps {bulk.abs().max().item():.4g}",
          flush=True)
    del bulk

    # the kernel path against the plain path, every schedule, 64 sweeps
    m2 = 2050
    us, fs = u[:m2, :m2].contiguous(), f[:m2, :m2].contiguous()
    del u, f
    torch.cuda.empty_cache()
    worst = 0.0
    for periodic in (False, True):
        for mode, k in runs:
            got = halo.jacobi_solve(us, fs, None, 64, mode, k=k,
                                    periodic=periodic)
            want = halo.jacobi_solve(us, fs, None, 64, mode, k=k,
                                     periodic=periodic, engine="torch")
            try:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            except AssertionError as e:
                fail(f"{mode} k={k} periodic={periodic}: kernel path "
                     f"disagrees with the plain path at {m2}^2: {e}")
            worst = max(worst, (got - want).abs().max().item())
    print(f"  kernel path vs plain path at {m2} x {m2}, 64 sweeps, every "
          f"schedule above, periodic and not: max|err| {worst:.1e} "
          f"(rtol = atol = 1e-5)", flush=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8: moonshot-v1-16b-a3b (MoE): prefill, serving, training, parity
# ---------------------------------------------------------------------------


def moe_prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 2)
    plens = rng.integers(32, 65, size=8)
    return [rng.integers(0, vocab - 1, size=int(p)).astype(np.int32)
            for p in plens]


def phase_moe_serve(torch):
    """Steps 1-3: moonshot uncut, prefill with the grouped kernel, then
    served through the paged engine."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.core import managed
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models.model import Model

    cfg = configs.get_config("moonshot-v1-16b-a3b")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(gen)
    torch.cuda.synchronize()
    e = cfg.moe
    print(f"  moonshot-v1-16b-a3b: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, {e.n_experts} experts top-"
          f"{e.top_k} (d_ff {e.d_ff_expert}, {cfg.mlp}), vocab "
          f"{cfg.vocab_size}, {cfg.param_count() / 1e9:.2f} B params, bf16, "
          f"init {time.perf_counter() - t0:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    p = MOE_PREFILL
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size - 1, size=(p["b"], p["s"])).astype(np.int32)).cuda()
    with managed.capture_decisions() as cap:
        model.prefill_sp({"tokens": tokens})                 # warm-up
    torch.cuda.synchronize()
    gm.GROUPED_LAUNCHES = 0                      # counts of this run only
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    launches = {"grouped": gm.GROUPED_LAUNCHES, "fwd": fa.FWD_LAUNCHES}
    if launches != {"grouped": cfg.n_layers, "fwd": cfg.n_layers}:
        fail(f"prefill launched {launches}, not {cfg.n_layers} of each")
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (
            p["b"], cfg.padded_vocab):
        fail(f"prefill logits {tuple(logits.shape)} not finite")
    for rec in cap.records:
        print(f"  decision moe_dispatch({rec.mode} g={rec.chunks}, capacity "
              f"buffers {rec.nbytes / 1e6:.1f} MB, H100 model "
              f"{rec.predicted_interleaved_s * 1e3:.3f} ms per layer)",
              flush=True)
    print(f"  prefill_sp of {p['b']} prompts x {p['s']} tokens: "
          f"{pre_ms:.1f} ms ({p['b'] * p['s'] / pre_ms * 1e3:.0f} tokens/s)"
          f", {launches['grouped']} grouped_expert_ffn and "
          f"{launches['fwd']} flash forward launches, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del logits, cache
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = model.prefill_sp({"tokens": tokens})
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    del out
    per_kernel = device_ms_by_kernel(torch, prof, 1)
    dev_ms = sum(per_kernel.values())
    print(f"  one prefill under torch.profiler: {prof_ms:.1f} ms host wall, "
          f"{dev_ms:.1f} ms device time (busy share "
          f"{dev_ms / prof_ms * 100:.1f}%)", flush=True)
    print_by_kind(per_kernel, "prefill")
    torch.cuda.empty_cache()

    prompts = moe_prompts(cfg.vocab_size)
    gm.GROUPED_LAUNCHES = 0
    with managed.capture_decisions() as cap:
        got, eng, wall, paged_launches = serve(torch, model, prompts, 16,
                                               schedule="auto")
    for i, toks in enumerate(got):
        if len(toks) != 16 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"request {i} returned {len(toks)} tokens "
                 f"in [{toks.min()}, {toks.max()}]")
    if paged_launches != cfg.n_layers * eng.decode_steps:
        fail(f"paged-attention launches {paged_launches} != n_layers x "
             f"decode steps = {cfg.n_layers} x {eng.decode_steps}")
    if gm.GROUPED_LAUNCHES:
        fail(f"the decode flow launched the grouped kernel "
             f"{gm.GROUPED_LAUNCHES} times")
    sm = eng.metrics.summary()
    n_tok = sum(len(q) for q in prompts) + sum(len(t) for t in got)
    print(f"  served 8 requests (prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))}, 16 new each): {n_tok} tokens in "
          f"{wall:.2f} s = {n_tok / wall:.1f} tok/s end to end, "
          f"{sm['useful_tok_s']:.1f} useful tok/s; mean TTFT "
          f"{sm['mean_ttft_s'] * 1e3:.1f} ms, mean TPOT "
          f"{sm['mean_tpot_s'] * 1e3:.2f} ms, {eng.decode_steps} decode "
          f"steps ({wall / eng.decode_steps * 1e3:.2f} ms host wall each), "
          f"paged_attention launches {paged_launches} = {cfg.n_layers} x "
          f"{eng.decode_steps}", flush=True)
    for rec in cap.records:
        if rec.op == "serve_schedule":
            print(f"  decision serve_schedule({rec.mode}, C={rec.chunks})",
                  flush=True)
    del eng
    torch.cuda.empty_cache()
    profile_decode_step(torch, model)
    del model
    torch.cuda.empty_cache()
    return launches["grouped"], paged_launches


def phase_moe_train(torch):
    """Step 4: moonshot at full width, 4 of its 48 layers, 3 steps."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import build_train_step

    cfg = dataclasses.replace(configs.get_config("moonshot-v1-16b-a3b"),
                              n_layers=4)
    b, s = TRAIN_ATTN["b"], TRAIN_ATTN["s"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Model(cfg, device="cuda").init(gen)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                          moment_dtype=cfg.moment_dtype)
    opt = adamw_init(model.params(), opt_cfg)
    step = build_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))
    n_params = sum(t.numel() for t in model.parameters())
    losses, walls, counts = [], [], []
    gm.GROUPED_LAUNCHES = 0
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
    for i in range(3):
        batch = train_batch(torch, data, i)
        c0 = (gm.GROUPED_LAUNCHES, fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
        t0 = time.perf_counter()
        opt, metrics = step(opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append((gm.GROUPED_LAUNCHES - c0[0], fa.FWD_LAUNCHES - c0[1],
                       fa.BWD_LAUNCHES - c0[2]))
    want = (2 * cfg.n_layers, 2 * cfg.n_layers, cfg.n_layers)
    if not all(np.isfinite(losses)):
        fail(f"non-finite MoE training loss: {losses}")
    if any(c != want for c in counts):
        fail(f"(grouped, flash forward, flash backward) launches per step "
             f"{counts} != {want}")
    print(f"  moonshot-v1-16b-a3b full width, {cfg.n_layers} layers "
          f"({n_params / 1e9:.2f} B params, bf16, f32 AdamW moments, "
          f"remat), B={b}, S={s}: losses {[round(x, 4) for x in losses]}, "
          f"host wall per step {[round(w * 1e3, 1) for w in walls]} ms, "
          f"launches per step (grouped, flash forward, flash backward) "
          f"{counts[0]}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del model, opt, step, batch, metrics
    torch.cuda.empty_cache()
    return gm.GROUPED_LAUNCHES


def phase_moe_parity(torch):
    """Step 5: full width, 2 layers, f32, TF32 off: the kernel path
    against the plain path pinned."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.models import moe
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.train.serve_loop import Generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("moonshot-v1-16b-a3b"),
                              n_layers=2, dtype="float32")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_ATTN["s"],
                                      global_batch=TRAIN_ATTN["b"],
                                      seed=SEED))
    # the smallest gap between the k-th and (k+1)-th router probability
    # of any token: a routing flip between the paths needs a near-tie
    gaps = []
    router = moe._router

    def watched(x, w, n, k):
        out = router(x, w, n, k)
        pr = torch.softmax(x.float() @ w.float(), dim=-1)
        top = torch.topk(pr, k + 1, dim=-1).values
        gaps.append((top[:, k - 1] - top[:, k]).min().item())
        return out

    moe._router = watched
    runs = {}
    try:
        for engine in ("auto", "torch"):
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            model = Model(cfg, device="cuda", attn_engine=engine,
                          moe_engine=engine).init(gen)
            gm.GROUPED_LAUNCHES = 0
            gaps.clear()
            loss, _ = model.loss_sp(train_batch(torch, data, 0))
            leaves = flatten_specs(model.params())
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            want = 2 * cfg.n_layers if engine == "auto" else 0
            if gm.GROUPED_LAUNCHES != want:
                fail(f"{engine}: {gm.GROUPED_LAUNCHES} grouped launches for "
                     f"one loss and gradient, not {want}")
            prompts = data.global_batch_at(9)["tokens"]
            logits, _ = model.prefill_sp({"tokens": torch.from_numpy(
                prompts).cuda()})
            runs[engine] = dict(loss=loss.item(), grads=grads,
                                logits=logits, gap=min(gaps))
            if engine == "auto":
                kernel_model = model
            else:
                del model
            del loss, leaves
            torch.cuda.empty_cache()
    finally:
        moe._router = router
    a, b = runs["auto"], runs["torch"]
    k = cfg.moe.top_k
    print(f"  smallest router gap between a token's {k}th and {k + 1}th "
          f"expert over both layers: {a['gap']:.3e} (kernels), "
          f"{b['gap']:.3e} (plain)", flush=True)
    worst = check_loss_and_grads(a, b, "moonshot-v1-16b-a3b")
    lg_err = (a["logits"] - b["logits"]).abs().max().item()
    lg_scale = b["logits"].abs().max().item()
    if lg_err > 1e-4 * max(1.0, lg_scale):
        fail(f"prefill logits differ by {lg_err:.2e} (scale {lg_scale:.3g})")
    if not torch.equal(a["logits"].argmax(-1), b["logits"].argmax(-1)):
        fail("prefill greedy tokens differ between kernels and plain")
    print(f"  moonshot-v1-16b-a3b full width, 2 layers, f32 (TF32 off), "
          f"B={TRAIN_ATTN['b']}, S={TRAIN_ATTN['s']}: loss {a['loss']:.6f} "
          f"vs {b['loss']:.6f} (rtol 1e-5); every gradient within "
          f"{worst[0]:.2e} of its largest magnitude (tolerance 1e-4); "
          f"prefill logits within {lg_err:.2e} (tolerance 1e-4 x max(1, "
          f"{lg_scale:.3g})), greedy tokens equal", flush=True)
    del runs, a, b
    torch.cuda.empty_cache()

    prompts = data.global_batch_at(10)["tokens"][:, :48]
    shape = ShapeConfig("smoke", 128, prompts.shape[0], "decode")
    contiguous = Generator(kernel_model, shape).generate(prompts, 16)
    paged = Generator(kernel_model, shape, engine="paged",
                      page_size=16).generate(prompts, 16)
    if not np.array_equal(contiguous, paged):
        fail(f"MoE contiguous Generator {contiguous.tolist()} != paged "
             f"engine {paged.tolist()}")
    print(f"  Generator: contiguous cache and paged ServeEngine give the "
          f"same {paged.shape[1]} greedy tokens for {paged.shape[0]} "
          f"prompts of {prompts.shape[1]}", flush=True)
    del kernel_model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: ring attention (context parallelism) on phi4-mini-3.8b
# ---------------------------------------------------------------------------

#: greedy tokens generated from the ring prefill's cache
RING_NEW = 16
#: the bf16 prefill logits of the ring against megatron's: the two
#: attention kernels round their outputs to bf16 after f32 sums taken in
#: other orders, and 32 bf16 layers carry that on (of the largest logit)
RING_LOGIT_TOL = 5e-2


def set_attn_impl(model, impl):
    """Point ``model`` at another SP attention schedule (same weights)."""
    model.cfg = dataclasses.replace(model.cfg, attn_impl=impl)


def phase_ring_prefill_and_train(torch):
    """Steps 1 and 2: phi4-mini-3.8b uncut with attn_impl="ring": prefill
    of 1 x 8192 against megatron's, 16 tokens from its cache, then 3
    training steps.  Returns the carry launches of these runs."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import managed
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.serve_loop import Generator
    from repro_torch.train.train_loop import build_train_step

    cfg = dataclasses.replace(configs.get_config("phi4-mini-3.8b"),
                              attn_impl="ring")
    s = RING_PREFILL["s"]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = Model(cfg, device="cuda").init(gen)
    rng = np.random.default_rng(SEED + 9)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size - 1, size=(1, s)).astype(np.int32)).cuda()
    with managed.capture_decisions() as cap:
        model.prefill_sp({"tokens": tokens})                  # warm-up
    torch.cuda.synchronize()
    fa.CARRY_LAUNCHES = fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
    fa.BWD_BLOCK_LAUNCHES = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    got = (fa.CARRY_LAUNCHES, fa.FWD_LAUNCHES, fa.BWD_LAUNCHES,
           fa.BWD_BLOCK_LAUNCHES)
    if got != (cfg.n_layers, 0, 0, 0):
        fail(f"ring prefill launched (carry, flash forward, flash backward, "
             f"block backward) {got}, not ({cfg.n_layers}, 0, 0, 0)")
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (
            1, cfg.padded_vocab):
        fail(f"ring prefill logits {tuple(logits.shape)} not finite")
    recs = [f"{r.op}({r.mode})" for r in cap.records]
    print(f"  phi4-mini-3.8b uncut, attn_impl='ring', 1 rank: prefill_sp of "
          f"1 x {s} tokens {pre_ms:.1f} ms ({s / pre_ms * 1e3:.0f} "
          f"tokens/s), {got[0]} carry launches, 0 flash launches, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"decisions {recs}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = model.prefill_sp({"tokens": tokens})
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    del out
    per_kernel = device_ms_by_kernel(torch, prof, 1)
    dev_ms = sum(per_kernel.values())
    print(f"  one ring prefill under torch.profiler: {prof_ms:.1f} ms host "
          f"wall, {dev_ms:.1f} ms device time (busy share "
          f"{dev_ms / prof_ms * 100:.1f}%)", flush=True)
    print_by_kind(per_kernel, "ring prefill")

    # the megatron prefill of the same tokens on the same weights
    set_attn_impl(model, "megatron")
    f0 = fa.FWD_LAUNCHES
    mega, mega_cache = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    set_attn_impl(model, "ring")
    if fa.FWD_LAUNCHES - f0 != cfg.n_layers:
        fail("the megatron prefill did not run the flash forward kernel")
    err = (logits - mega).abs().max().item()
    scale = mega.abs().max().item()
    if err > RING_LOGIT_TOL * scale:
        fail(f"ring prefill logits differ from megatron's by {err:.3e} > "
             f"{RING_LOGIT_TOL} x {scale:.3g}")
    kv_err = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(cache["kv"], mega_cache["kv"]))
    del mega_cache
    same = int(logits.argmax(-1).item() == mega.argmax(-1).item())
    gen_tok = Generator(model, ShapeConfig("ring", s + RING_NEW, 1,
                                           "decode"))
    t0 = time.perf_counter()
    new = gen_tok.generate_from_prefill(logits, cache, RING_NEW)
    gen_s = time.perf_counter() - t0
    if new.shape != (1, RING_NEW) or new.min() < 0 \
            or new.max() >= cfg.vocab_size:
        fail(f"generation from the ring prefill gave {new.tolist()}")
    print(f"  against megatron's prefill (flash forward kernel) of the same "
          f"tokens: last-token logits within {err:.3e} (tolerance "
          f"{RING_LOGIT_TOL} x {scale:.3g}), cache K/V identical up to "
          f"{kv_err:.1e}, same greedy token: {bool(same)}; {RING_NEW} greedy "
          f"tokens from the ring prefill's cache through the contiguous "
          f"Generator in {gen_s:.2f} s: {new[0].tolist()}", flush=True)
    del logits, cache, mega, gen_tok
    torch.cuda.empty_cache()

    # 3 training steps at B=2 x S=1024, as phase 5
    b, s_tr = TRAIN_ATTN["b"], TRAIN_ATTN["s"]
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                          moment_dtype=cfg.moment_dtype)
    opt = adamw_init(model.params(), opt_cfg)
    step = build_train_step(model, opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=s_tr, global_batch=b,
                                      seed=SEED))
    losses, walls, counts = [], [], []
    for i in range(3):
        batch = train_batch(torch, data, i)
        c0 = (fa.CARRY_LAUNCHES, fa.FWD_LAUNCHES, fa.BWD_LAUNCHES,
              fa.BWD_BLOCK_LAUNCHES)
        t0 = time.perf_counter()
        opt, metrics = step(opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append((fa.CARRY_LAUNCHES - c0[0], fa.FWD_LAUNCHES - c0[1],
                       fa.BWD_LAUNCHES - c0[2],
                       fa.BWD_BLOCK_LAUNCHES - c0[3]))
    # two prefills (timed and profiled) and three steps
    launches = {"carry": fa.CARRY_LAUNCHES, "block": fa.BWD_BLOCK_LAUNCHES}
    if launches["carry"] != 2 * cfg.n_layers + 3 * 2 * cfg.n_layers:
        fail(f"{launches['carry']} carry launches in the ring runs")
    if launches["block"] != 3 * cfg.n_layers:
        fail(f"{launches['block']} block-backward launches in the ring runs")
    want = (2 * cfg.n_layers, 0, 0, cfg.n_layers)
    if not all(np.isfinite(losses)):
        fail(f"non-finite ring training loss: {losses}")
    if any(c != want for c in counts):
        fail(f"(carry, flash forward, flash backward, block backward) "
             f"launches per ring training step {counts} != {want}")
    print(f"  3 training steps with attn_impl='ring' (B={b}, S={s_tr}, bf16,"
          f" f32 AdamW moments, remat): losses "
          f"{[round(x, 4) for x in losses]}, host wall per step "
          f"{[round(w * 1e3, 1) for w in walls]} ms, launches per step "
          f"(carry, flash forward, flash backward, block backward) "
          f"{counts[0]}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{launches['carry']} carry launches in this phase's ring runs (2 "
          f"prefills x {cfg.n_layers} + 3 steps x {2 * cfg.n_layers}), "
          f"{launches['block']} block-backward launches (3 steps x "
          f"{cfg.n_layers})", flush=True)
    batch = train_batch(torch, data, 3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt, metrics = step(opt, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_ms_by_kernel(torch, prof, 1)
    dev_ms = sum(per_kernel.values())
    print(f"  one ring training step under torch.profiler: {prof_ms:.1f} ms "
          f"host wall, {dev_ms:.1f} ms device time (busy share "
          f"{dev_ms / prof_ms * 100:.1f}%)", flush=True)
    print_by_kind(per_kernel, "ring training step")
    del model, opt, step, batch, metrics
    torch.cuda.empty_cache()
    return launches


def phase_ring_parity(torch):
    """Step 3: full width, 2 layers, f32, TF32 off: ring with the carry
    kernel, ring with the plain step pinned, megatron with the flash
    kernels — loss, gradients, prefill logits and greedy tokens."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.train.serve_loop import Generator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(configs.get_config("phi4-mini-3.8b"),
                               n_layers=2, dtype="float32")
    data = SyntheticLMData(DataConfig(vocab_size=base.vocab_size,
                                      seq_len=TRAIN_ATTN["s"],
                                      global_batch=TRAIN_ATTN["b"],
                                      seed=SEED))
    prompts = torch.from_numpy(
        data.global_batch_at(11)["tokens"][:, :256]).cuda()
    runs = {}
    for name, impl, engine, want in (
            ("ring kernel", "ring", "auto", (4, 0, 0, 2)),
            ("ring plain", "ring", "torch", (0, 0, 0, 0)),
            ("megatron", "megatron", "auto", (0, 4, 2, 0))):
        cfg = dataclasses.replace(base, attn_impl=impl)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model = Model(cfg, device="cuda", attn_engine=engine).init(gen)
        fa.CARRY_LAUNCHES = fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        fa.BWD_BLOCK_LAUNCHES = 0
        loss, _ = model.loss_sp(train_batch(torch, data, 0))
        leaves = flatten_specs(model.params())
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        got = (fa.CARRY_LAUNCHES, fa.FWD_LAUNCHES, fa.BWD_LAUNCHES,
               fa.BWD_BLOCK_LAUNCHES)
        if got != want:
            fail(f"{name}: (carry, flash forward, flash backward, block "
                 f"backward) launches {got} for one loss and gradient, not "
                 f"{want}")
        logits, cache = model.prefill_sp({"tokens": prompts})
        tokens = Generator(model, ShapeConfig("ring", 256 + 8, 2, "decode")) \
            .generate_from_prefill(logits, cache, 8)
        runs[name] = dict(loss=loss.item(), grads=grads, logits=logits,
                          tokens=tokens)
        del model, leaves, cache
        torch.cuda.empty_cache()
    ref = runs["ring plain"]
    lines = []
    for name in ("ring kernel", "megatron"):
        run = runs[name]
        if abs(run["loss"] - ref["loss"]) > 1e-5 * abs(ref["loss"]):
            fail(f"{name}: loss {run['loss']} != {ref['loss']} (ring plain)")
        worst = max(((g - ref["grads"][k]).abs().max().item()
                     / max(ref["grads"][k].abs().max().item(), 1e-30), k)
                    for k, g in run["grads"].items())
        if worst[0] > 1e-5:
            fail(f"{name}: gradient {worst[1]} differs by {worst[0]:.2e} of "
                 "its largest magnitude from the ring's plain path")
        lerr = (run["logits"] - ref["logits"]).abs().max().item()
        lscale = ref["logits"].abs().max().item()
        if lerr > 1e-5 * lscale:
            fail(f"{name}: prefill logits differ by {lerr:.3e} (> 1e-5 x "
                 f"{lscale:.3g})")
        if not np.array_equal(run["tokens"], ref["tokens"]):
            fail(f"{name}: greedy tokens {run['tokens'].tolist()} != "
                 f"{ref['tokens'].tolist()} (ring plain)")
        lines.append(f"{name}: loss {run['loss']:.6f}, gradients within "
                     f"{worst[0]:.2e}, logits within {lerr:.2e}")
    print(f"  phi4-mini-3.8b full width, 2 layers, f32 (TF32 off), "
          f"B={TRAIN_ATTN['b']}, S={TRAIN_ATTN['s']}, against the ring with "
          f"the plain step (loss {ref['loss']:.6f}): " + "; ".join(lines)
          + " (tolerances: loss rtol 1e-5, gradients and logits 1e-5 of the"
          " largest magnitude); prefill of 2 x 256 and 8 greedy tokens from"
          f" its cache equal on all three paths: {ref['tokens'].tolist()}",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()

    print("phase 1: build", flush=True)
    card = card_line()
    print(f"  card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    secs = build.build_all()
    for name, s in secs.items():
        print(f"  built {name}.cu for sm_90a in {s:.1f} s", flush=True)
        for line in build.BUILD_LOG.get(name, (0, ""))[1].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}", flush=True)
    counts = hgmma_counts(build)
    for kernel, n in sorted(counts.items()):
        print(f"  {kernel}: {n} HGMMA instructions", flush=True)
    for kind in ("flash_fwd_wgmma_kernel", "flash_bwd_wgmma_kernel"):
        wgmma = [k for k in counts if k.startswith(kind)]
        if len(wgmma) < 4 or any(counts[k] == 0 for k in wgmma):
            fail(f"the bf16 forward, carry, backward and block backward "
                 f"kernels (hd 64 and 128) must run on the tensor cores; "
                 f"HGMMA counts {counts}")

    print("phase 2: kernels vs plain versions", flush=True)
    main_t, err = phase_kernel(torch)
    flash_t, flash_err = phase_flash(torch)
    stencil_t, stencil_err = phase_stencil(torch)
    grouped_t, grouped_err = phase_grouped(torch)
    carry_t, carry_err = phase_carry(torch)
    print("phase 3: serve phi4-mini-3.8b at full size", flush=True)
    launches = phase_serve(torch)
    print("phase 4: kernel path vs plain path, end to end", flush=True)
    phase_e2e(torch)
    print("phase 5: train phi4-mini-3.8b at full size", flush=True)
    flash_launches = phase_train(torch)
    print("phase 6: training, prefill and generation, kernels vs plain",
          flush=True)
    phase_parity(torch)
    print("phase 7: the paper's Jacobi solve at 16386 x 16386 on one rank",
          flush=True)
    jacobi_launches_run = phase_jacobi(torch)
    print("phase 8: moonshot-v1-16b-a3b (MoE): prefill, serving, training "
          "and parity", flush=True)
    t8 = time.perf_counter()
    grouped_launches, _ = phase_moe_serve(torch)
    phase_moe_train(torch)
    phase_moe_parity(torch)
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s", flush=True)
    print("phase 9: ring attention (context parallelism) on phi4-mini-3.8b",
          flush=True)
    t9 = time.perf_counter()
    ring_launches = phase_ring_prefill_and_train(torch)
    phase_ring_parity(torch)
    print(f"  phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)
    torch.cuda.synchronize()
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)

    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    kernels = [dict(name="paged_attention", route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention.py:103",
                    launches=launches, max_abs_err=err, **main_t),
               dict(name="flash_attention_fwd", route="cuda",
                    source=flash_src,
                    replaces="src/repro/kernels/flash_attention.py:100",
                    launches=flash_launches["fwd"],
                    max_abs_err=flash_err["fwd"], **flash_t["fwd"]),
               dict(name="flash_attention_bwd", route="cuda",
                    source=flash_src,
                    replaces="src/repro/kernels/ops.py:203",
                    launches=flash_launches["bwd"],
                    max_abs_err=flash_err["bwd"], **flash_t["bwd"]),
               dict(name="jacobi_step", route="cuda",
                    source="src/repro_torch/kernels/csrc/stencil.cu",
                    replaces="src/repro/kernels/stencil.py:50",
                    launches=jacobi_launches_run["step"],
                    max_abs_err=stencil_err["step"], **stencil_t["step"]),
               dict(name="jacobi_ksweep", route="cuda",
                    source="src/repro_torch/kernels/csrc/stencil.cu",
                    replaces="src/repro/kernels/stencil.py:129",
                    launches=jacobi_launches_run["ksweep"],
                    max_abs_err=stencil_err["ksweep"],
                    **stencil_t["ksweep"]),
               dict(name="grouped_expert_ffn", route="cuda",
                    source="src/repro_torch/kernels/csrc/grouped_matmul.cu",
                    replaces="src/repro/kernels/grouped_matmul.py:142",
                    launches=grouped_launches, max_abs_err=grouped_err,
                    **grouped_t),
               dict(name="flash_attention_carry", route="cuda",
                    source=flash_src,
                    replaces="src/repro/kernels/flash_attention.py:262",
                    launches=ring_launches["carry"], max_abs_err=carry_err,
                    **carry_t),
               dict(name="flash_attention_bwd_block", route="cuda",
                    source=flash_src,
                    replaces="src/repro/kernels/ops.py:357",
                    launches=ring_launches["block"],
                    max_abs_err=flash_err["bwd_block"],
                    **flash_t["bwd_block"])]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
