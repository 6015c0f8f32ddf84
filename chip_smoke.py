#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
the CUDA toolkit.  Drives the port only — never ``jax`` or ``repro`` —
in phases, one line each, and stops with a non-zero exit at the first
phase that fails:

  1. build   — compile every kernel under src/repro_torch/kernels/csrc
               with nvcc (one process per source, all at once);
  2. kernel  — each kernel's wrapper against its plain PyTorch version on
               the card at the stated tolerances, then timed beside its
               bound, the plain version and a library yardstick;
  3. serve   — phi4-mini-3.8b at its published size (32 layers, bf16,
               seeded random weights) through ServeEngine; the kernel's
               launch count must equal n_layers x decode steps;
  4. e2e     — the same prompts through the engine at full width, 2
               layers, f32, once with the kernel and once with the plain
               version pinned: the greedy tokens must be equal.

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
import subprocess
import sys
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
    per_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type.name == "CUDA":
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / 1e3 / n
    dev_ms = sum(per_kernel.values())
    print(f"  one decode step (8 slots at position {pos}): {wall_ms:.2f} ms "
          f"host wall, {dev_ms:.2f} ms device time by torch.profiler "
          f"(busy share {dev_ms / wall_ms * 100:.1f}%; weights-streaming "
          f"bound {model.cfg.param_count() * 2 / HBM_BW * 1e3:.2f} ms)",
          flush=True)
    if not per_kernel:
        print("  torch.profiler recorded no device time", flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    for name, ms in top:
        print(f"    {ms:.3f} ms/step ({ms / max(dev_ms, 1e-9) * 100:.1f}%) "
              f"{name[:90]}", flush=True)


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
            if "Used" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}", flush=True)

    print("phase 2: kernels vs plain versions", flush=True)
    main_t, err = phase_kernel(torch)
    print("phase 3: serve phi4-mini-3.8b at full size", flush=True)
    launches = phase_serve(torch)
    print("phase 4: kernel path vs plain path, end to end", flush=True)
    phase_e2e(torch)
    torch.cuda.synchronize()
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)

    kernels = [dict(name="paged_attention", route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention.py:103",
                    launches=launches, max_abs_err=err, **main_t)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
