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
               tensor-core (HGMMA) instructions of each flash kernel and
               each grouped-expert tensor-core kernel in its SASS: the
               bf16 forward, carry, backward, block-backward (at hd 64,
               128 and 192) and grouped kernels must have some, and they,
               the paged kernel's bf16 fast path and the grouped
               tensor-core kernels, the backward's ``wgmma`` ones
               among them (each with HGMMA too), must not spill (no
               stack or local memory in ``cuobjdump -res-usage`` of the
               built library);
  2. kernel  — each kernel's wrapper against its plain PyTorch version on
               the card at the stated tolerances (paged attention, with
               its split plan, and its bf16 fast path's f32 split
               partials within 1e-4 of their size; flash attention
               forward and backward), then timed beside its bound, the
               plain version and a library yardstick: paged attention at
               the serve, long-context, granite MQA (48/1) and moonshot
               G=1 (16/16) shapes; its partials entry over a pool cut in
               two halves (each a rank's pool with its offset) in both
               engines against the plain partials (1e-4 of their size)
               and, merged, the plain unsharded output;
  3. serve   — phi4-mini-3.8b at its published size (32 layers, bf16,
               seeded random weights) through ServeEngine, each decode
               step one replay of the step captured at warm-up (the
               engine's ``quantum_mode`` must be "graph"); the kernel's
               launch count must equal n_layers x decode steps; the same
               requests with the step run from Python (``run_eager``)
               must give the same tokens bit for bit; one decode step
               profiled both ways; then the contiguous Generator (8
               prompts of 96 tokens, 64 new, a 256-position cache), each
               token one replay of its captured ``DecodeStep`` and, on a
               Generator of its own, each step from Python
               (``run_eager``), timed in turns while nvidia-smi reads the
               SM clock and profiled by kind: equal tokens, and every step
               a capture or a replay;
  4. e2e     — the same prompts through the engine at full width, 2
               layers, f32, once with the kernel and once with the plain
               version pinned, both captured: the greedy tokens must be
               equal;
  5. train   — phi4-mini-3.8b at its published size (32 layers, bf16,
               B=2, S=1024, AdamW with f32 moments, remat) for 5 steps of
               build_train_step: finite losses, and exactly 64 forward
               (32 layers + 32 recomputed) and 32 backward flash launches
               per step, steps 2-5 replays of the step captured in the
               first (``TrainStep.step_mode`` "graph"); one step replayed
               and one from Python (``run_eager``), each with its host
               wall, device time by kind, busy share and peak memory; then
               prefill_sp on 2 prompts of 1024 tokens;
  6. parity  — training, prefill and generation at full width, 2 layers,
               f32, TF32 off, with the flash kernels and with the plain
               versions pinned: gradients, 3 steps' losses and updates,
               and greedy tokens agree (both paths' steps after the first
               graph replays); the contiguous Generator's tokens, its
               decode steps as graph replays and through ``run_eager``,
               equal the paged engine's; TrainLoop recovers from an
               injected failure through its checkpoints, binding and
               capturing its step again after the restore;
  7. jacobi  — the paper's Jacobi solve at 16386 x 16386 f32 on one rank
               through halo.jacobi_solve: 256 sweeps each of bulk,
               interleaved, and aggregated at the k that
               managed.resolve_halo_aggregation picks and at k = 2, 4, 8,
               with exact stencil launch counts; aggregated equals bulk,
               and at 2050 x 2050 the kernel path equals the plain path
               in every schedule;
  8. moe     — moonshot-v1-16b-a3b (MoE, 64 experts top-6) uncut (48
               layers, bf16, 56 GB of seeded random weights): prefill_sp
               of 4 x 1024 tokens with exactly 48 grouped-expert launches,
               all on the tensor-core engine, and 48 flash launches; 8
               requests served through ServeEngine (paged launches = 48 x
               decode steps, no grouped launch); 3 training steps at full
               width and 4 layers with exactly 8 grouped launches per
               step, all on the tensor cores, and exactly 4 grouped
               backward launches per step on the tensor cores, steps 2-3
               graph replays, then one step replayed and one from Python
               timed and profiled as phase 5's; and at 2 layers in f32
               (the grouped kernels' SIMT engines, forward and backward)
               the kernel path against the plain path (loss, gradients,
               prefill logits) and the contiguous Generator against the
               paged engine; no plain grouped FFN, grouped backward or
               paged partials version gets a CUDA tensor on the kernel
               path (``plain_spy``);
  9. ring    — ring attention (context parallelism) on phi4-mini-3.8b
               uncut with attn_impl="ring" at one rank: prefill_sp of
               1 x 8192 tokens with exactly 32 carry-kernel launches and
               no flash launch, its logits against the megatron prefill
               of the same tokens, 16 greedy tokens from its cache; 3
               training steps (B=2, S=1024) with exactly 64 carry launches
               (32 layers + 32 recomputed) and 32 block-backward launches
               per step, steps 2-3 graph replays; and at 2 layers in f32
               the ring with the kernels,
               the ring with the plain step and its plain backward, and
               megatron with the flash kernels agree in loss, gradients,
               prefill logits and greedy tokens;
 10. examples — ``repro_torch.examples.quickstart`` (30 steps of reduced
               granite-34b, falling finite losses, 8 greedy tokens,
               exactly 4 forward and 2 backward flash launches a step on
               the head_dim 16 kernels, which are held to their plain
               versions at its shape, and its model in f32 with the
               kernels against the plain path) and
               ``train_100m --steps 50`` (110 M
               parameters, S 256, B 8, 1x1, async checkpoints; exactly
               24 forward and 12 backward flash launches a step): host
               wall per step and tokens/s beside the card; in both every
               step after the first a graph replay; one train_100m step
               replayed and one from Python, timed and profiled as phase
               5's;
 11. mesh    — two processes on the one card over gloo (``--mesh-rank``,
               file:// init): phi4-mini-3.8b at full width, 2 layers, f32,
               TF32 off; one ``build_train_step`` step (B 2, S 1024) on
               the 1x2 and 2x1 meshes against rank 0's 1x1 step on the
               same weights (loss rtol 2e-4; gradient norm rtol 1e-5;
               every parameter, gathered, rtol 2e-3 / atol 3e-4; flash
               launches per rank exact), the
               1x2 ``ServeEngine``'s greedy tokens against 1x1's (its
               pool over 2 cache shards: the paged kernel's partials on
               both ranks, no plain partials), the
               bytes between the card and host memory per step (gloo on
               one card, not NCCL: staged messages and gloo's own copies
               of all-reduces), and ``jacobi_mdmp --ranks 2`` (every
               schedule equal, and equal to one rank); the mesh steps run
               eager (gloo), the 1x1 oracle through ``run_eager``;
 12. moe     — two processes on the card again (``--moe-mesh-rank``):
    mesh       moonshot-v1-16b-a3b at full width, 2 layers, f32, a
               capacity factor that drops no token; one train step (B 2,
               S 512) on a 1x2 mesh under ep_a2a bulk, ep_a2a stream (g =
               2) and expert_tp against rank 0's 1x1 step (loss and
               gradient norm rtol 1e-5, gathered parameters as phase 11;
               the ep runs against 1x1 with ep_a2a's rank-averaged
               load-balance term), grouped launches exact (SIMT), one f32
               grouped backward launch per forward call on each rank and
               no plain version on a CUDA tensor, the 1x2
               engine's tokens against 1x1's, and a bf16 prefill per
               layout whose grouped launches all take the tensor cores and
               whose first call, at its shard shape, is held to the plain
               version as phase 2 holds it; the steps eager as phase 11's;
 13. families — the flash kernels against the plain versions at the
               families' shapes; mamba2-130m (bf16, uncut) through
               ServeEngine against the contiguous Generator; hymba-1.5b
               uncut: a 2 x 2048 prefill (its 1024 window bites), served,
               three bf16 training steps of 1 x 2048 (a capture, two
               replays); whisper-small (1500
               stub frames, prefill 2 x 448, 16 tokens) and internvl2-1b
               (256 stub patches, prefill 2 x 1024, 16 tokens); f32
               training of mamba2 and hymba (4 layers) at chunk 256 with
               every gradient finite; each family at 2 layers in f32 with
               the kernels against the plain path (loss 1e-5, gradients
               1e-4); hymba's paged kernel against the plain paged path;
               exact flash and paged launch counts throughout; and
               ``repro_torch.examples.serve_batched`` on the card;
 14. pipeline — phi4-mini-3.8b uncut as one pipeline stage
               (``build_train_step(pipeline="1f1b")``, M = 2 one-row
               microbatches of B=2 x S=1024): 2 warm-up and 3 timed steps
               and a gpipe step, exactly 128 forward and 64 backward flash
               launches a step, the first loss within 2e-3 of phase 5's
               plain step, every pipelined step eager; two processes on
               the card as pod stages over
               gloo (``--pipe-mesh-rank``): phi4-mini at full width, 4
               layers, f32, one step under gpipe, 1f1b, interleaved and
               auto against rank 0's 1x1 step (loss and gradient norm
               rtol 1e-5, gradients rtol 3e-4 / atol 1e-6, updated
               parameters phase 11's rtol 2e-3 / atol 3e-4), flash
               launches per rank exact, each rank's handoff messages and
               card-host bytes; the int8 pod reduction on a 2x1x1
               data-parallel run (3 steps' losses against the f32 pod
               all-reduce's, the payload a quarter of f32's plus the
               scales); and train_100m's model through TrainLoop with the
               managed cadence and a fault plan placed on that run's own
               saves (a rank death and a corrupt checkpoint): every event
               fires, each restore binds the step again and captures it
               again (every other step a replay), the restore passes over
               the corrupt checkpoint, the
               ckpt_interval decisions print with the measured write
               bandwidth, and the resumed losses equal the nearer of two
               uninterrupted runs' (bit for bit when those agree, else
               within FAULT_SPREAD_FACTOR times their spread);
 15. plan    — the directives, the planner, the verifier and the trace:
               ``launch.train`` with phi4-mini uncut (B=2 x S=1024, 3
               steps, 1x1) planned, strictly verified and traced against
               the plain launch (the program_plan line, no finding,
               exactly 64 / 32 flash launches a step, steps 2-3 graph
               replays, the first loss bit for bit and later ones within
               PLAN_LOSS_RTOL, the trace's
               spans, ``launch.trace`` summary and diff), the end-of-run
               save stood in; ``launch.serve`` planned and traced on
               phase 3's requests (phase 3's tokens, 32 paged launches a
               decode step); two processes (``--plan-mesh-rank``) running
               ``launch.train`` on a 1x2 mesh (phi4-mini at full width, 2
               layers, f32, S 256, attn_impl auto) planned and strictly
               verified against plain (the plan's knob in the attention
               records, loss and gradient norm within phase 11's
               tolerances); ``CommRegion.plan`` of the Jacobi region on
               meta specs (k as ``resolve_halo_aggregation``, card memory
               and every launch count unchanged, the stencil kernel one
               recorded op reading u and f), ``jacobi_mdmp`` and
               ``moe_dispatch --ranks 2`` (schedules agree, grouped
               launches counted);
 16. dryrun  — ``repro_torch.launch.dryrun`` counts one rank's step on
               abstract tensors: phase 5's training step and prefill and
               phase 8's moonshot prefill, each with its predicted flash
               and grouped launches equal to the measured ones, its H100
               roofline bound (launch/hlo.py's FLOPs and device-memory
               bytes) at or below the measured time, and (phase 5) its
               predicted peak memory within DRYRUN_PEAK_BAND of
               ``max_memory_allocated``; then four production cells on a
               fake 256 / 512-rank group (``DRYRUN_CELLS``), each ok, with
               no process group left and the card untouched (a step on
               meta tensors runs eager);
 17. nemotron — nemotron-4-340b at full width (d_model 18432, 96/8 heads
               of 192, d_ff 73728 relu2, vocab 256000), cut to 2 layers in
               bf16: prefill_sp of 1 x 4096 (2 flash launches, logits
               within 2e-2 of the plain engine's, timed in turns with it
               while nvidia-smi reads the SM clock), phase 3's 8 requests
               through ServeEngine (paged launches = 2 x decode steps on
               paged_mma_kernel<192>, the prompts included: the engine's
               chunked prefill runs the paged decode step, no flash
               launch), a 1 x 8192 ring prefill (2 carry launches, no
               flash, logits against megatron's); at 1 layer in f32 the
               kernel path's prefill logits (1e-4) and greedy tokens
               against the plain path's; and nemotron's reduced config
               widened to head_dim 192 (d_model 768, 4/2 heads, d_ff 3072)
               trained 3 AdamW steps in bf16 at B=2 x S=2048 with exact
               flash launch counts (steps 2-3 graph replays), and in f32
               held to the plain path
               (loss 1e-5, gradients 1e-4).

Phase 2 also holds the flash forward, backward, carry step and block
backward at head_dim 192 (nemotron's call, 1 x 4096 at 96/8 heads, and
GQA 12:1, MHA, windowed, ragged and offset cases) to their plain versions
in f32 and bf16 with exact launch counts, and times them at nemotron's
call beside their bounds, the plain versions and SDPA (enable_gqa).
Phase 2 also holds the two stencil kernels (one sweep; k sweeps per round
trip), the grouped-expert FFN, the ring's block backward (bf16 in, f32
out, at the ring training step's shape) and the ring-attention carry step
(its variants, and a virtual 4-rank ring folded on one card against the
flash forward) to their plain versions and times them at the Jacobi
shape, at moonshot's prefill call, at the training shape and at ring
attention's 8192-token prefill call; it runs k = 16 at the Jacobi
shape as two chained k-sweep launches (f32 error 0) and times it per
sweep beside k = 8.  The stencil kernels are timed
beside one cuDNN conv2d that computes a sweep, and k chained ones (TF32
off, cudnn.benchmark on, graph-replayed).  The grouped FFN is held on
both engines (SIMT in f32 at 1e-5 and bf16 at 2e-2 where D or F is no
multiple of 64; the tensor cores in bf16 at 2e-2, with their f32 result
before rounding within 1e-4 of the plain f32 product and their bf16
output equal to it rounded on 99% of the elements); at moonshot's
prefill call it prints the plan (engine, tiles, CTAs, live tiles) and
times the kernel in turns with a three-bmm yardstick while nvidia-smi
reads the clocks.  Its backward is held the same way (every activation,
one and two groups an expert, valid counts of 0, part and all of a
group; dh exactly 0 past valid, an empty expert's weight gradients
exactly 0; on the tensor cores every gradient equal to the plain f32 one
rounded on 99% of its elements), and at moonshot's training call (C =
240) it is timed in turns with torch autograd through three bf16 bmm.

Every contiguous Generator of the phases (3, 6, 8, the ring generation of
9, 13 and 17 (d)) must decode as CUDA graph replays of its
``DecodeStep`` (``check_decode_graph``); the contiguous decode launches
no hand-written kernel.

The lines before the last hold one JSON object of kernel measurements and
the card's name and power limit as nvidia-smi reports them; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the rest of the repository beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
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
#: the flash kernels on the tensor cores (bf16): each must have HGMMA
#: instructions in its SASS and neither stack nor local memory
FLASH_WGMMA = ([f"flash_fwd_wgmma_kernel<{hd}, {c}>" for hd in (64, 128)
                for c in ("false", "true")]
               + [f"flash_fwd_wgmma_skip_kernel<192, {c}>"
                  for c in ("false", "true")]
               + [f"flash_bwd_wgmma_kernel<{hd}, {c}>" for hd in (64, 128)
                  for c in ("false", "true")]
               + [f"flash_bwd_wgmma_pair_kernel<192, {c}>"
                  for c in ("false", "true")])
#: the grouped FFN's tensor-core backward kernels (step 1 by activation,
#: step 2 gated or not, step 3's [dw1 | dw1g] gated or not and dw2)
GROUPED_BWD_WGMMA = (["ffn_bwd_dact_wgmma_kernel<float>"]
                     + [f"ffn_bwd_act_wgmma_kernel<{a}, {g}>" for a, g in (
    (0, "true"), (1, "true"), (2, "false"), (3, "false"))]
    + [f"ffn_bwd_dh_wgmma_kernel<{g}>" for g in ("true", "false")]
    + [f"ffn_bwd_dw_wgmma_kernel<{k}>" for k in ("0, true", "0, false",
                                                 "1, false")])
PEAK = {"bfloat16": 989e12,           # dense tensor-core rate, flop/s
        "float32": 67e12}             # f32 outside the tensor cores
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: the plain versions that no card path may reach: (module under
#: repro_torch.kernels, function)
PLAIN_VERSIONS = (("grouped_matmul", "grouped_expert_ffn_torch"),
                  ("grouped_matmul", "grouped_expert_ffn_bwd_torch"),
                  ("paged_attention", "paged_attention_partials_torch"),
                  ("paged_attention", "split_partials_torch"))


class plain_spy:
    """Within the block, each call of a function of PLAIN_VERSIONS that is
    handed a CUDA tensor is counted in ``hits`` by name, and goes on as
    before: a card path that reaches a plain version shows there."""

    def __enter__(self):
        import importlib

        import torch

        self.hits, self.saved = {}, []
        for mod, name in PLAIN_VERSIONS:
            module = importlib.import_module(f"repro_torch.kernels.{mod}")
            real = getattr(module, name)

            def spy(*args, _real=real, _name=name, **kw):
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in (*args, *kw.values())):
                    self.hits[_name] = self.hits.get(_name, 0) + 1
                return _real(*args, **kw)

            setattr(module, name, spy)
            self.saved.append((module, name, real))
        return self

    def __exit__(self, *exc):
        for module, name, real in self.saved:
            setattr(module, name, real)
        return False

    def check(self, what: str) -> None:
        if self.hits:
            fail(f"{what}: a plain version was handed CUDA tensors on the "
                 f"card path: {self.hits}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str, kernel: str) -> str | None:
    """``kernel<template arguments>`` of a mangled name whose kernel
    matches the regex ``kernel``, or None."""
    import re

    found = re.search(rf"({kernel})I(.*?)E(?:Ev|EE)", mangled)
    if not found:
        return None
    args = re.sub(r"^f", "float, ", found.group(2) + "E")
    args = re.sub(r"Li(\d+)E", r"\1, ", args)
    args = re.sub(r"Lb([01])E", lambda b: ("false", "true")[
        int(b.group(1))] + ", ", args)
    args = args.replace("13__nv_bfloat16", "bf16, ")
    return f"{found.group(1)}<{args.rstrip(', E')}>"


def cuobjdump(build, source: str, flag: str) -> str:
    """``cuobjdump <flag>`` of the built library of csrc/<source>.cu."""
    from pathlib import Path

    tool = Path(build._nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), flag, str(build._target(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def hgmma_counts(build, source: str, kernel: str) -> dict[str, int]:
    """HGMMA instructions in each kernel of csrc/<source>.cu whose name
    matches ``kernel``, from ``cuobjdump -sass``, by kernel (template
    arguments spelled out)."""
    counts: dict[str, int] = {}
    name = None
    for line in cuobjdump(build, source, "-sass").splitlines():
        if "Function :" in line:
            name = kernel_name(line, kernel)
            if name:
                counts[name] = 0
        elif name and "HGMMA" in line:
            counts[name] += 1
    return counts


def res_usage(build, source: str, kernel: str) -> dict[str, dict[str, int]]:
    """Registers, stack and local memory (bytes per thread) of each kernel
    of csrc/<source>.cu whose name matches ``kernel``, read with
    ``cuobjdump -res-usage`` from the built library (a spill would show as
    stack or local memory)."""
    import re

    usage: dict[str, dict[str, int]] = {}
    name = None
    for line in cuobjdump(build, source, "-res-usage").splitlines():
        found = re.search(r"Function (\S+?):", line)
        if found:
            plain = re.search(kernel, found.group(1))
            name = kernel_name(found.group(1), kernel) or (
                plain.group(0) if plain else None)
        if name and "REG:" in line:
            usage[name] = {key.lower(): int(n) for key, n in re.findall(
                r"\b(REG|STACK|LOCAL):(\d+)", line)}
            name = None
    return usage


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
    return graph_timer(torch, fns)(reps)


def graph_timer(torch, fns):
    """The calls in ``fns`` captured once in a CUDA graph; returns a
    function that replays it ``reps`` times between CUDA events and gives
    the device milliseconds per call (graph_ms's protocol, repeatable)."""
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

    def replay_ms(reps: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * len(fns))
    return replay_ms


def with_clocks(run):
    """``run()`` while another thread reads the card's SM clock (MHz),
    power draw (W) and temperature (C) with nvidia-smi, one call at a time
    until ``run`` returns; returns (its result, [(time.perf_counter() at
    the read, MHz, W, C), ...])."""
    import threading

    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                     "temperature.gpu", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=60)
            except (OSError, subprocess.SubprocessError):
                return
            try:
                samples.append((time.perf_counter(), *(
                    float(x) for x in out.stdout.splitlines()[0].split(","))))
            except (IndexError, ValueError):
                pass
            done.wait(0.05)

    reader = threading.Thread(target=sample)
    reader.start()
    try:
        result = run()
    finally:
        done.set()
        reader.join()
    return result, samples


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


#: bytes of K/V chains the timed paged calls cycle through: twice the
#: H100's 50 MB L2, so each call reads from HBM
COLD_BYTES = 100_000_000


def roof_ms(flops, nbytes, dtype_name):
    """Least time of a call's work: its bytes over HBM against its flops
    over the peak of the inputs' type.  Returns (ms, 'bytes'|'operations')."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / PEAK[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_bound(lens, window, h, kvh, hd, page, dtype_name, itemsize):
    """Least time for one call over ``lens``: the kernel module's work
    (``paged_work``: the attended K/V, q and out, lens and table) over the
    card's rates.  Returns (ms, 'bytes'|'operations')."""
    from repro_torch.kernels import paged_attention as paged

    return roof_ms(*paged.paged_work(lens, window, h, kvh, hd, page,
                                     itemsize), dtype_name)


def paged_split_err(torch, paged, q, kp, vp, table, lens, window):
    """The fast path's f32 split partials (m, l, acc from the card's
    workspace) against the plain ones in f32 on the same bf16 inputs: the
    worst error relative to their size (acc: to the largest |acc| of its
    split).  It shows that P stays f32 in P.V, which the bf16 output
    cannot: P in bf16 moves acc by about 1e-3 of its size."""
    plan, (m, l, acc) = paged.split_partials(q, kp, vp, table, lens,
                                             window=window)
    m_r, l_r, acc_r = paged.split_partials_torch(
        q.float(), kp.float(), vp.float(), table, lens,
        plan.pages_per_split, window=window)
    if not torch.equal(l > 0, l_r > 0):
        return float("inf")
    size = acc_r.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)
    return max(((l - l_r).abs() / l_r.clamp_min(1e-30)).max().item(),
               ((m - m_r).abs() / m_r.abs().clamp_min(1.0)).max().item(),
               ((acc - acc_r).abs() / size).max().item())


def phase_kernel(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as paged

    rng = np.random.default_rng(SEED)
    page, hd = 16, 128
    ragged = [0, 1, 16, 17, 32, 100, 255, 288]        # 0, 1, page edges
    errs = {}
    # (H, KV, window, hd): phi4-mini's GQA, a window, granite's MQA,
    # moonshot, nemotron's 96/8 heads of 192
    cases = [(32, 8, 0, 128), (32, 8, 64, 128), (48, 1, 0, 128),
             (16, 16, 0, 128), (96, 8, 0, 192)]
    for dtype, tol in ((torch.float32, dict(atol=1e-4, rtol=0.0)),
                       (torch.bfloat16, dict(atol=2e-2, rtol=2e-2))):
        for h, kvh, window, case_hd in cases:
            q, kp, vp, table, lens = paged_inputs(
                torch, rng, b=8, h=h, kvh=kvh, hd=case_hd, page=page,
                lens=ragged, n_pages=160, dtype=dtype)
            plan = paged.launch_plan(q, kp, table)
            got = paged.paged_attention(q, kp, vp, table, lens,
                                        window=window)
            torch.cuda.synchronize()
            want = paged.paged_attention_torch(
                q.float(), kp.float(), vp.float(), table, lens,
                window=window)
            err = (got.float() - want).abs().max().item()
            name = (f"{str(dtype)[6:]} H={h} KV={kvh} window={window} hd "
                    f"{case_hd}")
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
            print(f"  kernel vs plain {name} ({plan.engine}, "
                  f"{plan.n_splits} splits of {plan.pages_per_split} "
                  f"pages): max|err| {err:.3e} (atol {tol['atol']}, rtol "
                  f"{tol['rtol']})", flush=True)
            if plan.engine == "mma" and plan.n_splits > 1:
                split_err = paged_split_err(torch, paged, q, kp, vp, table,
                                            lens, window)
                if not split_err <= 1e-4:
                    fail(f"the fast path's f32 split partials are off by "
                         f"{split_err:.3e} of their size ({name}): P is "
                         f"not f32 in P.V")
                print(f"    f32 split partials vs plain in f32: "
                      f"{split_err:.3e} of their size (limit 1e-4)",
                      flush=True)

    def measure(label, *, h, kvh, b, lens, reps, plain_reps):
        # copies of the pools whose chains together exceed twice the 50 MB
        # L2, so that each call reads its K/V from HBM as consecutive
        # layers do; each pool holds the chains and one spare page
        touched = sum(lens) * kvh * hd * 2 * 2
        copies = max(1, -(-COLD_BYTES // touched))
        n_pages = sum(-(-n // page) for n in lens) + 1
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
        plain = [lambda s=s: paged.paged_attention_torch(*s)
                 for s in sets[:2]]
        lib = [lambda i=i: sdpa(i) for i in range(copies)]
        plan = paged.launch_plan(*sets[0][:2], sets[0][3])
        ms = graph_ms(torch, kernel, reps)
        call_ms = eager_ms(torch, kernel, reps)
        plain_ms = graph_ms(torch, plain, plain_reps)
        lib_ms = graph_ms(torch, lib, reps)
        bound_ms, bound_by = paged_bound(lens, 0, h, kvh, hd, page,
                                         "bfloat16", 2)
        print(f"  paged_attention {label}: kernel {ms:.4f} ms on the "
              f"device ({plan.engine} engine, {plan.n_splits} splits of "
              f"{plan.pages_per_split} pages, {plan.ctas} CTAs, {copies} "
              f"pool copies; "
              f"{call_ms:.4f} ms per call issued from Python), bound "
              f"{bound_ms:.4f} ms ({bound_by}; the kernel reaches "
              f"{bound_ms / ms * 100:.1f}% of it), plain {plain_ms:.4f} ms, "
              f"library yardstick F.scaled_dot_product_attention on "
              f"pre-gathered K/V {lib_ms:.4f} ms", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms)

    # the serving phase's shape: 8 slots, phi4-mini's heads, 16-token
    # pages, chains of 64..288 positions
    serve_lens = [int(x) for x in rng.integers(64, 289, size=8)]
    main = measure("serve shape (B=8, 32/8 heads, bf16, lens 64-288)",
                   h=32, kvh=8, b=8, lens=serve_lens, reps=10, plain_reps=5)
    long_lens = [int(x) for x in rng.integers(2048, 8193, size=32)]
    measure("long context (B=32, 32/8 heads, bf16, lens 2048-8192)", h=32,
            kvh=8, b=32, lens=long_lens, reps=20, plain_reps=2)
    # granite-34b's MQA and moonshot's G=1 at the serving lens
    measure("granite MQA (B=8, 48/1 heads, bf16, lens 64-288)", h=48,
            kvh=1, b=8, lens=serve_lens, reps=10, plain_reps=5)
    measure("moonshot G=1 (B=8, 16/16 heads, bf16, lens 64-288)", h=16,
            kvh=16, b=8, lens=serve_lens, reps=10, plain_reps=5)
    bf16_err = max(v for k, v in errs.items() if k.startswith("bfloat16"))
    return main, bf16_err


def partials_err(torch, got, want):
    """Flash partials (m, l, acc) [B, 1, H(, hd)] against the plain ones:
    the worst error relative to their size (acc: to the largest |acc| of
    its row); inf where the two disagree on which rows attend nothing."""
    (m, l, acc), (m_r, l_r, acc_r) = got, want
    live = l_r > 0
    if not torch.equal(l > 0, live) or not torch.equal(
            m[~live], m_r[~live]) or bool((acc[~live] != 0).any()):
        return float("inf")
    size = acc_r.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)
    dm = (m - m_r)[live].abs() / m_r[live].abs().clamp_min(1.0)
    return max(((l - l_r).abs() / l_r.clamp_min(1e-30)).max().item(),
               dm.max().item() if dm.numel() else 0.0,
               ((acc - acc_r).abs() / size).max().item())


#: (H, KV, window, hd) of the partials checks: phi4-mini's GQA, a window,
#: moonshot's G=1, nemotron's 96/8 heads of 192
PARTIALS_CASES = [(32, 8, 0, 128), (32, 8, 64, 128), (16, 16, 0, 128),
                  (96, 8, 0, 192)]
#: the partials entry against the plain partials in f32 on the same
#: inputs, relative to their size (partials_err)
PARTIALS_TOL = 1e-4


def phase_paged_partials(torch):
    """Phase 2: the paged kernel's partials over a pool cut in two halves
    (each a rank's pool with its offset; the chains cross the cut),
    against the plain partials in both engines, merged against the plain
    unsharded output; then its time at the serving shape.  Returns the
    timing and the worst max|err| of the merged output."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as paged

    rng = np.random.default_rng(SEED + 21)
    ragged = [0, 1, 16, 17, 32, 100, 255, 288]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for h, kvh, window, hd in PARTIALS_CASES:
            q, kp, vp, table, lens = paged_inputs(
                torch, rng, b=8, h=h, kvh=kvh, hd=hd, page=16, lens=ragged,
                n_pages=160, dtype=dtype)
            half = kp.shape[0] // 2
            name = (f"{str(dtype)[6:]} H={h} KV={kvh} window={window} hd "
                    f"{hd}")
            parts, errs = [], []
            for off in (0, half):
                local = (q, kp[off:off + half], vp[off:off + half], table,
                         lens)
                plan = paged.launch_plan(q, local[1], table)
                before = paged.LAUNCHES
                got = paged.paged_attention_partials(
                    *local, window=window, pool_offset=off)
                torch.cuda.synchronize()
                if paged.LAUNCHES != before + 1:
                    fail(f"paged partials {name}: not one launch")
                want = paged.paged_attention_partials_torch(
                    q.float(), local[1].float(), local[2].float(), table,
                    lens, window=window, pool_offset=off)
                errs.append(partials_err(torch, got, want))
                parts.append(got)
            out, _ = fa.finalize_partials(*fa.merge_partials(*parts))
            full = paged.paged_attention_torch(
                q.float(), kp.float(), vp.float(), table, lens,
                window=window)
            merged = (out[:, 0] - full).abs().max().item()
            if not max(errs) <= PARTIALS_TOL or not merged <= PARTIALS_TOL:
                fail(f"paged partials {name}: off the plain partials by "
                     f"{max(errs):.3e} of their size, merged off the plain "
                     f"output by {merged:.3e} (limit {PARTIALS_TOL})")
            worst = max(worst, merged)
            print(f"  paged_attention_partials vs plain {name} over two "
                  f"pool halves of {half} pages (offsets 0, {half}; "
                  f"{plan.engine}, {plan.n_splits} splits): off by "
                  f"{max(errs):.3e} of their size, the two merged off the "
                  f"unsharded plain output by {merged:.3e} (limit "
                  f"{PARTIALS_TOL})", flush=True)

    # its time at the serving shape, on one half of the pool
    lens = [int(x) for x in rng.integers(64, 289, size=8)]
    n_pages = sum(-(-n // 16) for n in lens) + 2
    q, kp, vp, table, lns = paged_inputs(
        torch, rng, b=8, h=32, kvh=8, hd=128, page=16, lens=lens,
        n_pages=n_pages, dtype=torch.bfloat16)
    half = n_pages // 2
    local = (q, kp[half:], vp[half:], table, lns)
    kernel = [lambda: paged.paged_attention_partials(*local,
                                                     pool_offset=half)]
    plain = [lambda: paged.paged_attention_partials_torch(
        *local, pool_offset=half)]
    need = paged.local_positions(table, lns, 16, kp.shape[0] - half, half)
    tm = dict(ms=graph_ms(torch, kernel, 20), plain_ms=graph_ms(torch, plain,
                                                                 5),
              library_ms=None)
    tm["bound_ms"], tm["bound_by"] = paged_bound(need, 0, 32, 8, 128, 16,
                                                 "bfloat16", 2)
    plan = paged.launch_plan(q, local[1], table)
    print(f"  paged_attention_partials at the serving shape (B=8, 32/8 "
          f"heads, bf16, lens 64-288, the second of two pool halves: "
          f"{sum(need)} of {sum(lens)} positions local; {plan.engine}, "
          f"{plan.n_splits} splits): kernel {tm['ms']:.4f} ms, bound "
          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}), plain "
          f"{tm['plain_ms']:.4f} ms; no single library call gives the "
          f"partials", flush=True)
    return tm, worst


# ---------------------------------------------------------------------------
# phase 2: the flash kernels (forward, backward, carry step, block
# backward) at head_dim 128 and 192, kernel vs plain, and their times
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, KV, causal, window, q_offset), head_dim 128: the
#: training shape (phi4-mini, B=2, S=1024, 32/8, causal); GQA 32/8 and
#: MQA 48/1 (granite-34b's heads), causal and not, windows 0 and 64,
#: q_offset > 0 with Sq < Skv, and Sq, Skv that are not multiples of 64;
#: then the edges of the bf16 kernel's 128-row tiles (127, 129, 257, a
#: window of 100, the diagonal mid-tile)
FLASH_CASES = [
    (2, 1024, 1024, 32, 8, True, 0, 0),
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
#: the same at head_dim 192: nemotron's call (1 x 4096, 96/8 heads,
#: causal), phase 17 (e)'s training call (2 x 2048, 4/2 heads, causal),
#: then GQA 12:1 with a window, MHA not causal with a ragged Skv, and
#: q_offset with Sq < Skv; then edges of the backward's clusters of two
#: 64-row kv tiles: three kv tiles (the second cluster's upper CTA has no
#: rows) at G = 12, and a window under a tile with q_offset > 0; then
#: edges of the forward (2 stages of 64 kv rows): one kv tile a CTA (the
#: carry over the second half sees none: every row copied through), and
#: 11 tiles that wrap the ring
FLASH192_CASES = [
    (1, 4096, 4096, 96, 8, True, 0, 0),
    (2, 2048, 2048, 4, 2, True, 0, 0),
    (1, 257, 257, 24, 2, True, 100, 0),
    (1, 200, 333, 8, 8, False, 0, 0),
    (2, 129, 300, 24, 2, True, 0, 171),
    (1, 192, 192, 12, 1, True, 0, 0),
    (2, 129, 320, 24, 2, True, 20, 191),
    (1, 64, 512, 12, 1, True, 0, 0),
    (1, 704, 704, 8, 2, True, 0, 0),
]
#: the training phase's attention: phi4-mini at B=2, S=1024, causal
TRAIN_ATTN = dict(b=2, s=1024, h=32, kvh=8, hd=128)
#: nemotron's attention call: one 4096-token sequence, 96/8 heads, hd 192
NEMO_ATTN = dict(b=1, s=4096, h=96, kvh=8, hd=192)
#: phase 2's flash cases and timed call, by head dim
FLASH_PHASES = {128: (FLASH_CASES, TRAIN_ATTN, "the training shape"),
                192: (FLASH192_CASES, NEMO_ATTN, "nemotron's call")}
#: the block backward's f32 outputs against the plain version in f32, of
#: the largest magnitude of each: P and dS are kept as bf16 hi/lo pairs
BLOCK_TOL = 1e-4
#: bf16 out, dq, dk and dv: ||got - want|| / ||want|| over the tensor.
#: The max-abs check scales by the largest magnitude, which in a long
#: causal call comes from the first rows and exceeds most values; the
#: norm weighs every row.  On an H100 every case read 1.58e-3 to 1.67e-3
#: at hd 128 and 192 (the outputs' rounding to bf16), and a dropped 64-row
#: kv tile or a wrong l 0.27 to 0.39 (``norm_controls``, which must read
#: above this limit)
FLASH_NORM_TOL = 5e-3


def flash_bounds(b, s, h, kvh, hd, itemsize):
    """Least times at the training shape (causal): the kernel module's
    work (``flash_work``: the forward's QK^T and PV over the unmasked
    pairs; the backward's recomputed QK^T, dP, dV, dK and dQ; each input
    read once, each output written once) at the bf16 tensor-core rate.
    Returns {"fwd"|"bwd": (ms, 'bytes'|'operations')}."""
    from repro_torch.kernels import flash_attention as fa

    return {name: roof_ms(*fa.flash_work(name, b, s, s, h, kvh, hd,
                                         itemsize, causal=True), "bfloat16")
            for name in ("fwd", "bwd")}


def block_bwd_bound(b, s, h, kvh, hd, itemsize):
    """Least time of ring attention's block backward over [B, S] with an
    S-long causal block: ``flash_work("bwd_block")`` (10 flop per (pair,
    hd); q, dout, k, v, lse and dsum read once, the f32 dq, dk, dv written
    once) at the bf16 tensor-core rate.  Returns (ms, 'bytes'|'operations')."""
    from repro_torch.kernels import flash_attention as fa

    return roof_ms(*fa.flash_work("bwd_block", b, s, s, h, kvh, hd, itemsize,
                                  causal=True), "bfloat16")


def flash_inputs(torch, gen, b, sq, skv, h, kvh, hd, dtype):
    dev = torch.device("cuda")
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, sq, h, hd), (b, skv, kvh, hd),
                          (b, skv, kvh, hd), (b, sq, h, hd))]


def rel_check(torch, got, want, tol, what, floor=1.0):
    """max|got - want| within ``tol`` x max(floor, max|want|) (finite,
    f32); returns the error."""
    if not torch.isfinite(got.float()).all():
        fail(f"{what}: not finite")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(floor, want.float().abs().max().item())
    if not err <= tol * scale:
        fail(f"{what}: max|err| {err:.3e} > {tol} x {scale:.3g}")
    return err


def norm_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor, in f32."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def flash_checks(torch, gen, hd, cases) -> dict:
    """Forward, backward, carry step and block backward at ``hd`` against
    their plain versions in f32 and bf16 on every case, with exact launch
    counts; bf16 out, dq, dk and dv also by norm.  Returns the worst bf16
    error of each kernel and the worst bf16 norm error ("norm")."""
    from repro_torch.kernels import flash_attention as fa

    worst = dict.fromkeys(("fwd", "bwd", "carry", "bwd_block", "norm"), 0.0)
    for b, sq, skv, h, kvh, causal, window, q_off in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            dname = str(dtype)[6:]
            bf16 = dtype == torch.bfloat16
            q, k, v, dout = flash_inputs(torch, gen, b, sq, skv, h, kvh, hd,
                                         dtype)
            kw = dict(causal=causal, window=window, q_offset=q_off)
            name = (f"hd {hd} {dname} B={b} Sq={sq} Skv={skv} H={h} "
                    f"KV={kvh} causal={causal} window={window} "
                    f"q_offset={q_off}")
            c0 = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.CARRY_LAUNCHES,
                  fa.BWD_BLOCK_LAUNCHES)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            # the carry step from a carried state (the plain step over the
            # first half of the keys) over the second half, at k_offset
            half = skv // 2
            carry = fa.flash_attention_step_torch(
                q.float(), k[:, :half].float(), v[:, :half].float(),
                *fa.init_partials(b, sq, h, hd, device="cuda"), **kw)
            k2, v2 = k[:, half:].contiguous(), v[:, half:].contiguous()
            got_c = fa.flash_attention_carry(q, k2, v2, *carry, **kw,
                                             k_offset=half)
            dsum = (dout.float() * out.float()).sum(-1)
            got_b = fa.flash_attention_bwd_block(q, k, v, dout, lse, dsum,
                                                 **kw)
            torch.cuda.synchronize()
            c1 = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.CARRY_LAUNCHES,
                  fa.BWD_BLOCK_LAUNCHES)
            if tuple(y - x for x, y in zip(c0, c1)) != (1, 1, 1, 1):
                fail(f"flash launches {c0} -> {c1} at {name}, not one each")
            line, norms = [], []

            def held(what, got, want, key):
                err = rel_check(torch, got, want, tol, f"{what} {name}")
                line.append(f"{what} {err:.2e}")
                if bf16:
                    worst[key] = max(worst[key], err)
                    nerr = norm_err(got, want)
                    norms.append(f"{what} {nerr:.2e}")
                    worst["norm"] = max(worst["norm"], nerr)
                    if not nerr <= FLASH_NORM_TOL:
                        fail(f"{what} {name}: ||err|| / ||want|| {nerr:.3e} "
                             f"> {FLASH_NORM_TOL}")

            want_out, want_lse = fa.flash_attention_torch(
                q.float(), k.float(), v.float(), **kw)
            held("out", out, want_out, "fwd")
            line.append("lse "
                        f"{rel_check(torch, lse, want_lse, 1e-4, name):.2e}")
            del want_out, want_lse
            wants = fa.flash_attention_bwd_torch(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **kw)
            for what, g, w in zip(("dq", "dk", "dv"), grads, wants):
                held(what, g, w, "bwd")
            del wants, grads
            want_c = fa.flash_attention_step_torch(
                q.float(), k2.float(), v2.float(), *carry, **kw,
                k_offset=half)
            err = carry_check(torch, got_c, want_c, CARRY_TOL[dname],
                              f"carry {name}")
            line.append(f"carry {err:.2e}")
            if bf16:
                worst["carry"] = max(worst["carry"], err)
            del want_c, got_c, carry
            want_b = fa.flash_attention_bwd_block_torch(
                q.float(), k.float(), v.float(), dout.float(), lse, dsum,
                **kw)
            for what, g, w in zip(("dq", "dk", "dv"), got_b, want_b):
                if g.dtype != torch.float32:
                    fail(f"block backward {what} is {g.dtype} at {name}")
                err = rel_check(torch, g, w, BLOCK_TOL,
                                f"block {what} {name}", floor=1e-30)
                line.append(f"block {what} {err:.2e}")
                if bf16:
                    worst["bwd_block"] = max(worst["bwd_block"], err)
            del want_b, got_b
            torch.cuda.empty_cache()
            norm_txt = (f"; ||err|| / ||want|| {', '.join(norms)} (limit "
                        f"{FLASH_NORM_TOL})" if bf16 else "")
            print(f"  flash kernels vs plain at {name}: max|err| "
                  f"{', '.join(line)} (tolerance {tol} x max(1, max|want|); "
                  f"lse 1e-4; carry {CARRY_TOL[dname]} and block "
                  f"{BLOCK_TOL} of the largest magnitude){norm_txt}; one "
                  f"launch each", flush=True)
    return worst


def norm_controls(torch, gen, shape, label) -> None:
    """The norm check's power at the timed call, from the plain versions
    in f32: the output with one 64-row kv tile (keys 64-127) left out, the
    output with that tile left out of l only, the gradients from that
    wrong l, and dK/dV with that tile's rows never written must each read
    above FLASH_NORM_TOL against the right answer."""
    from repro_torch.kernels import flash_attention as fa

    b, s, h, kvh, hd = (shape[x] for x in ("b", "s", "h", "kvh", "hd"))
    q, k, v, dout = flash_inputs(torch, gen, b, s, s, h, kvh, hd,
                                 torch.float32)
    empty = fa.init_partials(b, s, h, hd, device="cuda")
    m, l, acc = fa.flash_attention_step_torch(q, k, v, *empty)
    out, lse = fa.finalize_partials(m, l, acc)
    part = fa.flash_attention_step_torch(q, k[:, :64], v[:, :64], *empty)
    m_d, l_d, acc_d = fa.flash_attention_step_torch(
        q, k[:, 128:], v[:, 128:], *part, k_offset=128)
    del part
    l_w = l_d * torch.exp(m_d - m)
    out_w, lse_w = fa.finalize_partials(m, l_w, acc)
    reads = {"dropped tile: out": norm_err(
        fa.finalize_partials(m_d, l_d, acc_d)[0], out),
        "wrong l: out": norm_err(out_w, out)}
    del m_d, l_d, acc_d, acc, l_w
    grads = fa.flash_attention_bwd_torch(q, k, v, out, lse, dout)
    bad = fa.flash_attention_bwd_torch(q, k, v, out_w, lse_w, dout)
    for what, g, w in zip(("dq", "dk", "dv"), bad, grads):
        reads[f"wrong l: {what}"] = norm_err(g, w)
    del bad
    for what, w in zip(("dk", "dv"), grads[1:]):
        g = w.clone()
        g[:, 64:128] = 0
        reads[f"dropped tile: {what}"] = norm_err(g, w)
    del grads, q, k, v, dout, out, lse, out_w, lse_w
    torch.cuda.empty_cache()
    print(f"  norm check's controls at {label} (B={b}, S={s}, {h}/{kvh} "
          f"heads, hd {hd}, causal, plain versions in f32): ||err|| / "
          f"||want|| " + ", ".join(f"{k_} {e:.3e}" for k_, e in reads.items())
          + f" (each must exceed the limit {FLASH_NORM_TOL})", flush=True)
    low = {k_: e for k_, e in reads.items() if not e > FLASH_NORM_TOL}
    if low:
        fail(f"the flash norm check at {label} would pass broken kernels: "
             f"{low}")


def flash_times(torch, gen, shape, label, worst) -> dict:
    """The four flash kernels timed at ``shape`` (bf16, causal) beside
    their bounds, their plain versions and SDPA (forward; backward as
    autograd.grad of the call in a CUDA graph less the forward's graph
    time).  Returns {kernel: times}."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, s, h, kvh, hd = (shape[x] for x in ("b", "s", "h", "kvh", "hd"))
    # two input sets, so that consecutive calls do not find their inputs
    # in the 50 MB L2
    sets = [flash_inputs(torch, gen, b, s, s, h, kvh, hd, torch.bfloat16)
            for _ in range(2)]
    fwd_res = [fa.flash_attention_fwd(*st[:3]) for st in sets]
    blk_in = [(*st[:3], st[3], r[1], (st[3].float() * r[0].float()).sum(-1))
              for st, r in zip(sets, fwd_res)]
    carry_in = [(*st[:3], *fa.init_partials(b, s, h, hd, device="cuda"))
                for st in sets]
    lib_in = [[x.transpose(1, 2).contiguous() for x in st] for st in sets]
    leaves = [[x.detach().requires_grad_() for x in st[:3]] for st in lib_in]
    sdpa = [lambda st=st: F.scaled_dot_product_attention(
        *st[:3], is_causal=True, enable_gqa=True) for st in lib_in]
    sdpa_fwd_bwd = [lambda st=st, lv=lv: torch.autograd.grad(
        F.scaled_dot_product_attention(*lv, is_causal=True, enable_gqa=True),
        lv, st[3]) for st, lv in zip(lib_in, leaves)]
    sdpa_ms = graph_ms(torch, sdpa * 4, 5)
    sdpa_bwd_ms = graph_ms(torch, sdpa_fwd_bwd * 2, 5) - sdpa_ms
    bounds = flash_bounds(b, s, h, kvh, hd, 2)
    bounds["carry"] = carry_bounds(b, s, h, kvh, hd, 2)
    bounds["bwd_block"] = block_bwd_bound(b, s, h, kvh, hd, 2)
    calls = {
        "fwd": ([lambda st=st: fa.flash_attention_fwd(*st[:3])
                 for st in sets] * 4,
                [lambda st=st: fa.flash_attention_torch(*st[:3])
                 for st in sets], sdpa_ms),
        "bwd": ([lambda st=st, r=r: fa.flash_attention_bwd(*st[:3], *r,
                                                           st[3])
                 for st, r in zip(sets, fwd_res)] * 2,
                [lambda st=st, r=r: fa.flash_attention_bwd_torch(
                    *st[:3], *r, st[3]) for st, r in zip(sets, fwd_res)],
                sdpa_bwd_ms),
        "carry": ([lambda a=a: fa.flash_attention_carry(*a, causal=True)
                   for a in carry_in] * 4,
                  [lambda a=a: fa.flash_attention_step_torch(*a,
                                                            causal=True)
                   for a in carry_in], sdpa_ms),
        "bwd_block": ([lambda a=a: fa.flash_attention_bwd_block(
                           *a, causal=True) for a in blk_in] * 2,
                      [lambda a=a: fa.flash_attention_bwd_block_torch(
                          *a, causal=True) for a in blk_in], sdpa_bwd_ms),
    }
    pairs = b * h * s * (s + 1) // 2
    times = {}
    for kind, (kernel, plain, lib_ms) in calls.items():
        tm = dict(ms=graph_ms(torch, kernel, 5),
                  plain_ms=graph_ms(torch, plain, 2), library_ms=lib_ms)
        tm["bound_ms"], tm["bound_by"] = bounds[kind]
        per_pair = 4 if kind in ("fwd", "carry") else 10
        tflops = per_pair * pairs * hd / (tm["ms"] * 1e-3) / 1e12
        times[kind] = tm
        print(f"  flash {kind} at {label} (B={b}, S={s}, {h}/{kvh} heads, "
              f"hd {hd}, causal, bf16): kernel {tm['ms']:.4f} ms "
              f"({tflops:.1f} TFLOP/s over the unmasked pairs), bound "
              f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}; the kernel "
              f"reaches {tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
              f"{tm['plain_ms']:.4f} ms, library yardstick "
              f"F.scaled_dot_product_attention(is_causal=True, "
              f"enable_gqa=True) "
              f"{'forward' if kind in ('fwd', 'carry') else 'backward'} "
              f"{lib_ms:.4f} ms; worst bf16 error at hd {hd} "
              f"{worst[kind]:.2e}", flush=True)
    del sets, fwd_res, blk_in, carry_in, lib_in, leaves
    torch.cuda.empty_cache()
    return times


def bwd192_geometry(torch) -> None:
    """The built hd-192 backward's geometry against ``bwd192_plan`` at
    nemotron's call: kv rows a CTA, CTAs a cluster, shared memory, threads
    and the L2 chunk must be the plan's; prints the launch order's chunks
    and the clusters the card keeps resident."""
    from repro_torch.kernels import flash_attention as fa

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    s = NEMO_ATTN
    plan = fa.bwd192_plan(s["b"], s["s"], s["s"], s["h"], s["kvh"], True,
                          n_sm=n_sm)
    built = fa.bwd192_built()
    print(f"  hd-192 backward at nemotron's call: plan {plan.kv_rows} kv "
          f"rows a CTA, clusters of {plan.cluster}, {plan.threads} threads, "
          f"{plan.smem} B of shared memory, {len(plan.clusters)} clusters "
          f"in chunks of {plan.chunk} heads (Q, dO and dQ within "
          f"{fa.BWD192_L2_CHUNK >> 20} MB), {plan.resident} resident on "
          f"{n_sm} SMs; built {built}", flush=True)
    got = (built["kv_rows"], built["cluster"], built["smem"],
           built["threads"], built["l2_chunk"])
    want = (plan.kv_rows, plan.cluster, plan.smem, plan.threads,
            fa.BWD192_L2_CHUNK)
    if got != want or not 1 <= built["resident"] <= plan.resident:
        fail(f"the built hd-192 backward {built} is not its plan {want} "
             f"(resident clusters at most {plan.resident})")


def fwd192_geometry(torch) -> None:
    """The built hd-192 forward's geometry against ``fwd192_plan`` at
    nemotron's call: query rows a CTA, kv rows a stage, stages, threads
    and shared memory must be the plan's, and an SM must keep one CTA."""
    from repro_torch.kernels import flash_attention as fa

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    s = NEMO_ATTN
    plan = fa.fwd192_plan(s["b"], s["s"], s["s"], s["h"], s["kvh"], True,
                          n_sm=n_sm)
    built = fa.fwd192_built()
    print(f"  hd-192 forward at nemotron's call: plan {plan.q_rows} query "
          f"rows a CTA, {plan.stages} stages of {plan.kv_rows} kv rows, "
          f"{plan.threads} threads, {plan.smem} B of shared memory, "
          f"{len(plan.units)} CTAs over "
          f"{sum(u.n_tiles for u in plan.units)} kv tiles, heaviest first; "
          f"built {built}", flush=True)
    got = tuple(built[k] for k in ("q_rows", "kv_rows", "stages",
                                   "threads", "smem"))
    want = (plan.q_rows, plan.kv_rows, plan.stages, plan.threads, plan.smem)
    if got != want or built["resident"] != 1:
        fail(f"the built hd-192 forward {built} is not its plan {want} "
             f"(one CTA an SM)")


def fwd192_edges(torch, gen) -> None:
    """The hd-192 carry step updated in place (the *_out pointers equal to
    the *_in ones), and the forward and carry where the logits rise along
    the keys (every alpha below 1) or peak in the first 8 (every alpha
    after a row's first tile exactly 1, so the rescale is skipped), held
    to their plain versions: the bf16 output by FLASH_NORM_TOL, the carry
    within CARRY_TOL."""
    import math

    from repro_torch.kernels import flash_attention as fa

    b, s, h, kvh, hd = 1, 704, 24, 2, 192
    q, k, v, _ = flash_inputs(torch, gen, b, s, s, h, kvh, hd,
                              torch.bfloat16)
    carry = fa.flash_attention_step_torch(
        q.float(), k[:, :64].float(), v[:, :64].float(),
        *fa.init_partials(b, s, h, hd, device="cuda"), causal=False)
    want = fa.flash_attention_step_torch(q.float(), k.float(), v.float(),
                                         *carry, causal=True, q_offset=640,
                                         k_offset=0)
    m, l, acc = (t.clone() for t in carry)
    lib = fa._lib()
    err = lib.flash_attention_carry_launch(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), b, s, s, h, kvh, hd, 640, 0, 0, 1,
        1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        fail(f"the in-place hd-192 carry launch returned {err}")
    err = carry_check(torch, (m, l, acc), want, CARRY_TOL["bfloat16"],
                      "hd-192 carry in place")
    reads = [f"carry in place {err:.2e}"]
    del q, k, v, carry, want, m, l, acc
    u = torch.ones(hd, device="cuda") / math.sqrt(hd)
    keys = torch.arange(s, device="cuda", dtype=torch.float32)
    for trend, lift in (("rising", 16.0 * keys / s),
                        ("first", 16.0 * (keys < 8).float())):
        noise = [0.1 * torch.randn(dims, generator=gen, device="cuda")
                 for dims in ((b, s, h, hd), (b, s, kvh, hd))]
        q = (16.0 * u + noise[0]).bfloat16()
        k = (lift[None, :, None, None] * u + noise[1]).bfloat16()
        v = torch.randn((b, s, kvh, hd), generator=gen,
                        device="cuda").bfloat16()
        out, _ = fa.flash_attention_fwd(q, k, v, causal=True)
        got = fa.flash_attention_carry(
            q, k, v, *fa.init_partials(b, s, h, hd, device="cuda"),
            causal=True)
        torch.cuda.synchronize()
        want_out, _ = fa.flash_attention_torch(q.float(), k.float(),
                                               v.float(), causal=True)
        nerr = norm_err(out, want_out)
        if not nerr <= FLASH_NORM_TOL:
            fail(f"hd-192 forward, logits {trend}: ||err|| / ||want|| "
                 f"{nerr:.3e} > {FLASH_NORM_TOL}")
        want = fa.flash_attention_step_torch(
            q.float(), k.float(), v.float(),
            *fa.init_partials(b, s, h, hd, device="cuda"), causal=True)
        cerr = carry_check(torch, got, want, CARRY_TOL["bfloat16"],
                           f"hd-192 carry, logits {trend}")
        reads.append(f"logits {trend}: out {nerr:.2e} by norm, carry "
                     f"{cerr:.2e}")
        del q, k, v, out, got, want, want_out, noise
    torch.cuda.empty_cache()
    print(f"  hd-192 forward and carry edges (1 x {s}, {h}/{kvh} heads, "
          f"causal, bf16) against plain: " + "; ".join(reads), flush=True)


def phase_flash(torch, hd):
    """The flash kernels at ``hd`` held to their plain versions on
    FLASH_PHASES' cases, the norm check's controls, then the times at its
    call (at hd 192 first the forward's and the backward's geometry
    against their plans, and after the cases the forward's edges).
    Returns ({kernel: times}, {kernel: worst bf16 error})."""
    cases, shape, label = FLASH_PHASES[hd]
    if hd == 192:
        fwd192_geometry(torch)
        bwd192_geometry(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + hd)
    worst = flash_checks(torch, gen, hd, cases)
    if hd == 192:
        fwd192_edges(torch, gen)
    norm_controls(torch, gen, shape, label)
    return flash_times(torch, gen, shape, label, worst), worst


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
#: the conv2d yardstick against the plain sweep: cuDNN sums the five terms
#: in its own order (or by a transform)
CONV_TOL = 1e-5
#: the k-sweep kernel's checks: the main path's width, an odd width over
#: three bands, rows over several strips with a ragged last one, m < k
KSWEEP_SHAPES = [(64, 130), (1000, 777), (5, 130), (40, 16386), (700, 2101),
                 (3001, 130)]
#: k of the k-sweep timings at the Jacobi shape (the kernels line takes the
#: last), turns of them while nvidia-smi reads the card, and graph replays
#: (of 4 launches) of each k per turn
KSWEEP_KS = (2, 4, 8)
KSWEEP_TURNS = 5
KSWEEP_TURN_REPS = 5


def stencil_bound(m, n, itemsize, sweeps, u_ghost=0, f_ghost=0):
    """Least time for one call that leaves ``sweeps`` sweeps on an [m, n]
    block: ``stencil_work`` (u with its ``u_ghost`` ghost rows and f with
    its ``f_ghost`` read once, u' written once; 5 f32 operations an
    interior update) over the card's rates.  Returns
    (ms, 'bytes'|'operations')."""
    from repro_torch.kernels import stencil as st

    return roof_ms(*st.stencil_work(m, n, itemsize, sweeps, u_ghost,
                                    f_ghost), "float32")


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
            for m, n in KSWEEP_SHAPES:
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
                    if dtype == torch.float32 and err != 0.0:
                        fail(f"jacobi_ksweep float32 {m}x{n} k={k} frozen="
                             f"({ft}, {fb}): max|err| {err:.3e}, not 0 (the "
                             f"kernel does the plain version's f32 "
                             f"operations in its order)")
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
            shapes = ", ".join(f"{m}x{n}" for m, n in KSWEEP_SHAPES)
            print(f"  jacobi_ksweep vs plain {dname} k={k} ({shapes}; "
                  f"frozen (0,0), (k,k), (k+1,k+1)"
                  f"{'; live-apron oracle' if dtype == torch.float32 else ''}"
                  f"): max|err| {max(line):.1e} (tolerance "
                  f"{'0 against the plain version, ' if dtype == torch.float32 else ''}"
                  f"{tol} x max(1, max|want|))", flush=True)

    # times at the Jacobi phase's shape, one rank: the bulk sweep (zero
    # halo rows) and the aggregated call at k = 2, 4, 8 (frozen zero ghost
    # rows); the kernels line takes k = 8
    n, k = JACOBI_N, KSWEEP_KS[-1]
    u, f = rand((n, n), torch.float32), rand((n, n), torch.float32)
    out = torch.empty_like(u)
    z1 = torch.zeros((1, n), device="cuda")
    zks = {kk: torch.zeros((kk, n), device="cuda") for kk in KSWEEP_KS}
    zk = zks[k]
    for kk in KSWEEP_KS:
        plan = st.ksweep_plan(n, n, kk, torch.float32)
        band, smem, resident = st.ksweep_built(kk)
        print(f"  jacobi_ksweep plan at {n}x{n} f32, k={kk}: band {plan.band}"
              f" columns (writes {plan.band - 2 * kk}) x {plan.bands} bands,"
              f" strips of {plan.strip} rows x {plan.strips}, {plan.ctas} "
              f"CTAs, {st.KSWEEP_CTAS} per SM; built: band {band}, {smem} bytes "
              f"of shared memory, {resident} CTAs resident per SM "
              f"(occupancy API)", flush=True)
        if (band, smem) != (plan.band, st.ksweep_smem_bytes(kk)) or \
                resident < st.KSWEEP_CTAS:
            fail(f"the built k-sweep kernel at k={kk} is not its plan's: "
                 f"{(band, smem, resident)} against {plan}")
    times = {
        "step": dict(
            ms=graph_ms(torch, [lambda: st.jacobi_step(
                u, f, lo=z1, hi=z1, out=out)] * 4, 5),
            plain_ms=graph_ms(torch, [lambda: st.jacobi_step(
                u, f, lo=z1, hi=z1, out=out, engine="torch")], 3),
            library_ms=None),
    }
    timers = {kk: graph_timer(torch, [lambda kk=kk: st.jacobi_ksweep_parts(
        zks[kk], u, zks[kk], zks[kk], f, zks[kk], kk, kk, kk, out=out)] * 4)
        for kk in KSWEEP_KS}

    def take_turns():
        return [{kk: timers[kk](KSWEEP_TURN_REPS) for kk in KSWEEP_KS}
                for _ in range(KSWEEP_TURNS)]

    turns, clocks = with_clocks(take_turns)
    del timers
    ksweep = {}
    for kk in KSWEEP_KS:
        got = sorted(turn[kk] for turn in turns)
        ksweep[kk] = dict(
            ms=got[len(got) // 2], spread=(got[0], got[-1]),
            plain_ms=graph_ms(torch, [lambda kk=kk: st.jacobi_ksweep_parts(
                zks[kk], u, zks[kk], zks[kk], f, zks[kk], kk, kk, kk,
                out=out, engine="torch")], 2),
            bound=stencil_bound(n, n, 4, kk, 2 * kk, 2 * kk))
        torch.cuda.empty_cache()
    times["ksweep"] = dict(ms=ksweep[k]["ms"], plain_ms=ksweep[k]["plain_ms"],
                           library_ms=None)
    mhz = [c[1] for c in clocks] or [float("nan")]
    watts = [c[2] for c in clocks] or [float("nan")]
    print(f"  jacobi_ksweep at {n}x{n} f32, frozen zero ghost rows, "
          f"{KSWEEP_TURNS} turns of k = {', '.join(map(str, KSWEEP_KS))} "
          f"({KSWEEP_TURN_REPS} graph replays of 4 calls each per turn), "
          f"{len(clocks)} nvidia-smi reads: SM clock {min(mhz):.0f}-"
          f"{max(mhz):.0f} MHz, power {min(watts):.1f}-{max(watts):.1f} W",
          flush=True)
    for kk in KSWEEP_KS:
        tk = ksweep[kk]
        b_ms, b_by = tk["bound"]
        print(f"    k={kk}: kernel {tk['ms']:.4f} ms per call (median turn; "
              f"{tk['spread'][0]:.4f}-{tk['spread'][1]:.4f}), "
              f"{tk['ms'] / kk:.4f} ms per sweep; bound {b_ms:.4f} ms "
              f"({b_by}, with the 2k ghost rows of u and f; the kernel "
              f"reaches {b_ms / tk['ms'] * 100:.1f}% of it); plain "
              f"{tk['plain_ms']:.4f} ms", flush=True)
    # the library call: one cuDNN conv2d over the stacked (u, f) with a
    # 2-channel 3x3 kernel (0.25 on u's cross, -0.25 on f's centre) and
    # zero rows padded above and below is one sweep's interior columns
    # with zero halo rows.  TF32 off, so it runs in f32; cudnn.benchmark
    # on, so cuDNN times its algorithms at the first call of each shape
    # (outside the graph) and keeps the fastest.  k sweeps take k chained calls, each
    # also passing f's centre through (a second output channel): a
    # yardstick for jacobi_ksweep, not one call, so its library_ms stays
    # null.
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    uf = torch.stack([u, f])[None]
    wk = torch.zeros((2, 2, 3, 3), device="cuda")
    wk[0, 0, 0, 1] = wk[0, 0, 2, 1] = wk[0, 0, 1, 0] = wk[0, 0, 1, 2] = 0.25
    wk[0, 1, 1, 1] = -0.25
    wk[1, 1, 1, 1] = 1.0
    w1k = wk[:1].contiguous()

    def conv():
        return torch.nn.functional.conv2d(uf, w1k, padding=(1, 0))

    def conv_chain():
        x = uf
        for _ in range(k):
            x = torch.nn.functional.conv2d(x, wk, padding=(1, 0))
        return x

    got = conv()[0, 0]
    torch.cuda.synchronize()
    want = st.jacobi_step(u, f, lo=z1, hi=z1, engine="torch")[:, 1:-1]
    conv_err = stencil_check(torch, got, want, CONV_TOL,
                             f"conv2d sweep float32 {n}x{n}")
    del got, want
    got = conv_chain()[0, 0]
    torch.cuda.synchronize()
    want = st.jacobi_ksweep_parts(zk, u, zk, zk, f, zk, k, k, k,
                                  engine="torch")[:, k:n - k]
    chain_err = stencil_check(torch, got, want, CONV_TOL,
                              f"{k} chained conv2d sweeps float32 {n}x{n}")
    del got, want
    times["step"]["library_ms"] = graph_ms(torch, [conv] * 2, 5)
    chain_ms = graph_ms(torch, [conv_chain], 3)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = saved
    del uf
    print(f"  library call for jacobi_step: one conv2d (cuDNN; "
          f"torch.backends.cudnn.allow_tf32 = False, "
          f"torch.backends.cudnn.benchmark = True; CUDA-graph replayed) "
          f"over the stacked (u, f), 2 channels in, 1 out, 3x3: one "
          f"sweep's interior at {n}x{n} f32 in "
          f"{times['step']['library_ms']:.4f} ms, max|err| against the "
          f"plain sweep {conv_err:.1e}; yardstick for jacobi_ksweep "
          f"(k = {k} chained conv2d calls, 2 channels out, f passed "
          f"through; not one call): {chain_ms:.4f} ms, max|err| against "
          f"the plain k sweeps {chain_err:.1e} (tolerance {CONV_TOL} x "
          f"max(1, max|want|): cuDNN sums in another order)", flush=True)

    # the same calls, kernel against plain, at this shape: the sweep, and
    # the k-sweep at every k timed (f32: exactly 0)
    tol = STENCIL_TOL[0][1]
    calls = [("step", "jacobi_step", lambda **kw: st.jacobi_step(
        u, f, lo=z1, hi=z1, **kw))]
    calls += [("ksweep", f"jacobi_ksweep k={kk}",
               lambda kk=kk, **kw: st.jacobi_ksweep_parts(
                   zks[kk], u, zks[kk], zks[kk], f, zks[kk], kk, kk, kk,
                   **kw)) for kk in KSWEEP_KS]
    for name, label, call in calls:
        got = call()
        torch.cuda.synchronize()
        want = call(engine="torch")
        err = stencil_check(torch, got, want, tol,
                            f"{label} float32 {n}x{n}")
        if name == "ksweep" and err != 0.0:
            fail(f"{label} float32 {n}x{n} (the main path's call): max|err| "
                 f"{err:.3e}, not 0 (the kernel does the plain version's "
                 f"f32 operations in its order)")
        errs[name] = max(errs[name], err)
        print(f"  {label} vs plain float32 {n}x{n} (the main path's call): "
              f"max|err| {err:.1e} (tolerance {tol} x max(1, max|want|)"
              f"{'; the k-sweep must be 0' if name == 'ksweep' else ''})",
              flush=True)
        del got, want
    # k > 8: chained launches of depth <= 8 over the one k-deep slab, at
    # the main path's width (f32: exactly 0), timed beside k = 8 per sweep
    kc = 2 * st.KSWEEP_MAX_K
    zc = torch.zeros((kc, n), device="cuda")
    before = st.KSWEEP_LAUNCHES
    got = st.jacobi_ksweep_parts(zc, u, zc, zc, f, zc, kc, kc, kc)
    torch.cuda.synchronize()
    links = st.KSWEEP_LAUNCHES - before
    want = st.jacobi_ksweep_parts(zc, u, zc, zc, f, zc, kc, kc, kc,
                                  engine="torch")
    err = stencil_check(torch, got, want, tol, f"chained k={kc} {n}x{n}")
    if err != 0.0 or links != len(st.ksweep_chain(kc)):
        fail(f"the chained k-sweep at k={kc}: max|err| {err:.3e} (not 0) "
             f"or {links} launches (not {len(st.ksweep_chain(kc))})")
    del got, want
    chain_ms = eager_ms(torch, [lambda: st.jacobi_ksweep_parts(
        zc, u, zc, zc, f, zc, kc, kc, kc, out=out)], 3)
    print(f"  jacobi_ksweep k={kc} as {links} chained launches "
          f"{st.ksweep_chain(kc)} over one slab at {n}x{n} f32: max|err| "
          f"against plain 0; {chain_ms:.4f} ms per call = "
          f"{chain_ms / kc:.4f} ms per sweep (the slab's copy included; "
          f"k={k} in one launch: {times['ksweep']['ms'] / k:.4f} ms per "
          f"sweep)", flush=True)
    del zc
    for name, (sweeps, ghosts) in (("step", (1, (2, 0))),
                                   ("ksweep", (k, (2 * k, 2 * k)))):
        tm = times[name]
        tm["bound_ms"], tm["bound_by"] = stencil_bound(n, n, 4, sweeps,
                                                       *ghosts)
        lib = ("none (one call does not sweep k times)"
               if tm["library_ms"] is None else f"{tm['library_ms']:.4f} ms")
        print(f"  jacobi_{name} at {n}x{n} f32 ({sweeps} sweep"
              f"{'s' if sweeps > 1 else ''} per call): kernel "
              f"{tm['ms']:.4f} ms ({tm['ms'] / sweeps:.4f} ms per sweep), "
              f"bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}; the kernel "
              f"reaches {tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
              f"{tm['plain_ms']:.4f} ms, library (conv2d) {lib}", flush=True)
    del u, f, out
    torch.cuda.empty_cache()
    return times, errs


# ---------------------------------------------------------------------------
# phase 2: the grouped-expert FFN, kernel vs plain, and its times
# ---------------------------------------------------------------------------

#: (G, C, D, F, E) of the SIMT engine (f32, and bf16 with D or F no
#: multiple of 64): one group per expert, gpe = 2 and 4, sizes that are no
#: multiple of its tiles
GROUPED_SHAPES = [(4, 16, 8, 12, 4), (8, 32, 8, 16, 4), (8, 32, 8, 16, 2),
                  (3, 257, 130, 70, 3), (6, 100, 200, 77, 3)]
#: (G, C, D, F, E) of the tensor-core engine (bf16): C = 480, 129 and 1,
#: gpe 1, 2 and 4, an F and a D that end on a half tile of 128
GROUPED_TC_SHAPES = [(6, 480, 128, 192, 6), (8, 129, 192, 128, 4),
                     (8, 1, 128, 64, 2)]
#: valid counts of the tensor-core shapes, clamped to C: a tile's edges
GROUPED_TC_VALID = (0, 1, 127, 128, 129, 10**9)
GROUPED_TOL = (("float32", 1e-5), ("bfloat16", 2e-2))
#: the tensor-core engine's f32 result before rounding, against the plain
#: f32 product, within this of its largest magnitude (act_hi w2 alone is
#: off by about 1e-3)
GROUPED_F32_TOL = 1e-4
#: the tensor-core engine's bf16 output (the binary the models run; the
#: f32 readout is another instantiation) equals the plain f32 product
#: rounded to bf16 on at least this share of the live elements (act_hi w2
#: alone: about 0.58)
GROUPED_BF16_SHARE = 0.99
#: alternating timings of the kernel and the yardstick at the prefill call,
#: and graph replays of each per turn
GROUPED_TURNS = 7
GROUPED_TURN_REPS = 40
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


def routed_counts(torch, rng, p=MOE_PREFILL):
    """Kept rows per expert of one call of ``p`` (the prefill's by
    default): each token's top-6 distinct experts drawn uniformly, loads
    clamped at the capacity."""
    picks = np.argsort(rng.random((p["b"] * p["s"], p["e"])), axis=1)
    load = np.bincount(picks[:, :p["k"]].ravel(), minlength=p["e"])
    return torch.tensor(np.minimum(load, p["c"]).astype(np.int32),
                        device="cuda")


def grouped_bound(kept, c, d, f, e, itemsize, gated=True):
    """Least time for one call over ``e`` groups (one an expert) that keeps
    ``kept`` rows: ``grouped_work`` (the products at the bf16 tensor-core
    rate; the kept rows of h, the expert weights and the whole output over
    HBM).  Returns (ms, 'bytes'|'operations')."""
    from repro_torch.kernels import grouped_matmul as gm

    return roof_ms(*gm.grouped_work(kept, e, c, d, f, e, itemsize, gated),
                   "bfloat16")


def grouped_check(torch, got, want, valid, tol, name):
    """Within tol x max(1, max|want|), padded rows exactly zero; returns
    max|err|."""
    err = stencil_check(torch, got, want, tol, name)
    pad = (torch.arange(got.shape[1], device="cuda")[None, :, None]
           >= valid[:, None, None]).expand_as(got)
    if not torch.equal(got[pad].float(), torch.zeros_like(got[pad].float())):
        fail(f"{name}: padded rows are not exactly zero")
    return err


def grouped_call(torch, gm, h, w1, w1g, w2, valid, mlp, tol, name):
    """One wrapper call against the plain version in f32 (see
    grouped_check); the engine must be the plan's, and for the tensor-core
    engine the f32 result before rounding must be within GROUPED_F32_TOL
    of the plain f32 product and the bf16 output equal to that product
    rounded on GROUPED_BF16_SHARE of the live elements.  Returns (max|err|,
    f32 readout's relative error, bf16 output's equal share), the last
    two None for SIMT."""
    engine = gm.grouped_plan(h, w1, w2, mlp).engine
    before = dict(gm.ENGINE_LAUNCHES)
    got = gm.grouped_expert_ffn(h, w1, w1g, w2, valid, mlp=mlp)
    torch.cuda.synchronize()
    if gm.ENGINE_LAUNCHES[engine] != before[engine] + 1:
        fail(f"{name}: the {engine} engine did not launch once")
    want = gm.grouped_expert_ffn_torch(
        h.float(), w1.float(), None if w1g is None else w1g.float(),
        w2.float(), valid, mlp)
    err = grouped_check(torch, got, want, valid, tol, name)
    if engine != "wgmma":
        return err, None, None
    live = (torch.arange(got.shape[1], device="cuda")[None, :, None]
            < valid[:, None, None]).expand_as(got)
    share = (got[live] == want[live].to(got.dtype)).float().mean().item()
    if not share >= GROUPED_BF16_SHARE:
        fail(f"{name}: the bf16 output equals the plain f32 product "
             f"rounded on {share:.4f} of the live elements (at least "
             f"{GROUPED_BF16_SHARE})")
    f32 = gm.down_product_f32(h, w1, w1g, w2, valid, mlp)
    rel = ((f32 - want).abs().max() / want.abs().max()).item()
    if not rel <= GROUPED_F32_TOL:
        fail(f"{name}: the f32 down product is off by {rel:.2e} of its "
             f"size (tolerance {GROUPED_F32_TOL})")
    return err, rel, share


def phase_grouped(torch):
    from repro_torch.kernels import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    err_bf16 = 0.0
    cases = [(dname, tol, shape, None) for dname, tol in GROUPED_TOL
             for shape in GROUPED_SHAPES]
    cases += [("bfloat16", GROUPED_TOL[1][1], shape, "wgmma")
              for shape in GROUPED_TC_SHAPES]
    for dname, tol, shape, tc_engine in cases:
        dtype = getattr(torch, dname)
        g, c = shape[:2]
        if tc_engine:
            valid = torch.tensor([min(GROUPED_TC_VALID[i % 6], c)
                                  for i in range(g)], dtype=torch.int32,
                                 device="cuda")
        else:
            valid = torch.tensor(rng.integers(0, c + 1, size=g),
                                 dtype=torch.int32, device="cuda")
            valid[0], valid[-1] = 0, c
        h, w1, w1g, w2 = grouped_inputs(torch, gen, shape, dtype, valid)
        engine = gm.grouped_plan(h, w1, w2, "swiglu").engine
        if engine != (tc_engine or "simt"):
            fail(f"grouped_plan picks {engine} for {dname} {shape}")
        errs, rels, shares = [], [], []
        for mlp in ("swiglu", "geglu", "relu2", "gelu"):
            err, rel, share = grouped_call(
                torch, gm, h, w1, w1g if gm.gated(mlp) else None, w2, valid,
                mlp, tol, f"grouped_expert_ffn {dname} {mlp} {shape}")
            errs.append(err)
            if rel is not None:
                rels.append(rel)
                shares.append(share)
        if dtype == torch.bfloat16:
            err_bf16 = max(err_bf16, max(errs))
        print(f"  grouped_expert_ffn vs plain {dname} (G, C, D, F, E) = "
              f"{shape} on the {engine} engine, valid "
              f"{valid.tolist() if g <= 8 else 'random'}, swiglu, geglu, "
              f"relu2, gelu: max|err| {max(errs):.2e} (tolerance {tol} x "
              f"max(1, max|want|)); padded rows exactly 0"
              + (f"; f32 result before rounding within {max(rels):.2e} of "
                 f"its size (tolerance {GROUPED_F32_TOL}); bf16 output "
                 f"equal to the plain f32 product rounded on "
                 f"{min(shares):.4f} of the live elements (at least "
                 f"{GROUPED_BF16_SHARE})" if rels else ""), flush=True)

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
    plan = gm.grouped_plan(h, w1, w2, "swiglu")
    if plan.engine != "wgmma":
        fail(f"the moonshot prefill call plans {plan}")
    rows, up_cols, down_cols = gm.tile_shape(plan.engine, "swiglu")
    n_row = -(-p["c"] // rows)
    live_rows = sum(-(-v // rows) for v in valid.tolist())
    up_n, down_n = -(-p["f"] // up_cols), -(-p["d"] // down_cols)
    up_tiles, down_tiles = p["e"] * n_row * up_n, p["e"] * n_row * down_n
    print(f"  plan at the moonshot prefill call: engine {plan.engine}, "
          f"tiles {rows} x {up_cols} (up) and {rows} x {down_cols} (down), "
          f"{min(plan.ctas, up_tiles)} and {min(plan.ctas, down_tiles)} "
          f"persistent CTAs, live tiles {live_rows * up_n} of {up_tiles} "
          f"(up) and {live_rows * down_n} of {down_tiles} (down)",
          flush=True)
    err, rel, share = grouped_call(
        torch, gm, h, w1, w1g, w2, valid, "swiglu", GROUPED_TOL[1][1],
        f"grouped_expert_ffn bf16 prefill call {shape}")
    err_bf16 = max(err_bf16, err)
    kept = int(valid.sum())
    print(f"  grouped_expert_ffn vs plain bf16 at the moonshot prefill call "
          f"(G = E = 64, C = 480, D = 2048, F = 1408, swiglu, {kept} kept "
          f"rows): max|err| {err:.2e} (tolerance {GROUPED_TOL[1][1]} x "
          f"max(1, max|want|)); padded rows exactly 0; f32 result before "
          f"rounding within {rel:.2e} of its size (tolerance "
          f"{GROUPED_F32_TOL}); bf16 output equal to the plain f32 product "
          f"rounded on {share:.4f} of the live elements (at least "
          f"{GROUPED_BF16_SHARE})", flush=True)

    def bmm3(s):
        hh, a, b, c2, _ = s
        return torch.bmm(torch.bmm(hh, a) * torch.bmm(hh, b), c2)

    kernel = [lambda s=s: gm.grouped_expert_ffn(*s[:4], s[4], mlp="swiglu")
              for s in sets]
    plain = [lambda s=s: gm.grouped_expert_ffn_torch(*s[:4], s[4],
                                                     "swiglu")
             for s in sets]
    yard = [lambda s=s: bmm3(s) for s in sets]
    tm = dict(plain_ms=graph_ms(torch, plain, 3), library_ms=None)
    # the kernel and the yardstick in turns, while nvidia-smi reads the
    # clocks: the kernel's time is the median of its turns
    timers = graph_timer(torch, kernel * 2), graph_timer(torch, yard * 2)

    def take_turns():
        out = []
        for _ in range(GROUPED_TURNS):
            t0 = time.perf_counter()
            out.append((timers[0](GROUPED_TURN_REPS),
                        timers[1](GROUPED_TURN_REPS), t0,
                        time.perf_counter()))
        return out

    turns, clocks = with_clocks(take_turns)
    kernel_ms = sorted(t[0] for t in turns)
    yard_ms = sorted(t[1] for t in turns)
    tm["ms"] = kernel_ms[len(turns) // 2]
    kept_mean = sum(int(s[4].sum()) for s in sets) / len(sets)
    tm["bound_ms"], tm["bound_by"] = grouped_bound(
        kept_mean, p["c"], p["d"], p["f"], p["e"], 2)
    print(f"  grouped_expert_ffn at the moonshot prefill call (bf16, "
          f"{kept_mean:.0f} kept rows of {p['e'] * p['c']}): kernel "
          f"{tm['ms']:.4f} ms (the median of {GROUPED_TURNS} turns, "
          f"{kernel_ms[0]:.4f}-{kernel_ms[-1]:.4f} ms), bound "
          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}: the three products "
          f"at the bf16 rate; the kernel reaches "
          f"{tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain "
          f"{tm['plain_ms']:.4f} ms; no single library call computes it; "
          f"yardstick, in turns with the kernel: three torch.bmm on the "
          f"padded buffers in bf16 (cuBLAS, padding included, one "
          f"elementwise product in place of the activation, a bf16 second "
          f"product) {yard_ms[len(turns) // 2]:.4f} ms "
          f"({yard_ms[0]:.4f}-{yard_ms[-1]:.4f} ms)", flush=True)
    line = []
    for k_ms, y_ms, t0, t1 in turns:
        mhz = [c[1] for c in clocks if t0 <= c[0] <= t1]
        line.append(f"{k_ms:.4f} / {y_ms:.4f} ms at "
                    + (f"{min(mhz):.0f}-{max(mhz):.0f} MHz" if mhz
                       else "no read"))
    print(f"  turns of {GROUPED_TURN_REPS} replays each, kernel / "
          f"yardstick, SM clock read meanwhile: {'; '.join(line)}",
          flush=True)
    if clocks:
        _, mhz, watts, temp = zip(*clocks)
        print(f"  nvidia-smi during the turns ({len(clocks)} reads): SM "
              f"clock {min(mhz):.0f}-{max(mhz):.0f} MHz, power "
              f"{min(watts):.1f}-{max(watts):.1f} W, "
              f"{min(temp):.0f}-{max(temp):.0f} C", flush=True)
    else:
        print("  nvidia-smi during the turns: no read", flush=True)
    del sets, h, w1, w1g, w2, kernel, plain, yard, timers
    torch.cuda.empty_cache()
    return tm, err_bf16


#: (G, C, D, F, E) of the backward's checks: the SIMT engine's (f32 at
#: 1e-5, and bf16 at 2e-2 where D or F is no multiple of 64) and the
#: tensor cores' (bf16 at 2e-2); one and two groups an expert, sizes that
#: end on part of a tile
GROUPED_BWD_SHAPES = [(4, 40, 24, 40, 4), (4, 40, 24, 40, 2),
                      (3, 70, 130, 70, 3)]
GROUPED_BWD_TC_SHAPES = [(4, 200, 128, 192, 4), (4, 129, 192, 128, 2)]
#: the tensor cores' bf16 gradients equal the plain f32 ones rounded to
#: bf16 on at least this share of their elements (dU, dG and act kept as
#: bf16 alone, without their lo halves, move them by about 4e-3)
GROUPED_BWD_BF16_SHARE = 0.99
#: moonshot-v1-16b-a3b's training call (phase 8): B=2 x S=1024 tokens,
#: top-6 of 64 experts, capacity ceil(2048 * 6 * 1.25 / 64) = 240
MOE_TRAIN = dict(b=2, s=1024, e=64, k=6, c=240, d=2048, f=1408)
#: alternating timings of the backward and its yardstick, and graph
#: replays of each per turn
GROUPED_BWD_TURNS = 5
GROUPED_BWD_TURN_REPS = 10


def grouped_bwd_inputs(torch, gen, shape, dtype, valid):
    """grouped_inputs and dy, each with 1e3-scale garbage past valid."""
    h, w1, w1g, w2 = grouped_inputs(torch, gen, shape, dtype, valid)
    g, c, d = shape[:3]
    dy = torch.randn((g, c, d), generator=gen, device="cuda")
    rows = torch.arange(c, device="cuda")[None, :, None]
    junk = 1e3 * torch.randn((g, c, d), generator=gen, device="cuda")
    dy = torch.where(rows < valid[:, None, None], dy, junk).to(dtype)
    return h, w1, w1g, w2, dy


def grouped_bwd_call(torch, gm, h, w1, w1g, w2, valid, dy, mlp, tol, name):
    """One backward call against the plain backward in f32: each gradient
    within tol x max(1, max|want|), dh exactly 0 past valid, the weight
    gradients of an expert that keeps no row exactly 0, one launch on
    ``bwd_engine``'s engine; on the tensor cores each gradient also equal
    to the plain one rounded to bf16 on GROUPED_BWD_BF16_SHARE of its
    elements.  Returns (max|err|, the smallest equal share or None)."""
    engine = gm.bwd_engine(h, w1, w2)
    before = dict(gm.BWD_ENGINE_LAUNCHES)
    got = gm.grouped_expert_ffn_bwd(h, w1, w1g, w2, valid, dy, mlp)
    torch.cuda.synchronize()
    if gm.BWD_ENGINE_LAUNCHES[engine] != before[engine] + 1:
        fail(f"{name}: the {engine} backward did not launch once")
    want = gm.grouped_expert_ffn_bwd_torch(
        *[None if t is None else t.float() for t in (h, w1, w1g, w2)], valid,
        dy.float(), mlp)
    live = (torch.arange(h.shape[1], device="cuda")[None, :, None]
            < valid[:, None, None]).expand_as(h)
    gpe = h.shape[0] // w1.shape[0]
    empty = valid.reshape(-1, gpe).clamp_min(0).sum(1) == 0
    errs, shares = [], []
    for what, g_, w_ in zip(("dh", "dw1", "dw1g", "dw2"), got, want):
        if g_ is None:
            continue
        errs.append(stencil_check(torch, g_, w_, tol, f"{name} {what}"))
        zero = g_[~live] if what == "dh" else g_[empty]
        if not torch.equal(zero.float(), torch.zeros_like(zero.float())):
            fail(f"{name}: {what} is not exactly 0 past valid or for an "
                 f"expert with no kept row")
        if engine == "mma":
            sel = live if what == "dh" else torch.ones_like(g_, dtype=bool)
            shares.append((g_[sel] == w_[sel].to(g_.dtype)).float().mean()
                          .item())
            if not shares[-1] >= GROUPED_BWD_BF16_SHARE:
                fail(f"{name}: {what} equals the plain f32 gradient rounded "
                     f"on {shares[-1]:.4f} of its elements (at least "
                     f"{GROUPED_BWD_BF16_SHARE})")
    return max(errs), (min(shares) if shares else None)


#: the grouped backward's kernels by step, from their names
GROUPED_BWD_STEP_KEYS = (("_dact_", "step 1"), ("_act_", "step 1"),
                         ("_dh_", "step 2"), ("_dw_", "step 3"))


def bwd_step_ms(torch, fns, calls: int):
    """Device ms a call of each step of the grouped FFN's backward
    (``ffn_bwd_act_*`` step 1, ``ffn_bwd_dh_*`` step 2, ``ffn_bwd_dw_*``
    step 3), and of each of its kernels by name, from ``torch.profiler``
    over ``calls`` calls of the functions in ``fns`` taken in turn (after
    one warm call of each)."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fns[i % len(fns)]()
        torch.cuda.synchronize()
    kernels: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and "ffn_bwd" in e.key:
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / calls
    steps = {step: 0.0 for _, step in GROUPED_BWD_STEP_KEYS}
    for name, ms in kernels.items():
        for key, step in GROUPED_BWD_STEP_KEYS:
            if key in name:
                steps[step] += ms
                break
    return steps, kernels


def phase_grouped_bwd(torch):
    """Phase 2: the grouped FFN's backward kernels against the plain
    backward (both engines, every activation, one and two groups an
    expert, valid counts of 0, part and all of a group), then at
    moonshot's training call, timed in turns with a yardstick."""
    from repro_torch.kernels import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rng = np.random.default_rng(SEED + 20)
    err_bf16 = 0.0
    cases = [(dname, tol, shape) for dname, tol in GROUPED_TOL
             for shape in GROUPED_BWD_SHAPES]
    cases += [("bfloat16", GROUPED_TOL[1][1], shape)
              for shape in GROUPED_BWD_TC_SHAPES]
    for dname, tol, shape in cases:
        dtype = getattr(torch, dname)
        g, c, _, _, e = shape
        vals = rng.integers(1, c, size=g)
        vals[: g // e] = 0                    # expert 0 keeps no row
        vals[-1] = c
        valid = torch.tensor(vals, dtype=torch.int32, device="cuda")
        h, w1, w1g, w2, dy = grouped_bwd_inputs(torch, gen, shape, dtype,
                                                valid)
        engine = gm.bwd_engine(h, w1, w2)
        errs, shares = [], []
        for mlp in ("swiglu", "geglu", "relu2", "gelu"):
            err, share = grouped_bwd_call(
                torch, gm, h, w1, w1g if gm.gated(mlp) else None, w2, valid,
                dy, mlp, tol, f"grouped_expert_ffn_bwd {dname} {mlp} {shape}")
            errs.append(err)
            if share is not None:
                shares.append(share)
        if dtype == torch.bfloat16:
            err_bf16 = max(err_bf16, max(errs))
        print(f"  grouped_expert_ffn_bwd vs plain {dname} (G, C, D, F, E) = "
              f"{shape} on the {engine} engine, valid {valid.tolist()}, "
              f"swiglu, geglu, relu2, gelu: max|err| {max(errs):.2e} "
              f"(tolerance {tol} x max(1, max|want|)); dh exactly 0 past "
              f"valid, expert 0's weight gradients exactly 0"
              + (f"; every gradient equal to the plain f32 one rounded to "
                 f"bf16 on at least {min(shares):.4f} of its elements "
                 f"(limit {GROUPED_BWD_BF16_SHARE})" if shares else ""),
              flush=True)

    # moonshot's training call, kernel against plain, then its times; two
    # input sets so consecutive calls do not find the weights in L2
    p = MOE_TRAIN
    shape = (p["e"], p["c"], p["d"], p["f"], p["e"])
    sets = []
    for _ in range(2):
        valid = routed_counts(torch, rng, p)
        sets.append((*grouped_bwd_inputs(torch, gen, shape, torch.bfloat16,
                                         valid), valid))
    h, w1, w1g, w2, dy, valid = sets[0]
    err, share = grouped_bwd_call(
        torch, gm, h, w1, w1g, w2, valid, dy, "swiglu", GROUPED_TOL[1][1],
        f"grouped_expert_ffn_bwd bf16 training call {shape}")
    err_bf16 = max(err_bf16, err)
    kept_mean = sum(int(s[5].sum()) for s in sets) / len(sets)
    print(f"  grouped_expert_ffn_bwd vs plain bf16 at moonshot's training "
          f"call (G = E = 64, C = 240, D = 2048, F = 1408, swiglu, "
          f"{int(valid.sum())} kept rows, the mma engine): max|err| "
          f"{err:.2e} (tolerance {GROUPED_TOL[1][1]} x max(1, max|want|)); "
          f"dh exactly 0 past valid; every gradient equal to the plain f32 "
          f"one rounded on at least {share:.4f} of its elements", flush=True)

    def autograd_bmm3(s):
        hh, a, b, c2, y = s[:5]
        leaves = [t.detach().requires_grad_() for t in (hh, a, b, c2)]
        out = torch.bmm(torch.bmm(leaves[0], leaves[1])
                        * torch.bmm(leaves[0], leaves[2]), leaves[3])
        return torch.autograd.grad(out, leaves, y)

    kernel = [lambda s=s: gm.grouped_expert_ffn_bwd(*s[:4], s[5], s[4],
                                                    "swiglu") for s in sets]
    nothing = torch.zeros_like(sets[0][5])
    empty = [lambda s=s: gm.grouped_expert_ffn_bwd(*s[:4], nothing, s[4],
                                                   "swiglu") for s in sets]
    plain = [lambda s=s: gm.grouped_expert_ffn_bwd_torch(*s[:4], s[5], s[4],
                                                         "swiglu")
             for s in sets]
    yard = [lambda s=s: autograd_bmm3(s) for s in sets]
    tm = dict(plain_ms=graph_ms(torch, plain, 3), library_ms=None)
    timers = (graph_timer(torch, kernel * 2), graph_timer(torch, yard * 2),
              graph_timer(torch, empty * 2))

    def take_turns():
        out = []
        for _ in range(GROUPED_BWD_TURNS):
            t0 = time.perf_counter()
            out.append((*(t(GROUPED_BWD_TURN_REPS) for t in timers), t0,
                        time.perf_counter()))
        return out

    turns, clocks = with_clocks(take_turns)
    kernel_ms, yard_ms, empty_ms = (sorted(t[i] for t in turns)
                                    for i in range(3))
    tm["ms"] = kernel_ms[len(turns) // 2]
    tm["bound_ms"], tm["bound_by"] = roof_ms(*gm.grouped_bwd_work(
        kept_mean, p["e"], p["c"], p["d"], p["f"], p["e"], 2), "bfloat16")
    print(f"  grouped_expert_ffn_bwd at moonshot's training call (bf16, "
          f"{kept_mean:.0f} kept rows of {p['e'] * p['c']}): kernel "
          f"{tm['ms']:.4f} ms (the median of {GROUPED_BWD_TURNS} turns, "
          f"{kernel_ms[0]:.4f}-{kernel_ms[-1]:.4f} ms), bound "
          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}: grouped_bwd_work's "
          f"eight products at the bf16 rate, the weights read and their "
          f"gradients written over HBM; the kernel reaches "
          f"{tm['bound_ms'] / tm['ms'] * 100:.1f}% of it), plain (f32, in "
          f"a CUDA graph) {tm['plain_ms']:.4f} ms; no single library call "
          f"computes it; yardstick, in turns with the kernel: torch "
          f"autograd through three bf16 torch.bmm on the padded buffers "
          f"(forward and backward, cuBLAS, padding included, an "
          f"elementwise product in place of the activation) "
          f"{yard_ms[len(turns) // 2]:.4f} ms "
          f"({yard_ms[0]:.4f}-{yard_ms[-1]:.4f} ms)", flush=True)
    line = []
    for k_ms, y_ms, e_ms, t0, t1 in turns:
        mhz = [c[1] for c in clocks if t0 <= c[0] <= t1]
        line.append(f"{k_ms:.4f} / {y_ms:.4f} / {e_ms:.4f} ms at "
                    + (f"{min(mhz):.0f}-{max(mhz):.0f} MHz" if mhz
                       else "no read"))
    print(f"  turns of {GROUPED_BWD_TURN_REPS} replays each, kernel / "
          f"yardstick / all-empty call, SM clock read meanwhile: "
          f"{'; '.join(line)}", flush=True)
    g, c, d, f = p["e"], p["c"], p["d"], p["f"]
    plan = gm.grouped_bwd_plan(g, c, d, f, g, True, n_sm=torch.cuda
                               .get_device_properties(0).multi_processor_count)
    built = gm.grouped_bwd_built(True)
    for ln in plan.launches:
        mine = (ln.threads, ln.rows, ln.cols, ln.depth, ln.stages, ln.smem)
        print(f"  backward launch {ln.step}: plan {mine}, {len(ln.tiles)} "
              f"tiles over {ln.grid} persistent CTAs (walk "
              f"{' > '.join(ln.walk)}); built {built[ln.step][:6]}, "
              f"{built[ln.step][6]} CTA an SM", flush=True)
        if built[ln.step][:6] != mine or built[ln.step][6] != 1:
            fail(f"the built backward launch {ln.step} is not its plan")
    zeros_ms = (g * c * d + 3 * g * d * f) * 2 / HBM_BW * 1e3
    steps = bwd_step_ms(torch, kernel, 4)[0]
    empty_steps = bwd_step_ms(torch, empty, 4)[0]
    print(f"  grouped_expert_ffn_bwd by step (torch.profiler, device ms a "
          f"call over 4 calls): "
          + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
          + f"; the all-empty call (every valid 0) "
          f"{empty_ms[len(turns) // 2]:.4f} ms in turns ("
          + ", ".join(f"{k} {v:.4f}" for k, v in empty_steps.items())
          + f") against {zeros_ms:.4f} ms to write dh and the weight "
          f"gradients' zeros at {HBM_BW / 1e12:.2f} TB/s", flush=True)
    del sets, h, w1, w1g, w2, dy, kernel, empty, plain, yard, timers
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
    block: ``flash_work("carry")`` (QK^T and PV over the unmasked pairs at
    the bf16 tensor-core rate; q, k, v read once, the f32 carry read and
    written once).  Returns (ms, 'bytes'|'operations')."""
    from repro_torch.kernels import flash_attention as fa

    return roof_ms(*fa.flash_work("carry", b, s, s, h, kvh, hd, itemsize,
                                  causal=True), "bfloat16")


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


def serve(torch, model, prompts, n_new, max_seq=512, eager=False, **kw):
    """Serve ``prompts`` through a ServeEngine of 8 slots and 16-token
    pages; returns (tokens, engine, host wall, paged launches).  On the
    card the engine replays its captured decode step; ``eager`` runs the
    step from Python instead, through the step object's explicit
    ``run_eager`` (the engine has no switch for it)."""
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(model, slots=8, page_size=16, max_seq=max_seq, **kw)
    if eager:
        eng.step.capture = eng.step.replay = eng.step.run_eager
    rids = [eng.submit(p, n_new) for p in prompts]
    paged.LAUNCHES = 0                # counts of this run only
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged.LAUNCHES
    if eager:
        # the patches point back at the step; unbound, nothing keeps the
        # model alive once the caller deletes it
        del eng.step.capture, eng.step.replay
    return [out[r] for r in rids], eng, wall, launches


def launch_words(delta: dict) -> str:
    """A step object's ``replay_launches`` in words."""
    return ", ".join(
        f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"
        f"{'' if key is None else f'[{key}]'} +{n}"
        for (mod, name, key), n in delta.items()) or "no launch"


def check_graph(eng, what: str) -> str:
    """Fail unless ``eng`` ran its quanta as replays of a captured step;
    returns the words that say so."""
    if eng.quantum_mode != "graph" or eng.step.graph is None:
        fail(f"{what}: the engine ran its quanta {eng.quantum_mode}, "
             f"captured {eng.step.graph is not None}, not as graph replays")
    return (f"quanta as CUDA graph replays "
            f"({launch_words(eng.step.replay_launches)} a replay)")


def check_train_graph(step, what: str, replays: int,
                      bindings: int = 1) -> str:
    """Fail unless the training step object ``step`` ran every step after
    each binding's first as a replay of its captured CUDA graph:
    ``replays`` replays over ``bindings`` bindings.  Returns the words
    that say so."""
    if step.step_mode != "graph" or step.graph is None:
        fail(f"{what}: the training step ran {step.step_mode}, captured "
             f"{step.graph is not None}, not as graph replays")
    if (step.replays, step.bindings) != (replays, bindings):
        fail(f"{what}: {step.replays} graph replays over {step.bindings} "
             f"bindings, not {replays} over {bindings}")
    return (f"steps after each binding's first as CUDA graph replays "
            f"({replays} replays, {bindings} binding"
            f"{'s' if bindings > 1 else ''}; "
            f"{launch_words(step.replay_launches)} a replay)")


@contextlib.contextmanager
def kept_train_steps(module):
    """The training step objects ``module.build_train_step`` makes inside
    the block (an example or a launcher that keeps its step to itself)."""
    made, real = [], module.build_train_step

    def build(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    module.build_train_step = build
    try:
        yield made
    finally:
        module.build_train_step = real


def train_step_modes(torch, step, opt, batches, what: str) -> dict:
    """One training step as a replay of ``step``'s captured graph and one
    from Python (``run_eager`` over the same state), each timed bare, then
    once more under torch.profiler: host wall, device time by kind, busy
    share, peak memory allocated over the bare step and reserved after
    it.  The graph and its pool are released before the eager steps (at
    phi4-mini's full width the pool and an eager step's temporaries do
    not fit the card together).  ``batches``: four batches on the card.
    Returns {"graph" | "eager": (host ms, device ms, peak GB)}."""
    from torch.profiler import ProfilerActivity, profile

    out, it = {}, iter(batches)
    for way, label in (("graph", "one CUDA graph replay"),
                       ("eager", "eager from Python")):
        if way == "eager":
            step.release()

        def run(batch):
            if way == "eager":
                step.load(opt, batch)
                return float(step.run_eager()["loss"])
            return float(step(opt, batch)[1]["loss"])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(next(it))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        reserved = torch.cuda.memory_reserved() / 1e9
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(next(it))
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        per_kernel = device_ms_by_kernel(torch, prof, 1)
        dev = sum(per_kernel.values())
        print(f"  {what}, {label}: {wall:.2f} ms host wall; under "
              f"torch.profiler {prof_wall:.2f} ms host wall, {dev:.2f} ms "
              f"device time (busy share {dev / prof_wall * 100:.1f}%); peak "
              f"{peak:.2f} GB allocated, {reserved:.2f} GB reserved",
              flush=True)
        print_by_kind(per_kernel, f"{what} ({label})")
        out[way] = (wall, dev, peak)
    return out


def profile_decode_step(torch, model, slots: int = 8, page: int = 16,
                        pos: int = 192) -> None:
    """Where one serving decode step's time goes, the step run from Python
    (``PagedStep.run_eager``) beside one replay of its CUDA graph: host
    wall per step (no profiler), device time per step by kernel from
    torch.profiler, and the device's busy share.  Every slot is active,
    from position ``pos`` on (each step advances it)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import build_paged_step

    dev, n = model.device, 10
    pmax = 512 // page
    specs = model.paged_cache_specs(slots, slots * pmax, page)
    cache = {k: torch.zeros(shape, dtype=dt, device=dev)
             for k, (shape, dt) in specs.items()}
    step = build_paged_step(model, cache, slots=slots, max_pages=pmax,
                            max_chunk=4 * n)
    table = np.arange(slots * pmax, dtype=np.int32).reshape(slots, pmax)
    tok = np.arange(slots, dtype=np.int32)[:, None]
    z = np.zeros(slots, np.int32)
    step.load(table, tok, z + 1, z, z + pos)        # every slot inactive
    step.capture()
    torch.cuda.synchronize()
    bound = model.cfg.param_count() * 2 / HBM_BW * 1e3
    for way, run in (("eager from Python", step.run_eager),
                     ("one CUDA graph replay", step.replay)):
        step.load(table, tok, z + 1, z + 4 * n, z + pos)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
        per_kernel = device_ms_by_kernel(torch, prof, n)
        dev_ms = sum(per_kernel.values())
        print(f"  one decode step ({slots} slots at positions {pos}-"
              f"{pos + 2 * n + 2}), {way}: {wall_ms:.3f} ms host wall, "
              f"{dev_ms:.3f} ms device time by torch.profiler (busy share "
              f"{dev_ms / wall_ms * 100:.1f}%; weights-streaming bound "
              f"{bound:.2f} ms)", flush=True)
        print_by_kind(per_kernel, f"decode step ({way})")
    del step, cache


#: the contiguous decode's full-width timing (phase 3): 8 prompts of 96
#: tokens, 64 new tokens, a 256-position cache
CONTIG = dict(b=8, p=96, new=64, seq=256)


def check_decode_graph(gen, what: str) -> str:
    """Fail unless the contiguous Generator ``gen`` ran every decode step
    as its step's capture (a binding's first step) or a replay of the
    captured CUDA graph, with ``decode_mode`` "graph".  Returns the words
    that say so."""
    st = gen.step
    if st.decode_mode != "graph" or st.graph is None:
        fail(f"{what}: the contiguous decode ran {st.decode_mode}, "
             f"captured {st.graph is not None}, not as graph replays")
    if st.steps != st.captures + st.replays or st.captures > st.bindings:
        fail(f"{what}: {st.steps} decode steps, {st.captures} captures and "
             f"{st.replays} replays over {st.bindings} bindings")
    return (f"decode steps as CUDA graph replays ({st.replays} replays and "
            f"{st.captures} capture{'s' if st.captures > 1 else ''} over "
            f"{st.steps} steps; {launch_words(st.replay_launches)} a "
            f"replay)")


def contiguous_decode_modes(torch, model,
                            order=("graph", "eager", "graph")) -> dict:
    """The contiguous Generator at ``CONTIG``: its decode steps as replays
    of the captured step ("graph") and issued from Python ("eager",
    through the step's ``run_eager``), after a short warm-up generation
    each (8 + 8 tokens: the capture), one timed generation for each entry
    of ``order`` (phase 3 takes one eager generation between two replayed
    ones: an eager one costs 10-15 s at this size) while another thread
    reads the SM clock, then the short generation each under
    torch.profiler.  A Generator without a step object (an
    older checkout) runs "eager" only.  Returns {mode: {"tokens",
    "wall_ms": host wall a decode step of each turn, "mhz": the SM clock
    over each turn, "prof_wall_ms", "device_ms": a step's device time,
    "per_kernel"}} and the graph mode's Generator under "gen"."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.serve_loop import Generator

    c = CONTIG
    rng = np.random.default_rng(SEED + 33)
    prompts = rng.integers(0, model.cfg.vocab_size - 1,
                           size=(c["b"], c["p"])).astype(np.int32)
    shape = ShapeConfig("contig", c["seq"], c["b"], "decode")
    gens = {"graph": Generator(model, shape)}
    modes = ["graph", "eager"] if hasattr(gens["graph"], "step") \
        else ["eager"]
    if modes[0] == "eager":
        gens = {"eager": gens["graph"]}
    else:
        # a Generator of its own, its step's capture and replay pointed at
        # run_eager (the step has no switch for it)
        gens["eager"] = Generator(model, shape)
        eager = gens["eager"].step
        eager.capture = eager.replay = eager.run_eager
    steps = c["p"] + c["new"] - 1

    short = prompts[:, :8]
    out = {m: {"wall_ms": [], "mhz": []} for m in modes}
    for m in modes:
        gens[m].generate(short, 8)                     # warm-up
    order = [m for m in order if m in modes]
    marks = []

    def timed():
        for m in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = gens[m].generate(prompts, c["new"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            marks.append((m, t0, t1))
            if "tokens" not in out[m]:
                out[m]["tokens"] = toks
            elif not np.array_equal(toks, out[m]["tokens"]):
                fail(f"contiguous decode ({m}): two generations of the same "
                     f"prompts differ")
    _, clocks = with_clocks(timed)
    for m, t0, t1 in marks:
        out[m]["wall_ms"].append((t1 - t0) / steps * 1e3)
        mhz = [x[1] for x in clocks if t0 <= x[0] <= t1]
        out[m]["mhz"].append((min(mhz), max(mhz)) if mhz else None)
    # the profile over a short generation: every step attends the whole
    # cache, so a step's work does not depend on its position
    n_prof = short.shape[1] + 8 - 1
    for m in modes:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gens[m].generate(short, 8)
            torch.cuda.synchronize()
            out[m]["prof_wall_ms"] = (time.perf_counter() - t0) / n_prof \
                * 1e3
        out[m]["per_kernel"] = device_ms_by_kernel(torch, prof, n_prof)
        out[m]["device_ms"] = sum(out[m]["per_kernel"].values())
    if "graph" in gens:
        # unbound, the patches no longer keep the model alive
        del gens["eager"].step.capture, gens["eager"].step.replay
        out["gen"] = gens["graph"]
        # the f32 copies of the whole K and V cache that attention_decode
        # makes in every layer (k_cache.float(), v_cache.float()), alone
        # in a CUDA graph: a step's worth
        cache = gens["graph"].step.cache
        slabs = [leaf[i] for leaf in (cache["k"], cache["v"])
                 for i in range(leaf.shape[0])]
        out["graph"]["f32_cache_copies_ms"] = graph_ms(
            torch, [lambda: [t.float() for t in slabs]], 20)
    return out


def print_contiguous_modes(res: dict, what: str, card: str) -> None:
    """``contiguous_decode_modes``' result, a line a mode (with ``card``,
    the card's name and power limit) and its device time by kind."""
    c = CONTIG
    for m in ("graph", "eager"):
        if m not in res:
            continue
        r = res[m]
        label = ("one CUDA graph replay a step" if m == "graph"
                 else "each step from Python (run_eager)")
        turns = ", ".join(f"{w:.3f} ms (SM {mhz[0]:.0f}-{mhz[1]:.0f} MHz)"
                          if mhz else f"{w:.3f} ms"
                          for w, mhz in zip(r["wall_ms"], r["mhz"]))
        print(f"  {what} contiguous decode, {c['b']} prompts of {c['p']} + "
              f"{c['new']} new tokens, {c['seq']}-position cache, {label}: "
              f"host wall a decode step by turn {turns}; under "
              f"torch.profiler {r['prof_wall_ms']:.3f} ms host wall, "
              f"{r['device_ms']:.3f} ms device time a step (busy share "
              f"{r['device_ms'] / r['prof_wall_ms'] * 100:.1f}%); on {card}",
              flush=True)
        print_by_kind(r["per_kernel"], f"{what} contiguous decode step "
                      f"({label})")
        if "f32_cache_copies_ms" in r:
            ms = r["f32_cache_copies_ms"]
            print(f"  {what} contiguous decode: the f32 copies of the whole "
                  f"K/V cache a step (k_cache.float(), v_cache.float() in "
                  f"every layer) take {ms:.3f} ms alone in a CUDA graph, "
                  f"{ms / max(r['device_ms'], 1e-9) * 100:.1f}% of a "
                  f"replayed step's device time", flush=True)


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
    way = check_graph(eng, "phase 3")
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
          f" ms host wall per decode step; {way}", flush=True)
    PHASE3.update(tokens=got, decode_steps=eng.decode_steps)
    del eng
    eager, eng, e_wall, e_launches = serve(torch, model, prompts, 32,
                                           schedule="auto", eager=True)
    for i, (a, b) in enumerate(zip(got, eager)):
        if not np.array_equal(a, b):
            fail(f"request {i}: graph replays {a.tolist()} != run_eager "
                 f"{b.tolist()}")
    if e_launches != cfg.n_layers * eng.decode_steps:
        fail(f"run_eager: paged launches {e_launches} != {cfg.n_layers} x "
             f"{eng.decode_steps}")
    print(f"  the same 8 requests with each step through run_eager (the "
          f"step from Python): tokens equal the graph replays' bit for bit;"
          f" {eng.decode_steps} decode steps, {e_wall:.2f} s "
          f"({e_wall / eng.decode_steps * 1e3:.2f} ms host wall a step), "
          f"paged launches {e_launches}", flush=True)
    del eng
    profile_decode_step(torch, model)
    contig = contiguous_decode_modes(torch, model)
    if not np.array_equal(contig["graph"]["tokens"],
                          contig["eager"]["tokens"]):
        fail(f"contiguous decode: graph replays "
             f"{contig['graph']['tokens'].tolist()} != run_eager "
             f"{contig['eager']['tokens'].tolist()}")
    way = check_decode_graph(contig["gen"], "phase 3 contiguous decode")
    print_contiguous_modes(contig, "phase 3", card_line())
    print(f"  the contiguous Generator's {CONTIG['new']} tokens of "
          f"{CONTIG['b']} prompts equal between graph replays and run_eager;"
          f" {way}", flush=True)
    del contig, model
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
        way = check_graph(eng, f"phase 4 ({engine})")
        del eng
    for i, (a, b) in enumerate(zip(runs["auto"], runs["torch"])):
        if not np.array_equal(a, b):
            fail(f"request {i}: kernel path {a.tolist()} != plain path "
                 f"{b.tolist()}")
    print(f"  phi4-mini-3.8b full width, 2 layers, f32 (TF32 off): greedy "
          f"tokens of 8 requests equal between the kernel path and the "
          f"plain path, both with their {way.split(' (')[0]} (the plain "
          f"paged version captured too)", flush=True)


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
    return ("grouped expert FFN backward" if "ffn_bwd" in name
            else "grouped expert FFN" if "ffn_up" in name
            or "ffn_down" in name
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
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()      # the steps' own peak (phase 16)
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
    steps_peak = torch.cuda.max_memory_allocated()
    peak_gb = max(init_peak, steps_peak) / 1e9
    tok_s = b * s * 3 / sum(walls[2:])
    print(f"  5 steps: losses {[round(x, 4) for x in losses]}; after 2 "
          f"warm-up steps {sum(walls[2:]) / 3 * 1e3:.1f} ms per step = "
          f"{tok_s:.1f} tokens/s; peak device memory {peak_gb:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"reserved; {check_train_graph(step, 'phase 5', 4)}", flush=True)

    # where one step's time goes, replayed and from Python (steps 6-9,
    # outside the counts)
    train_step_modes(torch, step, opt,
                     [train_batch(torch, data, i) for i in range(5, 9)],
                     "one phi4-mini-3.8b training step")

    # prefill of 2 prompts of 1024 tokens through the same weights
    del opt, step, metrics
    torch.cuda.empty_cache()
    tokens = torch.from_numpy(data.global_batch_at(6)["tokens"]).cuda()
    model.prefill_sp({"tokens": tokens})                  # warm-up
    f0 = fa.FWD_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    pre_peak = torch.cuda.max_memory_allocated()
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
    return launches, {"loss0": losses[0], "tok_s": tok_s,
                      "ms": sum(walls[2:]) / 3 * 1e3,
                      "walls_ms": [w * 1e3 for w in walls],
                      "step_counts": counts, "steps_peak": steps_peak,
                      "prefill_ms": pre_ms, "prefill_peak": pre_peak,
                      "prefill_fwd": cfg.n_layers}


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
        loss, aux = model.loss_sp(train_batch(torch, data, 0))
        grads = torch.autograd.grad(
            loss, list(flatten_specs(model.params()).values()))
        grads = dict(zip(flatten_specs(model.params()), grads))
        # a live autograd graph keeps its parameters' AccumulateGrad nodes
        # on this (the legacy) stream, which the step's capture cannot
        # join
        loss0 = loss.item()
        del loss, aux
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
        graph_words = check_train_graph(step, f"phase 6 ({engine})", 2)
        upd = {k: (v.detach() - p0[k]) for k, v in
               flatten_specs(model.params()).items()}
        prompts = data.global_batch_at(9)["tokens"][:, :256]
        logits, _ = model.prefill_sp({"tokens": torch.from_numpy(
            prompts).cuda()})
        runs[engine] = dict(loss=loss0, grads=grads, losses=losses,
                            upd=upd, greedy=logits.argmax(-1).cpu(),
                            graph=graph_words)
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
          f"(relative norm, tolerance 1e-3); prefill greedy tokens equal; "
          f"both paths' {a['graph']}", flush=True)

    # the contiguous Generator against the paged ServeEngine, kernel model
    # (its decode steps as graph replays, and from Python through the
    # step's run_eager, as serve(..., eager=True) runs the paged engine's)
    prompts = data.global_batch_at(10)["tokens"][:, :96]
    shape = ShapeConfig("smoke", 256, prompts.shape[0], "decode")
    gen = Generator(kernel_model, shape)
    contiguous = gen.generate(prompts, 16)
    way = check_decode_graph(gen, "phase 6 contiguous Generator")
    eager_gen = Generator(kernel_model, shape)
    eager_gen.step.capture = eager_gen.step.replay = eager_gen.step.run_eager
    eager = eager_gen.generate(prompts, 16)
    del eager_gen.step.capture, eager_gen.step.replay, eager_gen, gen
    paged = Generator(kernel_model, shape, engine="paged",
                      page_size=16).generate(prompts, 16)
    if not np.array_equal(contiguous, eager):
        fail(f"contiguous Generator: graph replays {contiguous.tolist()} != "
             f"run_eager {eager.tolist()}")
    if not np.array_equal(contiguous, paged):
        fail(f"contiguous Generator {contiguous.tolist()} != paged engine "
             f"{paged.tolist()}")
    print(f"  Generator: the contiguous cache (graph replays and run_eager) "
          f"and the paged ServeEngine give the same {paged.shape[1]} greedy "
          f"tokens for {paged.shape[0]} prompts of {prompts.shape[1]}; "
          f"contiguous {way}", flush=True)

    # TrainLoop with an injected failure, checkpoints in a temporary dir
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        boom = {"armed": True}

        def fault(i):
            if i == 2 and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected failure")

        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
        step = build_train_step(kernel_model, opt_cfg)
        loop = TrainLoop(step, kernel_model, opt_cfg, data,
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
        # steps 0 and 1 on the first binding (one replay), step 2 on the
        # restored state's (its first: no replay)
        words = check_train_graph(step, "phase 6 TrainLoop", 1, 2)
        print(f"  TrainLoop: 3 steps, a failure at step 2 restored from "
              f"the step-2 checkpoint ({len(saves)} saves of "
              f"{saves[-1].nbytes / 1e9:.2f} GB, snapshot "
              f"{saves[-1].snapshot_s:.2f} s, drain {saves[-1].drain_s:.2f}"
              f" s, write {saves[-1].write_s:.2f} s); {wall:.1f} s in all; "
              f"{words}", flush=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del kernel_model, loop, opt, out, step
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
        model = decision.per_sweep_s.get(k if mode == "aggregated" else 1)
        line = (f"  {name}: {wall / iters * 1e3:.4f} ms per sweep "
                f"({wall:.3f} s host wall for {iters}; the H100 model "
                f"predicts {model * 1e3:.4f}), {moved / wall / 1e9:.1f}"
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


#: phase 8's prefill as measured, for phase 16: host wall, launches, the
#: rows the grouped calls kept and their capacity rows
MOE_MEASURED: dict = {}


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
    kept = []                      # rows the warm-up's calls keep
    cuda_call = gm.grouped_expert_ffn_cuda

    def spy(h, w1, w1_gate, w2, valid, mlp):
        kept.append((valid.clamp(0, h.shape[1]).sum(), h.shape[0] *
                     h.shape[1]))
        return cuda_call(h, w1, w1_gate, w2, valid, mlp)

    gm.grouped_expert_ffn_cuda = spy
    try:
        with managed.capture_decisions() as cap:
            model.prefill_sp({"tokens": tokens})             # warm-up
    finally:
        gm.grouped_expert_ffn_cuda = cuda_call
    torch.cuda.synchronize()
    gm.GROUPED_LAUNCHES = 0                      # counts of this run only
    gm.ENGINE_LAUNCHES.update(wgmma=0, simt=0)
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    launches = {"grouped": gm.GROUPED_LAUNCHES, "fwd": fa.FWD_LAUNCHES}
    if launches != {"grouped": cfg.n_layers, "fwd": cfg.n_layers}:
        fail(f"prefill launched {launches}, not {cfg.n_layers} of each")
    if gm.ENGINE_LAUNCHES != {"wgmma": cfg.n_layers, "simt": 0}:
        fail(f"the prefill's grouped launches by engine are "
             f"{gm.ENGINE_LAUNCHES}, not {cfg.n_layers} on the tensor cores")
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
          f", {launches['grouped']} grouped_expert_ffn (all on the "
          f"tensor-core engine) and "
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
    MOE_MEASURED.update(prefill_ms=pre_ms, launches=dict(launches),
                        kept_rows=sum(int(k) for k, _ in kept),
                        capacity_rows=sum(c for _, c in kept))

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
    way = check_graph(eng, "phase 8")
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
          f"{eng.decode_steps}; {way}", flush=True)
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
    """Step 4: moonshot at full width, 4 of its 48 layers, 3 steps (a
    capture and two graph replays), then one step replayed and one from
    Python, each timed bare and under the profiler."""
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
    gm.GROUPED_LAUNCHES = gm.GROUPED_BWD_LAUNCHES = 0
    gm.BWD_ENGINE_LAUNCHES.update(mma=0, simt=0)
    fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0

    def launches():
        return (gm.ENGINE_LAUNCHES["wgmma"], fa.FWD_LAUNCHES,
                fa.BWD_LAUNCHES, gm.GROUPED_LAUNCHES,
                gm.GROUPED_BWD_LAUNCHES, gm.BWD_ENGINE_LAUNCHES["mma"])

    for i in range(3):
        batch = train_batch(torch, data, i)
        c0 = launches()
        t0 = time.perf_counter()
        opt, metrics = step(opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(tuple(b - a for a, b in zip(c0, launches())))
    # grouped launches on the tensor-core engine, flash forward, flash
    # backward, grouped launches of either engine, grouped backward
    # launches of either engine and on the tensor cores
    want = (2 * cfg.n_layers, 2 * cfg.n_layers, cfg.n_layers,
            2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    if not all(np.isfinite(losses)):
        fail(f"non-finite MoE training loss: {losses}")
    if any(c != want for c in counts):
        fail(f"(grouped on the tensor cores, flash forward, flash "
             f"backward, grouped, grouped backward, grouped backward on the "
             f"tensor cores) launches per step {counts} != {want}")
    print(f"  moonshot-v1-16b-a3b full width, {cfg.n_layers} layers "
          f"({n_params / 1e9:.2f} B params, bf16, f32 AdamW moments, "
          f"remat), B={b}, S={s}: losses {[round(x, 4) for x in losses]}, "
          f"host wall per step {[round(w * 1e3, 1) for w in walls]} ms, "
          f"launches per step (grouped on the tensor cores, flash "
          f"forward, flash backward, grouped, grouped backward, grouped "
          f"backward on the tensor cores) {counts[0]}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; "
          f"{check_train_graph(step, 'phase 8', 2)}", flush=True)

    # where one step's time goes, replayed and from Python (steps 4-7,
    # outside the counts)
    train_step_modes(torch, step, opt,
                     [train_batch(torch, data, i) for i in range(3, 7)],
                     "one MoE training step")
    del model, opt, step, metrics
    torch.cuda.empty_cache()
    return sum(c[4] for c in counts)


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
            gm.GROUPED_LAUNCHES = gm.GROUPED_BWD_LAUNCHES = 0
            gaps.clear()
            with plain_spy() as spy:
                loss, _ = model.loss_sp(train_batch(torch, data, 0))
                leaves = flatten_specs(model.params())
                grads = dict(zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))))
                prompts = data.global_batch_at(9)["tokens"]
                logits, _ = model.prefill_sp({"tokens": torch.from_numpy(
                    prompts).cuda()})
            if engine == "auto":
                spy.check("phase 8 parity, the kernel path")
            want = (3 * cfg.n_layers, cfg.n_layers) if engine == "auto" \
                else (0, 0)
            if (gm.GROUPED_LAUNCHES, gm.GROUPED_BWD_LAUNCHES) != want:
                fail(f"{engine}: {gm.GROUPED_LAUNCHES} grouped and "
                     f"{gm.GROUPED_BWD_LAUNCHES} grouped backward launches "
                     f"for one loss, gradient and prefill, not {want}")
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
    with plain_spy() as spy:
        gen = Generator(kernel_model, shape)
        contiguous = gen.generate(prompts, 16)
        paged = Generator(kernel_model, shape, engine="paged",
                          page_size=16).generate(prompts, 16)
    spy.check("phase 8, the Generators")
    if not np.array_equal(contiguous, paged):
        fail(f"MoE contiguous Generator {contiguous.tolist()} != paged "
             f"engine {paged.tolist()}")
    print(f"  Generator: contiguous cache and paged ServeEngine give the "
          f"same {paged.shape[1]} greedy tokens for {paged.shape[0]} "
          f"prompts of {prompts.shape[1]}; contiguous "
          f"{check_decode_graph(gen, 'phase 8 contiguous Generator')}",
          flush=True)
    del gen
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
    gen_way = check_decode_graph(gen_tok, "phase 9 ring generation")
    print(f"  against megatron's prefill (flash forward kernel) of the same "
          f"tokens: last-token logits within {err:.3e} (tolerance "
          f"{RING_LOGIT_TOL} x {scale:.3g}), cache K/V identical up to "
          f"{kv_err:.1e}, same greedy token: {bool(same)}; {RING_NEW} greedy "
          f"tokens from the ring prefill's cache through the contiguous "
          f"Generator in {gen_s:.2f} s ({gen_way}): {new[0].tolist()}",
          flush=True)
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
          f"{cfg.n_layers}); {check_train_graph(step, 'phase 9 ring', 2)}",
          flush=True)
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
    print(f"  one ring training step (a graph replay) under "
          f"torch.profiler: {prof_ms:.1f} ms host wall, {dev_ms:.1f} ms "
          f"device time (busy share {dev_ms / prof_ms * 100:.1f}%)",
          flush=True)
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


# ---------------------------------------------------------------------------
# phase 10: the main-path examples
# ---------------------------------------------------------------------------

#: train_100m's run: steps, and the steps before its times are read
EXAMPLE_STEPS, EXAMPLE_WARMUP = 50, 5
#: the quickstart's run, and its attention: reduced granite-34b (4 query
#: heads, 1 kv head, head_dim 16) at B 8, S 128
QUICKSTART_STEPS = 30
QUICKSTART_ATTN = dict(b=8, s=128, h=4, kvh=1, hd=16)


def quickstart_kernels_vs_plain(torch):
    """The flash forward and backward kernels at the quickstart's
    attention (head_dim 16: the SIMT kernels in both types) against the
    plain versions in f32 on the same inputs: f32 within 1e-4 and bf16
    within 2e-2 of the largest magnitude, the lse within 1e-4.  Returns
    the worst error over both types."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    a = QUICKSTART_ATTN
    worst = 0.0
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q, k, v, dout = flash_inputs(torch, gen, a["b"], a["s"], a["s"],
                                     a["h"], a["kvh"], a["hd"], dtype)
        out, lse = fa.flash_attention_fwd(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        want_out, want_lse = fa.flash_attention_torch(q.float(), k.float(),
                                                      v.float())
        wants = fa.flash_attention_bwd_torch(q.float(), k.float(), v.float(),
                                             out.float(), lse, dout.float())
        for what, got, want, t in (
                ("out", out, want_out, tol), ("lse", lse, want_lse, 1e-4),
                ("dq", grads[0], wants[0], tol),
                ("dk", grads[1], wants[1], tol),
                ("dv", grads[2], wants[2], tol)):
            err = (got.float() - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            if not torch.isfinite(got.float()).all() or err > t * scale:
                fail(f"flash {what} at the quickstart's shape "
                     f"({str(dtype)[6:]}): max|err| {err:.3e} > {t} x "
                     f"{scale:.3g}")
            worst = max(worst, err / scale)
    return worst


def quickstart_parity(torch):
    """The quickstart's model (reduced granite-34b) in f32, TF32 off, at
    its batch (B 8, S 128): one loss and gradient with the flash kernels
    and with the plain versions pinned agree (``check_loss_and_grads``),
    with exactly 2 x n_layers forward (remat) and n_layers backward
    launches on the kernel path.  Returns the worst gradient error."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model, flatten_specs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_reduced("granite-34b"),
                              dtype="float32")
    a = QUICKSTART_ATTN
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=a["s"], global_batch=a["b"],
                                      seed=SEED))
    batch = train_batch(torch, data, 0)
    runs = {}
    for engine in ("auto", "torch"):
        model = Model(cfg, device="cuda", attn_engine=engine).init(
            torch.Generator(device="cuda").manual_seed(SEED))
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        loss, _ = model.loss_sp(batch)
        params = flatten_specs(model.params())
        grads = torch.autograd.grad(loss, list(params.values()))
        want = (2 * cfg.n_layers, cfg.n_layers) if engine == "auto" \
            else (0, 0)
        if (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) != want:
            fail(f"quickstart model ({engine}): flash launches "
                 f"{fa.FWD_LAUNCHES} / {fa.BWD_LAUNCHES}, not {want}")
        runs[engine] = dict(loss=loss.item(), grads=dict(zip(params, grads)))
    return check_loss_and_grads(runs["auto"], runs["torch"],
                                "quickstart model")[0]


def phase_examples(torch, card):
    """quickstart (30 steps of reduced granite, 8 greedy tokens) and
    train_100m (110 M parameters, S 256, B 8, async checkpoints) on the
    card; each run's flash launches counted from 0 and held exact, and
    the quickstart's kernels and model held to the plain versions."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.examples import quickstart, train_100m
    from repro_torch.kernels import flash_attention as fa

    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    launches = {}
    try:
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        with kept_train_steps(quickstart) as made:
            out = quickstart.run(QUICKSTART_STEPS, device="cuda",
                                 ckpt_dir=os.path.join(tmp, "quickstart"))
        qs_s = time.perf_counter() - t0
        qs_graph = check_train_graph(made[0], "quickstart",
                                     QUICKSTART_STEPS - 1)
        losses = [h["loss"] for h in out["history"]]
        got = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
        n_layers = configs.get_reduced("granite-34b").n_layers
        # training runs each layer's forward twice (remat) and its
        # backward once; the greedy decode's contiguous cache runs no
        # flash kernel, as the reference's decode reaches no Pallas one
        want = (QUICKSTART_STEPS * 2 * n_layers, QUICKSTART_STEPS * n_layers)
        if (len(losses) != QUICKSTART_STEPS or not all(np.isfinite(losses))
                or losses[-1] >= losses[0] or out["restarts"]):
            fail(f"quickstart losses {losses}, {out['restarts']} restarts: "
                 f"not {QUICKSTART_STEPS} finite, falling, unbroken")
        if len(out["continuation"]) != 8 or got != want:
            fail(f"quickstart: continuation {out['continuation']}, flash "
                 f"launches {got} (want {want})")
        worst_k = quickstart_kernels_vs_plain(torch)
        worst_p = quickstart_parity(torch)
        print(f"  quickstart (reduced granite-34b, bf16, head_dim 16): loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f} over {QUICKSTART_STEPS} "
              f"steps (0 restarts), greedy continuation "
              f"{out['continuation']}, flash launches {got[0]} forward / "
              f"{got[1]} backward, {qs_s:.1f} s; its flash kernels against "
              f"the plain versions (f32 and bf16) worst {worst_k:.2e} of "
              f"the largest magnitude; its model in f32, kernels against "
              f"plain: loss within 1e-5, gradients within {worst_p:.2e}; "
              f"its {qs_graph}", flush=True)
        launches["quickstart"] = got

        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        ckpt = os.path.join(tmp, "train_100m")
        with kept_train_steps(train_100m) as made:
            out = train_100m.main(["--steps", str(EXAMPLE_STEPS), "--ckpt",
                                   ckpt])
        step = made[0]
        hist = out["history"]
        losses = [h["loss"] for h in hist]
        n_layers = train_100m.CONFIG_100M.n_layers
        want = (EXAMPLE_STEPS * 2 * n_layers, EXAMPLE_STEPS * n_layers)
        got = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
        if len(losses) != EXAMPLE_STEPS or not all(np.isfinite(losses)):
            fail(f"train_100m losses {losses}")
        if got != want or not os.listdir(ckpt):
            fail(f"train_100m: flash launches {got} (want {want}), "
                 f"checkpoints {os.listdir(ckpt)}")
        tm_graph = check_train_graph(step, "train_100m", EXAMPLE_STEPS - 1)
        walls = sorted(h["time_s"] for h in hist[EXAMPLE_WARMUP:])
        med = walls[len(walls) // 2]
        tokens = 8 * 256
        print(f"  train_100m ({train_100m.CONFIG_100M.param_count() / 1e6:.0f}"
              f" M params, bf16, S 256, B 8, 1x1, async checkpoints every "
              f"50 steps): host wall per step median {med * 1e3:.2f} ms "
              f"(min {walls[0] * 1e3:.2f}, max {walls[-1] * 1e3:.2f}) over "
              f"steps {EXAMPLE_WARMUP}-{EXAMPLE_STEPS - 1} = "
              f"{tokens / med:.0f} tokens/s; loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; flash launches {got[0]} forward / {got[1]} "
              f"backward; {tm_graph}; on {card}", flush=True)
        launches["train_100m"] = got
        # one step replayed and one from Python, on the trained state
        data = SyntheticLMData(DataConfig(
            vocab_size=train_100m.CONFIG_100M.vocab_size, seq_len=256,
            global_batch=8))
        train_step_modes(torch, step, out["opt"],
                         [train_batch(torch, data, EXAMPLE_STEPS + i)
                          for i in range(4)], "one train_100m step")
        del step, made, out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 11: two ranks on the one card
# ---------------------------------------------------------------------------

#: phi4-mini at full width, this many layers, f32; one train step's batch
MESH_LAYERS, MESH_B, MESH_S = 2, 2, 1024
MESH_SPECS = ("1x2", "2x1")
MESH_SERVE = dict(slots=2, max_seq=64, page_size=16, schedule="static")
MESH_NEW = 8
MESH_LOSS_RTOL, MESH_RTOL, MESH_ATOL = 2e-4, 2e-3, 3e-4
#: the gradient norm against 1x1's: the first AdamW update hardly depends
#: on the gradients' scale, so the norm holds their sums over the mesh
MESH_NORM_RTOL = 1e-5


def mesh_prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED + 11)
    return [rng.integers(0, vocab - 1, size=p).astype(np.int32)
            for p in (5, 9, 3)]


def mesh_rank_main(rank: int, init: str, out_dir: str) -> None:
    """One of phase 11's two processes.  Rank 0 first runs the 1x1
    reference (a train step and the engine's greedy tokens) on the full
    weights; then both ranks run each mesh on their shards of the same
    weights and rank 0 holds the gathered parameters, the loss and the
    tokens to the 1x1 run.  Results go to rank{r}.json."""
    import torch
    import torch.distributed as dist

    from repro_torch import bridge, configs
    from repro_torch.core import transport
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import MeshCtx, shard_of
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.train_loop import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch_mesh.init_distributed("cuda", init_method=init, rank=rank,
                                 world_size=2)
    cfg = dataclasses.replace(configs.get_config("phi4-mini-3.8b"),
                              n_layers=MESH_LAYERS, dtype="float32")
    full = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=MESH_S, global_batch=MESH_B,
                                      seed=SEED))
    batch = train_batch(torch, data, 0)
    opt_cfg = AdamWConfig(lr=1e-2)
    prompts = mesh_prompts(cfg.vocab_size)
    res = {"rank": rank}

    def serve(model):
        eng = ServeEngine(model, **MESH_SERVE)
        rids = [eng.submit(p, MESH_NEW) for p in prompts]
        got = eng.run()
        res.setdefault("modes", []).append(eng.quantum_mode)
        return [got[r].tolist() for r in rids]

    def step(model):
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        transport.reset_staged_bytes()
        fn = build_train_step(model, opt_cfg)
        opt = adamw_init(model.params(), opt_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = eager_step(fn, opt, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        return dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                    ms=(time.perf_counter() - t0) * 1e3,
                    fwd=fa.FWD_LAUNCHES, bwd=fa.BWD_LAUNCHES,
                    staged=transport.staged_bytes(), mode=fn.step_mode)

    one = None
    spy = plain_spy().__enter__()
    if rank == 0:
        paged.LAUNCHES = 0
        res["one_tokens"] = serve(full)
        res["one_paged"] = paged.LAUNCHES
        one = Model(cfg, device="cuda")
        with torch.no_grad():
            for name, t in flatten_specs(one.params()).items():
                t.copy_(flatten_specs(full.params())[name])
        res["one"] = step(one)
    dist.barrier()
    specs = flatten_specs(full.param_specs())
    for spec in MESH_SPECS:
        shape, axes = launch_mesh.parse_mesh(spec)
        ctx = MeshCtx.from_mesh(launch_mesh.make_mesh(shape, axes, "cuda"),
                                "auto")
        model = Model(cfg, ctx, device="cuda")
        with torch.no_grad():
            for name, t in flatten_specs(model.params()).items():
                t.copy_(shard_of(flatten_specs(full.params())[name],
                                 specs[name], ctx))
        if spec == "1x2":
            paged.LAUNCHES = 0
            res[f"{spec}_tokens"] = serve(model)
            res[f"{spec}_paged"] = paged.LAUNCHES
        res[spec] = step(model)
        worst = (0.0, "")
        for name in flatten_specs(model.params()):
            got = bridge.param_full(model, name)
            if rank == 0:
                want = flatten_specs(one.params())[name]
                bad = (got - want).abs() - MESH_RTOL * want.abs()
                worst = max(worst, (float(bad.max()), name))
        res[f"{spec}_worst"] = worst
        del model, ctx
        torch.cuda.empty_cache()
    spy.__exit__(None, None, None)
    res["plain_hits"] = spy.hits
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


def phase_mesh(torch, root, card):
    """Phase 11: the two rank processes, then jacobi_mdmp --ranks 2,
    each on the one card over gloo.  A failure in either process fails
    the phase."""
    t0 = time.perf_counter()
    res = run_rank_pair("--mesh-rank", "phase 11", 600)
    one = res[0]["one"]
    want = (2 * MESH_LAYERS, MESH_LAYERS)
    print(f"  phi4-mini-3.8b at full width, {MESH_LAYERS} layers, f32, TF32 "
          f"off, B={MESH_B}, S={MESH_S}; two processes on {card}, gloo "
          f"(file:// init); 1x1 on rank 0: loss {one['loss']:.6f}, step "
          f"{one['ms']:.1f} ms, flash launches {one['fwd']} / {one['bwd']}",
          flush=True)
    if (one["fwd"], one["bwd"]) != want or res[0]["one_paged"] == 0:
        fail(f"the 1x1 run's launches: flash {one['fwd']} / {one['bwd']} "
             f"(want {want}), paged {res[0]['one_paged']}")
    launches = {"fwd": 0, "bwd": 0,
                "paged_partials": res[0]["1x2_paged"] + res[1]["1x2_paged"]}
    for spec in MESH_SPECS:
        for r in range(2):
            got = res[r][spec]
            if (got["fwd"], got["bwd"]) != want:
                fail(f"{spec} rank {r}: flash launches {got['fwd']} / "
                     f"{got['bwd']}, not {want}")
            if abs(got["loss"] - one["loss"]) > MESH_LOSS_RTOL * abs(
                    one["loss"]):
                fail(f"{spec} rank {r}: loss {got['loss']} != 1x1 "
                     f"{one['loss']} (rtol {MESH_LOSS_RTOL})")
            norm_err = abs(got["grad_norm"] - one["grad_norm"]) / abs(
                one["grad_norm"])
            if norm_err > MESH_NORM_RTOL:
                fail(f"{spec} rank {r}: grad_norm {got['grad_norm']} != 1x1 "
                     f"{one['grad_norm']} (rtol {MESH_NORM_RTOL})")
            launches["fwd"] += got["fwd"]
            launches["bwd"] += got["bwd"]
        bad, name = res[0][f"{spec}_worst"]
        if bad > MESH_ATOL:
            fail(f"{spec}: updated parameter {name} off the 1x1 step by "
                 f"{bad:.3e} beyond rtol {MESH_RTOL} (atol {MESH_ATOL})")
        print(f"  {spec} mesh: loss {res[0][spec]['loss']:.6f} on both "
              f"ranks (1x1 {one['loss']:.6f}); grad_norm "
              f"{res[0][spec]['grad_norm']!r} (1x1 {one['grad_norm']!r}, "
              f"within rtol {MESH_NORM_RTOL}); every updated parameter, "
              f"gathered, within rtol {MESH_RTOL} / atol {MESH_ATOL} of "
              f"1x1 (worst excess {bad:.2e} at {name}); flash launches per "
              f"rank {want[0]} / {want[1]}; step host wall "
              f"{res[0][spec]['ms']:.1f} / {res[1][spec]['ms']:.1f} ms; "
              f"bytes between the card and host memory per step (gloo on "
              f"one card, not NCCL: staged messages and gloo's own copies "
              f"of all-reduces) {res[0][spec]['staged']} / "
              f"{res[1][spec]['staged']}", flush=True)
    quantum = mesh_modes(res, "phase 11")
    print(f"  {mesh_step_modes(res, MESH_SPECS, 'phase 11')}", flush=True)
    for r in range(2):
        if res[r]["1x2_tokens"] != res[0]["one_tokens"]:
            fail(f"1x2 rank {r} greedy tokens {res[r]['1x2_tokens']} != "
                 f"1x1 {res[0]['one_tokens']}")
        if not res[r]["1x2_paged"] > 0:
            fail(f"1x2 rank {r}: the sharded paged decode launched the "
                 f"paged kernel {res[r]['1x2_paged']} times")
        if res[r]["plain_hits"]:
            fail(f"phase 11 rank {r}: a plain version was handed CUDA "
                 f"tensors: {res[r]['plain_hits']}")
    print(f"  ServeEngine on 1x2 (the page pool over 2 cache shards, the "
          f"paged kernel's partials of each shard LSE-merged; paged kernel "
          f"launches {res[0]['1x2_paged']} / {res[1]['1x2_paged']} by "
          f"rank; {quantum}): greedy tokens equal 1x1's (paged kernel, "
          f"{res[0]['one_paged']} launches): {res[0]['one_tokens']}; no "
          f"plain version handed a CUDA tensor on either rank", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    jac = subprocess.run([sys.executable, "-m",
                          "repro_torch.examples.jacobi_mdmp", "--ranks", "2"],
                         env=env, capture_output=True, text=True, timeout=600)
    if jac.returncode != 0 or "== one rank" not in jac.stdout:
        fail(f"jacobi_mdmp --ranks 2 on the card: {jac.stdout[-2000:]} "
             f"{jac.stderr[-2000:]}")
    for line in jac.stdout.splitlines():
        print(f"  jacobi_mdmp --ranks 2: {line}", flush=True)
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 12: MoE across ranks on the one card
# ---------------------------------------------------------------------------

#: moonshot at full width, this many layers, f32; one train step's batch
MOE_MESH_LAYERS, MOE_MESH_B, MOE_MESH_S = 2, 2, 512
#: capacity factor above E / top_k = 10.67: every expert's capacity covers
#: every local token, so no rank drops a token and 1x2 computes 1x1's
#: function
MOE_MESH_CF = 11.0
#: (name, layout, dispatch, g) of the 1x2 runs
MOE_MESH_RUNS = (("ep_bulk", "ep_a2a", "bulk", 0),
                 ("ep_stream", "ep_a2a", "stream", 2),
                 ("expert_tp", "expert_tp", "bulk", 0))
MOE_MESH_RTOL = 1e-5


def moe_mesh_cfg(layout: str, dispatch: str, g: int, dtype: str):
    from repro_torch import configs
    cfg = configs.get_config("moonshot-v1-16b-a3b")
    return dataclasses.replace(
        cfg, n_layers=MOE_MESH_LAYERS, dtype=dtype,
        moe=dataclasses.replace(cfg.moe, impl=layout, dispatch=dispatch,
                                dispatch_g=g, capacity_factor=MOE_MESH_CF))


def moe_grouped_calls(layout: str, dispatch: str, g: int) -> int:
    """Grouped-kernel launches of one layer's forward on one of 2 ranks:
    the stream runs g chunks at each of its 2 ring steps."""
    return 2 * g if dispatch == "stream" else 1


def moe_mesh_rank_main(rank: int, init: str, out_dir: str) -> None:
    """One of phase 12's two processes.  Rank 0 first runs the 1x1 step
    and the engine on the full f32 weights; then both ranks run each 1x2
    layout and dispatch on their shards of the same weights, and a bf16
    prefill per layout whose first grouped call is held to the plain
    version at its shard shape.  Results go to rank{r}.json."""
    import torch
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.core import managed, transport
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import MeshCtx, shard_of
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.train_loop import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch_mesh.init_distributed("cuda", init_method=init, rank=rank,
                                 world_size=2)
    base = moe_mesh_cfg("ep_a2a", "bulk", 0, "float32")
    full = Model(base, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    data = SyntheticLMData(DataConfig(vocab_size=base.vocab_size,
                                      seq_len=MOE_MESH_S,
                                      global_batch=MOE_MESH_B, seed=SEED))
    batch = train_batch(torch, data, 0)
    opt_cfg = AdamWConfig(lr=1e-2)
    prompts = mesh_prompts(base.vocab_size)
    res = {"rank": rank}

    def serve(model):
        eng = ServeEngine(model, **MESH_SERVE)
        rids = [eng.submit(p, MESH_NEW) for p in prompts]
        got = eng.run()
        res.setdefault("modes", []).append(eng.quantum_mode)
        return [got[r].tolist() for r in rids]

    def step(model):
        gm.GROUPED_LAUNCHES = gm.GROUPED_BWD_LAUNCHES = 0
        gm.ENGINE_LAUNCHES.update(wgmma=0, simt=0)
        gm.BWD_ENGINE_LAUNCHES.update(mma=0, simt=0)
        transport.reset_staged_bytes()
        fn = build_train_step(model, opt_cfg)
        opt = adamw_init(model.params(), opt_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with managed.capture_decisions() as cap:
            _, metrics = eager_step(fn, opt, batch)
            loss = float(metrics["loss"])
        torch.cuda.synchronize()
        recs = [r for r in cap.records
                if r.op in ("moe_dispatch", "expert_stream")]
        return dict(loss=loss, grad_norm=float(metrics["grad_norm"]),
                    ms=(time.perf_counter() - t0) * 1e3,
                    grouped=gm.GROUPED_LAUNCHES,
                    engines=dict(gm.ENGINE_LAUNCHES),
                    bwd=gm.GROUPED_BWD_LAUNCHES,
                    bwd_engines=dict(gm.BWD_ENGINE_LAUNCHES),
                    staged=transport.staged_bytes(), mode=fn.step_mode,
                    decisions=[f"{r.op}({r.mode}, g={r.chunks}, "
                               f"{r.nbytes} B)" for r in recs])

    def copy_shards(model, ctx):
        specs = flatten_specs(model.param_specs())
        with torch.no_grad():
            for name, t in flatten_specs(model.params()).items():
                t.copy_(shard_of(full_host[name], specs[name], ctx))

    def halves_router(x, w, n_experts, top_k):
        """The router with the load-balance term of ep_a2a over two ranks:
        the mean of the terms of each row's two sequence halves (the
        tokens [B, S] flattened row-major), the same function as a 1x2
        ep_a2a step computes."""
        gates, idx, _ = real_router(x, w, n_experts, top_k)
        xs = x.reshape(MOE_MESH_B, -1, x.shape[-1])
        half = xs.shape[1] // 2
        aux = [real_router(xs[:, r * half:(r + 1) * half].reshape(
            -1, x.shape[-1]), w, n_experts, top_k)[2] for r in range(2)]
        return gates, idx, (aux[0] + aux[1]) / 2

    real_router = moe._router
    one = {}
    spy = plain_spy().__enter__()
    if rank == 0:
        paged.LAUNCHES = 0
        res["one_tokens"] = serve(full)
        res["one_paged"] = paged.LAUNCHES
    # the full weights wait in host memory: the card holds both ranks
    full_host = {k: v.detach().cpu() for k, v in
                 flatten_specs(full.params()).items()}
    del full
    torch.cuda.empty_cache()
    if rank == 0:
        # 1x1 as it is (expert_tp's function), and with ep_a2a's
        # rank-averaged load-balance term (the ep runs' function)
        for which in ("one", "one_ep"):
            model = Model(base, device="cuda")
            copy_shards(model, model.ctx)
            moe._router = halves_router if which == "one_ep" else real_router
            try:
                res[which] = step(model)
            finally:
                moe._router = real_router
            # the updated parameters wait in host memory, and the cached
            # blocks go back to the card, which rank 1 shares
            one[which] = {k: v.detach().cpu() for k, v in
                          flatten_specs(model.params()).items()}
            del model
            torch.cuda.empty_cache()
    dist.barrier()
    mesh = launch_mesh.make_mesh((1, 2), ("data", "model"), "cuda")
    for name, layout, dispatch, g in MOE_MESH_RUNS:
        ctx = MeshCtx.from_mesh(mesh, "auto")
        model = Model(moe_mesh_cfg(layout, dispatch, g, "float32"), ctx,
                      device="cuda")
        copy_shards(model, ctx)
        if name == "ep_bulk":
            paged.LAUNCHES = 0
            res["mesh_tokens"] = serve(model)
            res["mesh_paged"] = paged.LAUNCHES
        res[name] = step(model)
        worst = (0.0, "")
        ref = "one_ep" if layout == "ep_a2a" else "one"
        for pname in flatten_specs(model.params()):
            got = bridge.param_full(model, pname)
            if rank == 0:
                want = one[ref][pname].to(got.device)
                bad = (got - want).abs() - MESH_RTOL * want.abs()
                worst = max(worst, (float(bad.max()), pname))
        res[f"{name}_worst"] = worst
        del model
        torch.cuda.empty_cache()
    del full_host, one
    spy.__exit__(None, None, None)
    res["plain_hits"] = spy.hits

    # bf16 prefills: every grouped launch on the tensor cores, and the
    # first call's shard-shaped inputs through the kernel and the plain
    # version
    rng = np.random.default_rng(SEED + 12)
    tokens = torch.from_numpy(rng.integers(
        0, base.vocab_size - 1, size=(MOE_MESH_B, MOE_MESH_S)).astype(
        np.int32)).cuda()
    seen = []
    real_ffn = moe._expert_ffn

    def spy(h, w1, w1g, w2, mlp, valid, engine):
        if not seen:
            seen.append((h, w1, w1g, w2, valid, mlp))
        return real_ffn(h, w1, w1g, w2, mlp, valid, engine)

    moe._expert_ffn = spy
    try:
        for name, layout, dispatch, g in MOE_MESH_RUNS:
            cfg = moe_mesh_cfg(layout, dispatch, g, "bfloat16")
            model = Model(cfg, MeshCtx.from_mesh(mesh, "auto"),
                          device="cuda").init(
                torch.Generator(device="cuda").manual_seed(SEED + rank))
            seen.clear()
            gm.GROUPED_LAUNCHES = 0
            gm.ENGINE_LAUNCHES.update(wgmma=0, simt=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill_sp(model.ctx.shard_batch(
                {"tokens": tokens}))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            engines = dict(gm.ENGINE_LAUNCHES)
            h, w1, w1g, w2, valid, mlp = seen[0]
            err, rel, share = grouped_call(
                torch, gm, h, w1, w1g, w2, valid, mlp,
                dict(GROUPED_TOL)["bfloat16"], f"{name} bf16 prefill")
            res[f"{name}_bf16"] = dict(
                engines=engines, ms=ms, err=err, rel=rel, share=share,
                shape=[list(h.shape), list(w1.shape), list(w2.shape)],
                finite=bool(torch.isfinite(logits).all()))
            del model, logits, seen[:]
            torch.cuda.empty_cache()
    finally:
        moe._expert_ffn = real_ffn
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


def eager_step(fn, opt, batch):
    """One training step issued from Python whatever ``fn``'s mode: where
    it would be captured (a card, every axis of size 1), through its
    ``run_eager`` over its static buffers.  The two-rank phases' 1x1
    oracles run so, beside their meshes' eager steps."""
    if fn.step_mode == "graph":
        fn.load(opt, batch)
        return opt, fn.run_eager()
    return fn(opt, batch)


def mesh_step_modes(res: list[dict], keys, what: str) -> str:
    """Fail unless every training step of a two-rank phase's meshes ran
    eager (its collectives go through gloo and host buffers, which a
    graph cannot hold); returns the words that say so."""
    bad = [(r, k, res[r][k]["mode"]) for r in range(2) for k in keys
           if res[r][k]["mode"] != "eager"]
    if bad:
        fail(f"{what}: training steps ran {bad}, not eager")
    return ("the training steps on the 2-rank meshes eager (gloo), the 1x1 "
            "oracle from Python through run_eager")


def mesh_modes(res: list[dict], what: str) -> str:
    """The engines' ways of running a quantum in a two-rank phase: rank
    0's 1x1 engine replays its graph, every 1x2 engine runs the step from
    Python (its collectives go through gloo and host buffers)."""
    want = [["graph", "eager"], ["eager"]]
    got = [r["modes"] for r in res]
    if got != want:
        fail(f"{what}: the engines ran their quanta {got}, not {want}")
    return "1x1 quanta as graph replays, 1x2 eager (gloo)"


def run_rank_pair(flag: str, what: str, timeout: int) -> list[dict]:
    """Start this script twice with ``flag`` (ranks 0 and 1, file://
    init); a failure in either fails ``what``.  Returns their results.
    This process first hands its cached blocks back to the card, which
    the two ranks share with it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"of the card ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated) while the two ranks run", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        init = "file://" + os.path.join(tmp, "init")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(r), init,
             tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        bad = [f"{what} rank {r} exited {p.returncode}: {err[-3000:]}"
               for r, (p, (_, err)) in enumerate(zip(procs, outs))
               if p.returncode != 0]
        if bad:
            fail("\n".join(bad))
        res = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                res.append(json.load(fh))
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_moe_mesh(torch, card):
    """Phase 12: moonshot's MoE over a 1x2 mesh of two processes on the
    one card (gloo), held to rank 0's 1x1 run."""
    t0 = time.perf_counter()
    res = run_rank_pair("--moe-mesh-rank", "phase 12", 900)
    one = res[0]["one"]
    per_step = 2 * MOE_MESH_LAYERS          # forward and its remat replay
    print(f"  moonshot-v1-16b-a3b at full width (d 2048, 64 experts top-6, "
          f"F 1408, vocab 163840), {MOE_MESH_LAYERS} layers, f32, TF32 off, "
          f"capacity factor {MOE_MESH_CF} (no token dropped), B="
          f"{MOE_MESH_B}, S={MOE_MESH_S}; two processes on {card}, gloo; "
          f"1x1 on rank 0: loss {one['loss']!r}, grad_norm "
          f"{one['grad_norm']!r}, step {one['ms']:.1f} ms, grouped launches "
          f"{one['grouped']} {one['engines']}, backward {one['bwd']} "
          f"{one['bwd_engines']}; {one['decisions']}; no plain version "
          f"handed a CUDA tensor on either rank", flush=True)
    for which in ("one", "one_ep"):
        got = res[0][which]
        if (got["grouped"], got["bwd"], got["bwd_engines"]["simt"]) != (
                per_step, MOE_MESH_LAYERS, MOE_MESH_LAYERS):
            fail(f"1x1 ({which}) grouped launches {got['grouped']}, backward "
                 f"{got['bwd']} {got['bwd_engines']}: not {per_step} and "
                 f"{MOE_MESH_LAYERS} on SIMT")
    for r in range(2):
        if res[r]["plain_hits"]:
            fail(f"phase 12 rank {r}: a plain version was handed CUDA "
                 f"tensors: {res[r]['plain_hits']}")
    one_ep = res[0]["one_ep"]
    print(f"  1x1 with ep_a2a's load-balance term (the mean of the two "
          f"sequence halves' terms, as two ranks compute it): loss "
          f"{one_ep['loss']!r}, grad_norm {one_ep['grad_norm']!r}",
          flush=True)
    for name, layout, dispatch, g in MOE_MESH_RUNS:
        want = per_step * moe_grouped_calls(layout, dispatch, g)
        ref = one_ep if layout == "ep_a2a" else one
        for r in range(2):
            got = res[r][name]
            if got["grouped"] != want or got["engines"]["wgmma"]:
                fail(f"{name} rank {r}: grouped launches {got['grouped']} "
                     f"{got['engines']}, not {want} on SIMT")
            # one backward for each forward call; the remat replay has none
            if got["bwd"] != want // 2 or got["bwd_engines"]["mma"]:
                fail(f"{name} rank {r}: grouped backward launches "
                     f"{got['bwd']} {got['bwd_engines']}, not {want // 2} "
                     f"on SIMT")
            for key in ("loss", "grad_norm"):
                if abs(got[key] - ref[key]) > MOE_MESH_RTOL * abs(ref[key]):
                    fail(f"{name} rank {r}: {key} {got[key]!r} != 1x1 "
                         f"{ref[key]!r} (rtol {MOE_MESH_RTOL})")
            n_stream = sum(d.startswith("expert_stream") for d in
                           got["decisions"])
            if n_stream != (per_step if dispatch == "stream" else 0):
                fail(f"{name} rank {r}: {n_stream} expert_stream decisions")
        oracle = ("1x1 with the halves' load-balance term"
                  if layout == "ep_a2a" else "1x1")
        bad, pname = res[0][f"{name}_worst"]
        if bad > MESH_ATOL:
            fail(f"{name}: updated parameter {pname} off the 1x1 step by "
                 f"{bad:.3e} beyond rtol {MESH_RTOL} (atol {MESH_ATOL})")
        print(f"  1x2 {name} ({layout}, {dispatch}"
              f"{f', g={g}' if g else ''}): loss "
              f"{res[0][name]['loss']!r} / {res[1][name]['loss']!r}, "
              f"grad_norm {res[0][name]['grad_norm']!r} / "
              f"{res[1][name]['grad_norm']!r} ({oracle} within rtol "
              f"{MOE_MESH_RTOL}); updated parameters gathered within rtol "
              f"{MESH_RTOL} / atol {MESH_ATOL} (worst excess {bad:.2e} at "
              f"{pname}); grouped launches per rank {want}, backward "
              f"{want // 2} (SIMT, f32); "
              f"step host wall {res[0][name]['ms']:.1f} / "
              f"{res[1][name]['ms']:.1f} ms; bytes between card and host "
              f"per step {res[0][name]['staged']} / "
              f"{res[1][name]['staged']}; rank 0 decisions "
              f"{sorted(set(res[0][name]['decisions']))} "
              f"(x{len(res[0][name]['decisions'])})", flush=True)
    quantum = mesh_modes(res, "phase 12")
    runs = [name for name, *_ in MOE_MESH_RUNS]
    print(f"  {mesh_step_modes(res, runs, 'phase 12')}", flush=True)
    for r in range(2):
        if res[r]["mesh_tokens"] != res[0]["one_tokens"]:
            fail(f"1x2 rank {r} greedy tokens {res[r]['mesh_tokens']} != "
                 f"1x1 {res[0]['one_tokens']}")
    print(f"  ServeEngine on 1x2 (ep_a2a, the experts' gate columns per "
          f"rank, summed over 'model'; paged launches "
          f"{res[0]['mesh_paged']}; {quantum}): greedy tokens equal 1x1's "
          f"({res[0]['one_paged']} paged launches): "
          f"{res[0]['one_tokens']}", flush=True)
    worst = 0.0
    for name, layout, dispatch, g in MOE_MESH_RUNS:
        want = MOE_MESH_LAYERS * moe_grouped_calls(layout, dispatch, g)
        for r in range(2):
            b = res[r][f"{name}_bf16"]
            if b["engines"] != {"wgmma": want, "simt": 0} or not b["finite"]:
                fail(f"{name} bf16 prefill rank {r}: grouped launches "
                     f"{b['engines']} (want {want} on the tensor cores), "
                     f"finite logits {b['finite']}")
            worst = max(worst, b["err"])
        b = res[0][f"{name}_bf16"]
        print(f"  bf16 prefill 1x2 {name}: {want} grouped launches per rank "
              f"on the tensor cores; first call at h {b['shape'][0]}, w1 "
              f"{b['shape'][1]}, w2 {b['shape'][2]} against the plain "
              f"version: max|err| {b['err']:.3e} / "
              f"{res[1][f'{name}_bf16']['err']:.3e} (tolerance "
              f"{dict(GROUPED_TOL)['bfloat16']} x max|want|), f32 down "
              f"product off by {b['rel']:.2e}, bf16 output equal on "
              f"{b['share']:.4f}; prefill host wall {b['ms']:.1f} / "
              f"{res[1][f'{name}_bf16']['ms']:.1f} ms", flush=True)
    print(f"  phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)
    return worst


# ---------------------------------------------------------------------------
# phase 13: the SSM, hybrid, audio and vision families on one card
# ---------------------------------------------------------------------------

#: (what, B, Sq, Skv, H, KV, hd, causal, window): flash at the families'
#: new shapes — hymba's 1024 window over 2048 positions (its heads padded
#: 25 -> 32, kv 5 -> 8), whisper's non-causal encoder over 1500 frames (a
#: ragged length) and its cross-attention of 448 positions over them,
#: internvl's GQA 16/2; hd 64 (the tensor-core kernels) and hd 16 (the
#: reduced configs')
FAMILY_FLASH = [
    ("hymba window", 2, 2048, 2048, 32, 8, 64, True, 1024),
    ("whisper encoder", 2, 1500, 1500, 16, 16, 64, False, 0),
    ("whisper cross", 2, 448, 1500, 16, 16, 64, False, 0),
    ("internvl", 2, 1024, 1024, 16, 2, 64, True, 0),
    ("reduced hymba window", 2, 64, 64, 4, 2, 16, True, 16),
    ("reduced whisper cross", 2, 12, 16, 4, 4, 16, False, 0),
]
FAM_NEW = 16
FAM_TRAIN_S = 2048
#: the long prompt of hymba's 2-layer paged check: past its 1024 window
HYMBA_LONG_PROMPT = 1100


def family_flash_checks(torch) -> float:
    """The flash kernels (forward and backward) against the plain
    versions at FAMILY_FLASH, f32 at 1e-4 and bf16 at 2e-2 of the largest
    magnitude, as phase 2; returns the worst bf16 error."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    worst = 0.0
    for what, b, sq, skv, h, kvh, hd, causal, window in FAMILY_FLASH:
        line = []
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            q, k, v, dout = flash_inputs(torch, gen, b, sq, skv, h, kvh, hd,
                                         dtype)
            kw = dict(causal=causal, window=window)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            grads = fa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            want_out, _ = fa.flash_attention_torch(q.float(), k.float(),
                                                   v.float(), **kw)
            wants = fa.flash_attention_bwd_torch(
                q.float(), k.float(), v.float(), out.float(), lse,
                dout.float(), **kw)
            for name, got, want in (("out", out, want_out),
                                    ("dq", grads[0], wants[0]),
                                    ("dk", grads[1], wants[1]),
                                    ("dv", grads[2], wants[2])):
                err = (got.float() - want).abs().max().item()
                scale = max(1.0, want.abs().max().item())
                if not err <= tol * scale:
                    fail(f"flash {name} at {what} ({str(dtype)[6:]}): "
                         f"max|err| {err:.3e} > {tol} x {scale:.3g}")
                if dtype == torch.bfloat16:
                    worst = max(worst, err)
                line.append(f"{str(dtype)[6:]} {name} {err:.1e}")
        print(f"  flash kernels vs plain at {what} (B={b}, Sq={sq}, Skv={skv},"
              f" H={h}, KV={kvh}, hd={hd}, causal={causal}, window={window})"
              f": {', '.join(line)}", flush=True)
    return worst


def family_batch(torch, cfg, b, s, seed):
    """A training batch of ``cfg`` with its stub frames or patches."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData

    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=seed))
    batch = train_batch(torch, data, 0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.encoder is not None:
        batch["frames"] = torch.randn((b, cfg.encoder.n_frames, cfg.d_model),
                                      generator=gen, device="cuda")
    if cfg.vision is not None:
        batch["patches"] = torch.randn((b, cfg.vision.n_patches,
                                        cfg.d_model), generator=gen,
                                       device="cuda")
    return batch


def attention_calls(cfg) -> int:
    """Flash-attention calls of one forward: one per decoder layer, plus
    the encoder's layers and the decoder's cross-attention (whisper); none
    for the SSM family."""
    if cfg.family == "ssm":
        return 0
    if cfg.encoder is not None:
        return cfg.encoder.n_layers + 2 * cfg.n_layers
    return cfg.n_layers


def family_train(torch, cfg, b, s, *, grads: bool):
    """Three build_train_step steps (AdamW) from seeded weights, the
    first captured and the others CUDA graph replays, each with exact
    flash launch counts (forward and remat replay, one backward per
    call); with ``grads`` every gradient of a separate loss_sp is checked
    finite first.  Returns (the first step's loss, grad_norm and ms, a
    replay's ms, the largest |gradient|, the words that say the steps
    were replays)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.train_loop import build_train_step

    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    batch = family_batch(torch, cfg, b, s, SEED)
    gmax = None
    if grads:
        loss, aux = model.loss_sp(batch)
        leaves = flatten_specs(model.params())
        gs = torch.autograd.grad(loss, list(leaves.values()))
        bad = [n for n, g in zip(leaves, gs) if not torch.isfinite(g).all()]
        if bad or not torch.isfinite(loss):
            fail(f"{cfg.name} {cfg.dtype}: loss {float(loss)}, gradients "
                 f"not finite: {bad[:8]}")
        gmax = max(g.abs().max().item() for g in gs)
        # freed before the step's capture (phase 6 says why)
        del gs, loss, aux
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    step = build_train_step(model, opt_cfg)
    opt = adamw_init(model.params(), opt_cfg)
    n = attention_calls(cfg)
    want = (2 * n if cfg.remat else n, n)
    out = []
    for i in range(3):
        if i:
            batch = family_batch(torch, cfg, b, s, SEED + i)
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(opt, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out.append((loss, norm, (time.perf_counter() - t0) * 1e3))
        if (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) != want:
            fail(f"{cfg.name} train step {i}: flash launches "
                 f"{fa.FWD_LAUNCHES} / {fa.BWD_LAUNCHES}, not {want}")
        if not (np.isfinite(loss) and np.isfinite(norm)):
            fail(f"{cfg.name} train step {i}: loss {loss}, grad_norm "
                 f"{norm}")
    words = check_train_graph(step, f"{cfg.name} {cfg.dtype}", 2)
    del model, opt, step
    torch.cuda.empty_cache()
    return (*out[0], out[-1][2], gmax, words)


def family_parity(torch, cfg, b, s):
    """At full width, 2 layers, f32 (TF32 off): loss_sp and every gradient
    with the flash kernels against ``attn_engine="torch"`` (phase 6's
    tolerances), with exact flash launch counts; returns the worst
    gradient error."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model, flatten_specs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = family_batch(torch, cfg, b, s, SEED + 1)
    n = attention_calls(cfg)
    runs = {}
    for engine in ("auto", "torch"):
        model = Model(cfg, device="cuda", attn_engine=engine).init(
            torch.Generator(device="cuda").manual_seed(SEED))
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        loss, _ = model.loss_sp(batch)
        leaves = flatten_specs(model.params())
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        want = (2 * n, n) if engine == "auto" else (0, 0)
        if (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) != want:
            fail(f"{cfg.name} parity ({engine}): flash launches "
                 f"{fa.FWD_LAUNCHES} / {fa.BWD_LAUNCHES}, not {want}")
        runs[engine] = dict(loss=loss.item(), grads=grads)
        del model
    worst = check_loss_and_grads(runs["auto"], runs["torch"],
                                 f"{cfg.name} 2 layers f32")
    print(f"  {cfg.name} full width, 2 layers, f32 (TF32 off), B={b}, S={s}"
          f": loss {runs['auto']['loss']:.6f} (kernels) vs "
          f"{runs['torch']['loss']:.6f} (plain); every gradient within "
          f"{worst[0]:.2e} of its largest magnitude (tolerance 1e-4); "
          f"flash launches {2 * n} / {n}", flush=True)
    del runs
    torch.cuda.empty_cache()
    return worst[0]


def phase_families(torch, root, card):
    """Phase 13: mamba2-130m, hymba-1.5b, whisper-small and internvl2-1b
    at their published sizes (bf16, seeded random weights), then each at
    2 layers in f32 with the kernels against the plain path."""
    from repro_torch import configs
    from repro_torch.configs.base import EncoderConfig, ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.serve_loop import Generator

    t13 = time.perf_counter()
    flash_worst = family_flash_checks(torch)
    rng = np.random.default_rng(SEED + 13)

    # mamba2-130m: the engine's slot state against the contiguous cache
    cfg = configs.get_config("mamba2-130m")
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    prompts = rng.integers(0, cfg.vocab_size - 1, size=(8, 48)).astype(
        np.int32)
    fa.FWD_LAUNCHES = paged.LAUNCHES = 0
    eng = ServeEngine(model, slots=8, page_size=16, max_seq=96,
                      schedule="static")
    rids = [eng.submit(p, FAM_NEW) for p in prompts]
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = np.stack([out[r] for r in rids])
    gen = Generator(model, ShapeConfig("s", 96, 8, "decode"))
    contiguous = gen.generate(prompts, FAM_NEW)
    if not np.array_equal(served, contiguous):
        fail(f"mamba2-130m: ServeEngine tokens {served.tolist()} != "
             f"contiguous Generator {contiguous.tolist()}")
    contig_way = check_decode_graph(gen, "phase 13 mamba2-130m contiguous")
    del gen
    if fa.FWD_LAUNCHES or paged.LAUNCHES:
        fail(f"mamba2-130m launched attention kernels: flash "
             f"{fa.FWD_LAUNCHES}, paged {paged.LAUNCHES}")
    way = check_graph(eng, "phase 13 mamba2-130m")
    print(f"  mamba2-130m ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.ssm_heads} SSM heads, d_state {cfg.ssm.d_state}, bf16): "
          f"8 requests of 48 tokens + {FAM_NEW} new through ServeEngine in "
          f"{wall:.2f} s ({eng.decode_steps} decode steps, "
          f"{wall / eng.decode_steps * 1e3:.2f} ms host wall each, {way});"
          f" tokens equal the contiguous Generator's ({contig_way}); no "
          f"attention launch", flush=True)
    del model, eng
    torch.cuda.empty_cache()

    # hymba-1.5b: the window bites in a 2048-token prefill
    cfg = configs.get_config("hymba-1.5b")
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size - 1, size=(2, 2048)).astype(np.int32)).cuda()
    model.prefill_sp({"tokens": tokens[:, :256]})             # warm-up
    fa.FWD_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    if fa.FWD_LAUNCHES != cfg.n_layers or not torch.isfinite(logits).all():
        fail(f"hymba prefill: {fa.FWD_LAUNCHES} flash launches (want "
             f"{cfg.n_layers}), finite {bool(torch.isfinite(logits).all())}")
    del logits, cache
    hp = [rng.integers(0, cfg.vocab_size - 1, size=int(p)).astype(np.int32)
          for p in rng.integers(32, 129, size=4)]
    got, eng, wall, launches = serve(torch, model, hp, FAM_NEW,
                                     schedule="static")
    if launches != cfg.n_layers * eng.decode_steps or any(
            len(t) != FAM_NEW for t in got):
        fail(f"hymba serving: paged launches {launches} != "
             f"{cfg.n_layers} x {eng.decode_steps}")
    way = check_graph(eng, "phase 13 hymba-1.5b")
    print(f"  hymba-1.5b ({cfg.n_layers} layers, heads {cfg.n_heads} -> "
          f"{cfg.padded_heads}, {cfg.ssm_heads} SSM heads, window "
          f"{cfg.sliding_window} except layers {cfg.full_attn_layers}, "
          f"bf16): prefill 2 x 2048 in {pre_ms:.1f} ms ({cfg.n_layers} flash "
          f"launches); 4 requests served in {wall:.2f} s, paged launches "
          f"{launches} = {cfg.n_layers} x {eng.decode_steps} decode steps, "
          f"{way}", flush=True)
    del model, eng
    torch.cuda.empty_cache()
    loss, norm, ms, replay_ms, _, words = family_train(
        torch, cfg, 1, FAM_TRAIN_S, grads=False)
    print(f"  hymba-1.5b bf16 train step 1 x {FAM_TRAIN_S}: loss {loss:.4f},"
          f" grad_norm {norm:.4f}, {ms:.1f} ms host wall (its capture "
          f"included), {replay_ms:.1f} ms as a replay, flash launches "
          f"{2 * cfg.n_layers} / {cfg.n_layers} a step; {words}",
          flush=True)

    # whisper-small and internvl2-1b: prefill with the stubs, 16 tokens
    for arch, s in (("whisper-small", 448), ("internvl2-1b", 1024)):
        cfg = configs.get_config(arch)
        model = Model(cfg, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(SEED))
        batch = family_batch(torch, cfg, 2, s, SEED + 2)
        stubs = {k: v.cpu().numpy() for k, v in batch.items()
                 if k in ("frames", "patches")}
        prompt = batch["tokens"].cpu().numpy()
        gen = Generator(model, ShapeConfig("s", s + FAM_NEW, 2, "decode"))
        gen.prefill_generate(prompt[:, :64], 2, **stubs)       # warm-up
        fa.FWD_LAUNCHES = paged.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = gen.prefill_generate(prompt, FAM_NEW, **stubs)
        wall = time.perf_counter() - t0
        way = check_decode_graph(gen, f"phase 13 {arch}")
        n = attention_calls(cfg)
        if (fa.FWD_LAUNCHES, paged.LAUNCHES) != (n, 0):
            fail(f"{arch}: flash launches {fa.FWD_LAUNCHES} (want {n}), "
                 f"paged {paged.LAUNCHES}")
        if toks.shape != (2, FAM_NEW) or toks.min() < 0 or \
                toks.max() >= cfg.padded_vocab:
            fail(f"{arch}: generated {toks.tolist()}")
        stub = (f"{cfg.encoder.n_frames} stub frames" if cfg.encoder
                else f"{cfg.vision.n_patches} stub patches")
        print(f"  {arch} ({cfg.n_layers} layers, d {cfg.d_model}, bf16): "
              f"{stub}, prefill 2 x {s} and {FAM_NEW} greedy tokens in "
              f"{wall:.2f} s, {n} flash launches (none in decode), {way}: "
              f"{toks[0].tolist()}", flush=True)
        del model, gen
        torch.cuda.empty_cache()

    # f32 training at full size: every gradient finite at chunk 256
    for arch in ("mamba2-130m", "hymba-1.5b"):
        cfg = dataclasses.replace(configs.get_config(arch), dtype="float32")
        torch.cuda.reset_peak_memory_stats()
        loss, norm, ms, replay_ms, gmax, words = family_train(
            torch, cfg, 1, FAM_TRAIN_S, grads=True)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"  {arch} f32 full size, {cfg.n_layers} layers, 1 x "
              f"{FAM_TRAIN_S} (SSD chunk {cfg.ssm.chunk}): every gradient "
              f"finite (largest |g| {gmax:.3e}); train step loss "
              f"{loss:.4f}, grad_norm {norm:.4f}, {ms:.1f} ms (capture "
              f"included), {replay_ms:.1f} ms as a replay, peak memory "
              f"{peak:.2f} GB; {words}", flush=True)

    # each family at 2 layers in f32: kernels against the plain path
    worst = 0.0
    for arch, b, s in (("mamba2-130m", 1, 512), ("hymba-1.5b", 1, 2048),
                       ("whisper-small", 2, 448), ("internvl2-1b", 2, 1024)):
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=2,
                                  dtype="float32")
        if cfg.encoder is not None:
            cfg = dataclasses.replace(cfg, encoder=EncoderConfig(
                n_layers=2, n_frames=cfg.encoder.n_frames))
        worst = max(worst, family_parity(torch, cfg, b, s))

    # hymba's paged kernel at 2 layers in f32: against the plain paged
    # path on the short prompts, then, with one prompt long enough that
    # the window masks positions in the windowed layer's decode steps,
    # against the contiguous cache (the plain paged path loops over the
    # table's pages in Python: about 95 ms a step at 70 pages)
    cfg = dataclasses.replace(configs.get_config("hymba-1.5b"), n_layers=2,
                              dtype="float32")
    windowed = [i for i in range(cfg.n_layers)
                if transformer.layer_window(cfg, i)]
    long = rng.integers(0, cfg.vocab_size - 1,
                        size=HYMBA_LONG_PROMPT).astype(np.int32)
    hp2 = [long] + hp[:3]
    last_pos = max(len(p) for p in hp2) + FAM_NEW - 2
    max_seq = -(-(last_pos + 1) // 16) * 16
    if windowed != [1] or last_pos - cfg.sliding_window < 1:
        fail(f"hymba 2 layers: windowed layers {windowed}, last decode "
             f"position {last_pos}: the window masks nothing")
    toks = {}
    for engine in ("auto", "torch"):
        model = Model(cfg, device="cuda", paged_engine=engine).init(
            torch.Generator(device="cuda").manual_seed(SEED))
        got, eng, _, launches = serve(torch, model, hp, FAM_NEW,
                                      schedule="static")
        want = cfg.n_layers * eng.decode_steps if engine == "auto" else 0
        if launches != want:
            fail(f"hymba 2 layers ({engine}): paged launches {launches}, "
                 f"not {want}")
        check_graph(eng, f"phase 13 hymba 2 layers ({engine})")
        toks[engine] = [t.tolist() for t in got]
        del eng
        if engine == "auto":
            got, eng, wall, launches = serve(torch, model, hp2, FAM_NEW,
                                             max_seq=max_seq,
                                             schedule="static")
            steps = eng.decode_steps
            if launches != cfg.n_layers * steps:
                fail(f"hymba 2 layers, long prompt: paged launches "
                     f"{launches}, not {cfg.n_layers} x {steps}")
            check_graph(eng, "phase 13 hymba 2 layers, long prompt")
            toks["long"] = [t.tolist() for t in got]
            gen = Generator(model, ShapeConfig("s", max_seq, 1, "decode"))
            toks["contiguous"] = [
                gen.prefill_generate(p[None], FAM_NEW)[0].tolist()
                for p in hp2]
            hymba_way = check_decode_graph(gen, "phase 13 hymba 2 layers")
            del eng, gen
        del model
    if toks["auto"] != toks["torch"]:
        fail(f"hymba 2 layers f32: paged kernel tokens {toks['auto']} != "
             f"plain {toks['torch']}")
    if toks["long"] != toks["contiguous"]:
        fail(f"hymba 2 layers f32, long prompt: paged kernel tokens "
             f"{toks['long']} != contiguous {toks['contiguous']}")
    print(f"  hymba-1.5b 2 layers f32 (layer 0 global, layer 1 windowed "
          f"{cfg.sliding_window}): the engine's greedy tokens with the paged "
          f"kernel equal the plain paged path's for prompts of "
          f"{[len(p) for p in hp]} + {FAM_NEW}; for prompts of "
          f"{[len(p) for p in hp2]} + {FAM_NEW} (decode positions up to "
          f"{last_pos}, past the window; {cfg.n_layers} x {steps} paged "
          f"launches, {wall:.2f} s) they equal the contiguous Generator's "
          f"(prefill_sp, then the ring-buffer cache; {hymba_way})",
          flush=True)
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    ex = subprocess.run([sys.executable, "-m",
                         "repro_torch.examples.serve_batched"], env=env,
                        capture_output=True, text=True, timeout=600)
    if ex.returncode != 0 or ex.stdout.count("request ") != 4:
        fail(f"serve_batched on the card: {ex.stdout[-2000:]} "
             f"{ex.stderr[-2000:]}")
    for line in ex.stdout.splitlines():
        print(f"  serve_batched: {line}", flush=True)
    print(f"  phase 13 took {time.perf_counter() - t13:.1f} s (worst bf16 "
          f"flash error at the families' shapes {flash_worst:.3e}; worst "
          f"2-layer gradient error {worst:.2e})", flush=True)


# ---------------------------------------------------------------------------
# phase 14: pipeline parallelism, the int8 pod reduction and the fault loop
# ---------------------------------------------------------------------------

#: (a) one rank: phi4-mini uncut as one pipeline stage, M microbatches
PIPE_M = 2
#: (a) the first pipelined step's loss against phase 5's plain step (bf16:
#: the microbatches' one-row GEMMs round apart from the two-row batch's)
PIPE_LOSS_RTOL = 2e-3
#: (b) two stages: phi4-mini at full width, this many layers (the fewest
#: interleaved v = 2 over 2 stages takes), f32, one step of 2 x 1024
PIPE_MESH_LAYERS = 4
PIPE_SCHEDULES = ("gpipe", "1f1b", "interleaved", "auto")
#: (b) against rank 0's 1x1 step: loss and gradient norm; every gradient
#: at the reference suite's gradient tolerance; the updated parameters at
#: phase 11's mesh tolerance (AdamW's first step divides each gradient by
#: its own magnitude, so a gradient that cancels to near zero carries its
#: last digits into the update)
PIPE_LOSS_MESH_RTOL, PIPE_NORM_RTOL = 1e-5, 1e-5
PIPE_RTOL, PIPE_ATOL = 3e-4, 1e-6
PIPE_PARAM_RTOL, PIPE_PARAM_ATOL = MESH_RTOL, MESH_ATOL
#: (c) the int8 pod reduction on a 2x1x1 data-parallel step: steps, and
#: the compressed losses' tolerance against the uncompressed ones, stated
#: from a first run on an H100 (relative gaps 0, 1.5e-3, 2.6e-2): one
#: int8 scale per tensor zeroes most of the tied embedding's gradient
#: (its absmax comes from the batch's own tokens), and AdamW's first
#: steps move a zeroed coordinate not at all where the f32 run moves it
#: by about lr; as in the reference, no error feedback carries between
#: steps
COMPRESS_STEPS = 3
COMPRESS_LOSS_RTOL = 5e-2
#: (d) train_100m's model through TrainLoop with the managed cadence; the
#: fault plan's steps follow the faulted run's own checkpoints (the
#: cadence is decided from measured times): a rank death the step after
#: its first save, a corrupt event the step after its second.  The
#: Young/Daly interval is sqrt(2 x save cost x MTBF) / step time: with a
#: 1 GB save costing 0.4-0.5 s, an MTBF of 20 ms puts it at 4-8 of the
#: ~24 ms steps a graph replay takes (1 s did so for the ~110-145 ms
#: steps from Python), so the run saves several times in its 30 steps
FAULT_STEPS = 30
FAULT_MTBF_S = 0.02
#: the resumed losses must lie within this many times the spread of two
#: uninterrupted runs (the bf16 flash backward's reduce-adds sum in an
#: order that varies, so runs differ), and equal them bit for bit where
#: the spread is 0.  On an NVIDIA H100 80GB HBM3 at 700 W
#: (scripts/fault_spread.py --broken), six pairs of uninterrupted runs
#: spread 1.7e-4 to 4.0e-4 and a correctly resumed run lay 1.9e-4 to
#: 4.1e-4 from each of four, up to 2.5 times the closest pair's spread;
#: restores broken on purpose (the optimizer state dropped, only its
#: moments dropped, the step counter one back) moved the losses by 0.94,
#: 0.088 and 0.29
FAULT_SPREAD_FACTOR = 10


def pipeline_one_rank(torch, plain):
    """Phase 14 (a): phi4-mini-3.8b uncut on a 1x1x1 pod mesh through
    ``build_train_step(pipeline="1f1b", pipe_microbatches=2)``: 2 warm-up
    and 3 timed steps, then one gpipe step; exact flash launches (each
    chunk's forward in its F unit and again in its B unit, its backward
    once) and the first loss against phase 5's plain step on the same
    weights and batch."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import MeshCtx
    from repro_torch.train.train_loop import build_train_step

    cfg = configs.get_config("phi4-mini-3.8b")
    b, s = TRAIN_ATTN["b"], TRAIN_ATTN["s"]
    torch.cuda.reset_peak_memory_stats()
    ctx = MeshCtx(axis_sizes={"pod": 1, "data": 1, "model": 1})
    model = Model(cfg, ctx, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                          moment_dtype=cfg.moment_dtype)
    opt = adamw_init(model.params(), opt_cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))
    want = (2 * PIPE_M * cfg.n_layers, PIPE_M * cfg.n_layers)
    losses, walls = [], []
    for sched, steps in (("1f1b", 5), ("gpipe", 1)):
        step = build_train_step(model, opt_cfg, pipeline=sched,
                                pipe_microbatches=PIPE_M, global_batch=b,
                                seq_len=s)
        if step.step_mode != "eager":
            fail(f"the pipelined step ({sched}) runs {step.step_mode}, not "
                 f"eager")
        for _ in range(steps):
            batch = train_batch(torch, data, len(losses))
            fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            opt, metrics = step(opt, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(loss)
            got = (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES)
            print(f"  {sched} step {len(losses) - 1}: loss {loss:.4f}, "
                  f"{walls[-1] * 1e3:.1f} ms host wall, flash launches "
                  f"{got[0]} forward / {got[1]} backward", flush=True)
            if got != want:
                fail(f"pipelined step ({sched}, M={PIPE_M}, 1 stage): flash "
                     f"launches {got} != {want} (2 M L forward: F and B's "
                     f"recompute; M L backward)")
    if not all(np.isfinite(losses)):
        fail(f"non-finite pipelined losses {losses}")
    gap = abs(losses[0] - plain["loss0"]) / abs(plain["loss0"])
    if gap > PIPE_LOSS_RTOL:
        fail(f"the pipelined first step's loss {losses[0]!r} is off phase "
             f"5's plain step {plain['loss0']!r} by {gap:.2e} relative "
             f"(tolerance {PIPE_LOSS_RTOL})")
    ms = sum(walls[2:5]) / 3 * 1e3
    print(f"  1f1b, M={PIPE_M}, one stage (phi4-mini-3.8b uncut, bf16, B={b},"
          f" S={s}): first loss {losses[0]!r} against phase 5's plain step "
          f"{plain['loss0']!r} (relative gap {gap:.2e}, tolerance "
          f"{PIPE_LOSS_RTOL}); after 2 warm-up steps {ms:.1f} ms a step = "
          f"{b * s / ms * 1e3:.1f} tokens/s (phase 5's plain step "
          f"{plain['ms']:.1f} ms = {plain['tok_s']:.1f} tokens/s); gpipe "
          f"step {walls[5] * 1e3:.1f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; the pipelined "
          f"steps eager (a pipeline runs no captured graph)", flush=True)
    del model, opt, step, metrics
    torch.cuda.empty_cache()
    return want


def pipe_mesh_rank_main(rank: int, init: str, out_dir: str) -> None:
    """One of phase 14's two processes.  Rank 0 first runs the 1x1 step;
    then both run phi4-mini (4 layers, f32) as two pipeline stages under
    each schedule from the same weights, rank 0 holding the gradients
    (read where the step hands them to AdamW) and the updated parameters
    to the 1x1 step's; then a 2x1x1 data-parallel run with and without
    the int8 pod reduction.  Results go to rank{r}.json."""
    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import managed, transport
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models.model import Model, flatten_specs
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel import pipeline
    from repro_torch.parallel.sharding import MeshCtx
    from repro_torch.train import train_loop
    from repro_torch.train.train_loop import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch_mesh.init_distributed("cuda", init_method=init, rank=rank,
                                 world_size=2)
    cfg = dataclasses.replace(configs.get_config("phi4-mini-3.8b"),
                              n_layers=PIPE_MESH_LAYERS, dtype="float32")
    # the gradients as the step hands them to AdamW: kept from the 1x1
    # step, then each schedule's worst excess over them
    grads = {"want": None, "worst": (0.0, "")}
    adamw_update = train_loop.adamw_update

    def held(params, grad_tree, state, ocfg, *, gnorm=None):
        flat = flatten_specs(grad_tree)
        if grads["want"] is None:
            grads["want"] = {k: g.detach().clone() for k, g in flat.items()}
        else:
            worst = (0.0, "")
            for k, g in flat.items():
                want = grads["want"][k]
                bad = (g - want).abs() - PIPE_RTOL * want.abs()
                worst = max(worst, (float(bad.max()), k))
            grads["worst"] = worst
        return adamw_update(params, grad_tree, state, ocfg, gnorm=gnorm)
    b, s = TRAIN_ATTN["b"], TRAIN_ATTN["s"]
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                      global_batch=b, seed=SEED))
    opt_cfg = AdamWConfig(lr=1e-2)
    res = {"rank": rank}

    def model_on(ctx):
        # over pod alone no weight is sharded: every rank draws the 1x1
        # model's weights from the seed
        return Model(cfg, ctx, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(SEED))

    def run(model, steps=1, **kw):
        opt = adamw_init(model.params(), opt_cfg)
        out = {"losses": [], "ms": [], "fwd": 0, "bwd": 0}
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        transport.reset_staged_bytes()
        pipeline.reset_handoffs()
        with managed.capture_decisions() as cap:
            fn = build_train_step(model, opt_cfg, global_batch=b,
                                  seq_len=s, **kw)
            for i in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt, metrics = eager_step(fn, opt,
                                          train_batch(torch, data, i))
                out["losses"].append(float(metrics["loss"]))
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    out["grad_norm"] = float(metrics["grad_norm"])
                    out["fwd"], out["bwd"] = fa.FWD_LAUNCHES, fa.BWD_LAUNCHES
                    out["staged"] = transport.staged_bytes()
                    out["handoffs"] = pipeline.handoffs()
        pod = [r for r in cap.records if r.axis == "pod"]
        out["gather_bytes"] = sum(r.nbytes for r in pod
                                  if r.op == "all_gather") / steps
        out["reduce_bytes"] = sum(r.nbytes for r in pod
                                  if r.op == "all_reduce") / steps
        out["decision"] = [(r.mode, r.chunks) for r in cap.records
                           if r.op == "pipeline_schedule"]
        out["mode"] = fn.step_mode
        del opt, fn
        return out

    one = None
    if rank == 0:
        train_loop.adamw_update = held
        model = model_on(MeshCtx())
        res["one"] = run(model)
        one = {k: v.detach().clone()
               for k, v in flatten_specs(model.params()).items()}
        del model
        torch.cuda.empty_cache()
    dist.barrier()
    shape, axes = launch_mesh.parse_mesh("2x1x1")
    ctx = MeshCtx.from_mesh(launch_mesh.make_mesh(shape, axes, "cuda"),
                            "auto")
    for sched in PIPE_SCHEDULES:
        model = model_on(ctx)
        res[sched] = run(model, pipeline=sched, pipe_microbatches=(
            None if sched == "auto" else PIPE_M))
        worst, tight = (0.0, ""), (0.0, "")
        if rank == 0:
            for name, t in flatten_specs(model.params()).items():
                diff = (t - one[name]).abs()
                bad = diff - PIPE_PARAM_RTOL * one[name].abs()
                worst = max(worst, (float(bad.max()), name))
                bad = diff - PIPE_RTOL * one[name].abs()
                tight = max(tight, (float(bad.max()), name))
        res[sched].update(worst=worst, tight=tight,
                          grad_worst=grads["worst"])
        del model
        torch.cuda.empty_cache()
    train_loop.adamw_update = adamw_update
    del one, grads["want"]
    for compress in (False, True):
        model = model_on(ctx)
        res[f"compress{int(compress)}"] = run(model, steps=COMPRESS_STEPS,
                                              compress_pod=compress)
        # the gradients the pod reduction compresses (no weight is
        # sharded over pod)
        res[f"compress{int(compress)}"]["big"] = [
            t.numel() for t in flatten_specs(model.params()).values()
            if t.numel() > 4096]
        del model
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


def pipeline_two_ranks(torch, card):
    """Phase 14 (b) and (c): the two rank processes, each schedule against
    1x1, and the int8 pod reduction against the f32 one."""
    res = run_rank_pair("--pipe-mesh-rank", "phase 14", 900)
    one = res[0]["one"]
    per_rank = PIPE_MESH_LAYERS // 2
    print(f"  phi4-mini-3.8b at full width, {PIPE_MESH_LAYERS} layers, f32, "
          f"TF32 off, B={TRAIN_ATTN['b']}, S={TRAIN_ATTN['s']}; two "
          f"processes on {card}, gloo (file:// init); 1x1 on rank 0: loss "
          f"{one['losses'][0]!r}, grad norm {one['grad_norm']!r}, step "
          f"{one['ms'][0]:.1f} ms", flush=True)
    for sched in PIPE_SCHEDULES:
        (mode, m), = res[0][sched]["decision"]
        want = (2 * m * per_rank, m * per_rank)
        for r in range(2):
            got = res[r][sched]
            if got["decision"] != res[0][sched]["decision"]:
                fail(f"{sched}: the ranks decided {got['decision']} and "
                     f"{res[0][sched]['decision']}")
            if (got["fwd"], got["bwd"]) != want:
                fail(f"{sched} rank {r}: flash launches {got['fwd']} / "
                     f"{got['bwd']}, not {want}")
            loss_gap = abs(got["losses"][0] - one["losses"][0]) / abs(
                one["losses"][0])
            norm_gap = abs(got["grad_norm"] - one["grad_norm"]) / abs(
                one["grad_norm"])
            if loss_gap > PIPE_LOSS_MESH_RTOL or norm_gap > PIPE_NORM_RTOL:
                fail(f"{sched} rank {r}: loss {got['losses'][0]!r} / grad "
                     f"norm {got['grad_norm']!r} against 1x1's "
                     f"{one['losses'][0]!r} / {one['grad_norm']!r}")
        gbad, gname = res[0][sched]["grad_worst"]
        if gbad > PIPE_ATOL:
            fail(f"{sched}: gradient {gname} off the 1x1 step's by "
                 f"{gbad:.3e} beyond rtol {PIPE_RTOL} (atol {PIPE_ATOL})")
        bad, name = res[0][sched]["worst"]
        if bad > PIPE_PARAM_ATOL:
            fail(f"{sched}: updated parameter {name} off the 1x1 step by "
                 f"{bad:.3e} beyond rtol {PIPE_PARAM_RTOL} (atol "
                 f"{PIPE_PARAM_ATOL})")
        tight, tname = res[0][sched]["tight"]
        msgs, nbytes = res[0][sched]["handoffs"]
        print(f"  {sched} ({mode}, M={m}): loss {res[0][sched]['losses'][0]!r}"
              f" on both ranks, grad norm {res[0][sched]['grad_norm']!r}; "
              f"every gradient within rtol {PIPE_RTOL} / atol {PIPE_ATOL} "
              f"of 1x1's (worst excess {gbad:.2e} at {gname}), every "
              f"updated parameter within rtol {PIPE_PARAM_RTOL} / atol "
              f"{PIPE_PARAM_ATOL} (worst excess {bad:.2e} at {name}; "
              f"beyond rtol {PIPE_RTOL} {tight:.2e} at {tname}); flash "
              f"launches "
              f"per rank {want[0]} / {want[1]}; rank 0 handed {msgs} "
              f"messages ({nbytes / 1e6:.1f} MB), rank 1 "
              f"{res[1][sched]['handoffs'][0]}; step host wall "
              f"{res[0][sched]['ms'][0]:.1f} / {res[1][sched]['ms'][0]:.1f} "
              f"ms; bytes between card and host memory "
              f"{res[0][sched]['staged']} / {res[1][sched]['staged']}",
              flush=True)
    plain, packed = res[0]["compress0"], res[0]["compress1"]
    gaps = [abs(a - c) / abs(a) for a, c in zip(plain["losses"],
                                                packed["losses"])]
    if packed["losses"][0] != plain["losses"][0] or max(gaps) > \
            COMPRESS_LOSS_RTOL:
        fail(f"--compress-pod losses {packed['losses']} against "
             f"{plain['losses']} (relative gaps {gaps})")
    n, count = sum(packed["big"]), len(packed["big"])
    if packed["gather_bytes"] != n + 4 * count or (
            plain["reduce_bytes"] - packed["reduce_bytes"] != 4 * n):
        fail(f"--compress-pod payload: all-gathers {packed['gather_bytes']} "
             f"B a step for {n} compressed elements in {count} gradients "
             f"(want {n + 4 * count}); all-reduces {packed['reduce_bytes']} "
             f"against {plain['reduce_bytes']}")
    for r in range(2):
        if res[r]["compress1"]["losses"] != packed["losses"]:
            fail(f"--compress-pod rank {r} losses differ from rank 0's")
    print(f"  2x1x1 data-parallel, {COMPRESS_STEPS} steps: f32 pod "
          f"all-reduce losses {plain['losses']}, int8 pod reduction "
          f"{packed['losses']} (relative gaps {[f'{g:.2e}' for g in gaps]}, "
          f"tolerance {COMPRESS_LOSS_RTOL}); pod payload a step "
          f"{plain['reduce_bytes'] / 1e6:.3f} MB of f32 all-reduces -> "
          f"{packed['gather_bytes'] / 1e6:.3f} MB of int8 all-gathers "
          f"({n} elements in {count} gradients, {4 * count} B of scales) "
          f"+ {packed['reduce_bytes'] / 1e6:.6f} MB still all-reduced; "
          f"step host wall {plain['ms']} / {packed['ms']} ms; bytes "
          f"between card and host memory in the first step "
          f"{plain['staged']} / {packed['staged']}", flush=True)
    keys = list(PIPE_SCHEDULES) + ["compress0", "compress1"]
    print(f"  {mesh_step_modes(res, keys, 'phase 14 (b, c)')}", flush=True)


class OwnSavesPlan:
    """The faulted run's plan, placed on that run's own checkpoints (the
    cadence is decided from measured times, so another run's saves need
    not fall where this run's do): a rank death at the step after the
    first save is issued, then a corrupt event at the step after the
    first save issued after that restore.  The loop's recovery waits for
    the save in flight, so the rank death restores the first save; the
    corrupt event lets the second land (``settle``), truncates it, and
    leaves the first to fall back to.  Neither is placed at the last
    step.  ``attach`` counts the saves the loop issues; the plan is then
    the loop's ``fault_hook``, called before the fault plan's own hook in
    the same step."""

    def __init__(self):
        self.issued = []            # the steps of the saves issued so far
        self.placed = {}            # kind -> step
        self.corrupted = None       # the checkpoint the corrupt event hits
        self._issued_at_death = None

    def attach(self, loop):
        save = loop.mgr.save_async

        def counted(step, tree, extra=None):
            self.issued.append(step)
            save(step, tree, extra)

        loop.mgr.save_async = counted

    def __call__(self, loop, step):
        from repro_torch.checkpoint import ckpt
        from repro_torch.core.faults import FaultEvent

        if "corrupt" in self.placed or step >= FAULT_STEPS - 1:
            return
        if "rank_death" not in self.placed:
            if not self.issued:
                return
            kind = "rank_death"
            self._issued_at_death = len(self.issued)
        else:
            if len(self.issued) == self._issued_at_death:
                return
            kind = "corrupt"
            # the checkpoint the corrupt event attacks: the latest once
            # the save in flight has landed
            loop.mgr.wait()
            self.corrupted = ckpt.latest_step(loop.cfg.ckpt_dir)
        self.placed[kind] = step
        loop.fault_plan.events.append(FaultEvent(kind=kind, step=step))

    @property
    def spec(self):
        return ";".join(f"{k}@{s}" for k, s in self.placed.items())


def fault_run(torch, tmp, name, plan=None):
    """train_100m's model (bf16, uncut) through TrainLoop with the managed
    cadence, FAULT_STEPS steps of 8 x 256; under an ``OwnSavesPlan`` when
    one is given.  Returns the loop, its result, the loss of each step
    (the last run of a step that ran twice), every step run in order as
    (step, loss) and the words that say each binding's steps after its
    first were CUDA graph replays (a restore binds again)."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.tuner import ScheduleTuner
    from repro_torch.data.pipeline import DataConfig, SyntheticLMData
    from repro_torch.examples import train_100m
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import MeshCtx
    from repro_torch.train.train_loop import (TrainLoop, TrainLoopConfig,
                                              build_train_step)

    cfg = train_100m.CONFIG_100M
    model = Model(cfg, MeshCtx(), device="cuda")
    opt_cfg = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=FAULT_STEPS)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                      global_batch=8))
    box = {}
    step = build_train_step(model, opt_cfg)
    loop = TrainLoop(step, model, opt_cfg, data,
                     TrainLoopConfig(total_steps=FAULT_STEPS,
                                     ckpt_every=max(5, FAULT_STEPS // 4),
                                     ckpt_dir=os.path.join(tmp, name),
                                     managed_cadence=True,
                                     mtbf_s=FAULT_MTBF_S),
                     plan and (lambda step: plan(box["loop"], step)),
                     tuner=ScheduleTuner(),
                     fault_plan=FaultPlan() if plan else None)
    box["loop"] = loop
    if plan:
        plan.attach(loop)
    out = loop.run(*loop.init_state(seed=SEED))
    ran = [(h["step"], h["loss"]) for h in out["history"]]
    losses = dict(ran)
    bindings = out["restarts"] + 1
    words = check_train_graph(step, f"phase 14 (d) run {name}",
                              out["steps_executed"] - bindings, bindings)
    del model, step
    return loop, out, [losses[i] for i in range(FAULT_STEPS)], ran, words


def fault_loop(torch, card):
    """Phase 14 (d): two uninterrupted runs (their spread says whether the
    flash backward is deterministic) and one under a fault plan placed on
    its own checkpoints; the faulted run restores past the corrupt
    checkpoint, fires every event, and replays the uninterrupted
    losses."""
    from repro_torch.core import cost_model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_faults_")
    try:
        loop_a, out_a, a, _, _ = fault_run(torch, tmp, "a")
        _, _, b, _, _ = fault_run(torch, tmp, "b")
        plan = OwnSavesPlan()
        loop, out, f, ran, words = fault_run(torch, tmp, "f", plan)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    saved_a = [r.step for r in loop_a.ckpt_metrics.saves]
    saved = [r.step for r in loop.ckpt_metrics.saves]
    restored = [r.step for r in loop.ckpt_metrics.restores]
    if len(plan.placed) != 2:
        fail(f"the faulted run's checkpoints (steps {saved}) left no room "
             f"before step {FAULT_STEPS - 1} for a rank death and a "
             f"corrupt event: placed {plan.spec!r}")
    if loop.fault_plan.unfired() or out["restarts"] != 2:
        fail(f"fault plan {plan.spec}: unfired "
             f"{loop.fault_plan.unfired()}, {out['restarts']} restarts")
    if len(restored) != 2 or not (0 < restored[1] < plan.corrupted):
        fail(f"the restore after the corrupt checkpoint (step "
             f"{plan.corrupted}) took step {restored[1:]}: not an earlier "
             f"checkpoint (restores {restored}, saves {saved})")
    spread = max(abs(x - y) for x, y in zip(a, b))
    off = min(max(abs(x - y) for x, y in zip(u, f)) for u in (a, b))
    if not all(np.isfinite(f)) or off > FAULT_SPREAD_FACTOR * spread:
        fail(f"resumed losses off the nearer uninterrupted run's by {off!r} "
             f"(two uninterrupted runs differ by {spread!r}; allowed "
             f"{FAULT_SPREAD_FACTOR} times that)")
    # every run of the fallback checkpoint's step starts from that
    # checkpoint's state
    reruns = [loss for st, loss in ran if st == restored[1]]
    decisions = loop.ckpt_decisions
    measured = [d for d in decisions
                if d.write_bw != cost_model.CKPT_WRITE_BW]
    if not measured:
        fail("no ckpt_interval decision priced the measured write "
             "bandwidth")
    d = measured[-1]
    print(f"  train_100m's model (bf16, uncut), {FAULT_STEPS} steps of 8 x "
          f"256 through TrainLoop, --ckpt-every auto, MTBF {FAULT_MTBF_S} s; "
          f"an uninterrupted run saved at steps {saved_a}, the faulted "
          f"run at {saved} under the plan {plan.spec!r} placed on its own "
          f"saves: every event fired, {out['restarts']} restarts, "
          f"{out['steps_executed']} steps executed; the rank death "
          f"restored step {restored[0]}, the corrupt checkpoint (step "
          f"{plan.corrupted}) was passed over for step {restored[1]}; "
          f"the faulted run's {words}", flush=True)
    for rec in decisions:
        print(f"  decision ckpt_interval({rec.mode} N={rec.interval} snap="
              f"{rec.snapshot_bytes / 1e6:.1f}MB step {rec.step_s * 1e3:.2f} "
              f"ms, write bandwidth {rec.write_bw / 1e9:.3f} GB/s, cost "
              f"{rec.ckpt_cost_s * 1e3:.2f} ms, fixed_ovh "
              f"{rec.fixed_overhead:.4f}, chosen_ovh "
              f"{rec.chosen_overhead:.4f})", flush=True)
    verdict = ("bit for bit: the flash backward is deterministic"
               if spread == 0 else "the flash backward is not deterministic")
    print(f"  the last decision priced the measured write bandwidth "
          f"{d.write_bw / 1e9:.3f} GB/s; two uninterrupted runs differ by "
          f"at most {spread!r} in loss ({verdict}), the resumed run from "
          f"the nearer by {off!r} (allowed {FAULT_SPREAD_FACTOR} times the "
          f"spread); step {restored[1]} ran {len(reruns)} times from its "
          f"checkpoint with losses {reruns}; uninterrupted "
          f"host wall {out_a['wall_s']:.2f} s, faulted {out['wall_s']:.2f} "
          f"s on {card}", flush=True)


def phase_pipeline(torch, card, plain):
    """Phase 14: the pipeline on one rank and over two processes, the
    int8 pod reduction, and the fault-tolerant loop."""
    t14 = time.perf_counter()
    launches = pipeline_one_rank(torch, plain)
    pipeline_two_ranks(torch, card)
    fault_loop(torch, card)
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 15: the directives, the planner, the verifier and the trace
# ---------------------------------------------------------------------------

#: phase 3's tokens and decode steps, which phase 15 (b) is held to
PHASE3: dict = {}
#: a launch's end-of-run checkpoint is replaced by this stand-in: at full
#: size it is a 38 GB snapshot beside the 38 GB live state and a 38 GB
#: disk write, outside the phase's budget (phases 10 and 14 checkpoint)
SAVE_STAND_IN_S = 0.01
#: phase 15 (a): the flash backward's bulk reduce-adds sum in no fixed
#: order, so two runs' losses agree bit for bit only at the first step;
#: later ones within this (relative; two plain runs differ by 1e-4-1e-2,
#: phase 14, and the planned run's third loss was 4.1e-3 off the plain
#: one's in the first chip run of phase 15)
PLAN_LOSS_RTOL = 2e-2
#: phase 15 (c): phase 11's setup with the sequence cut (an f32 step there
#: takes 10-20 s) and the managed attention dispatcher, whose schedule
#: the plan's knob binds
PLAN_MESH_S = 256


class saves_stood_in:
    """``with saves_stood_in(calls):`` — ``CheckpointManager.save_async``
    records the step in ``calls`` and sleeps ``SAVE_STAND_IN_S`` instead
    of snapshotting and writing."""

    def __init__(self, calls: list):
        self.calls = calls

    def __enter__(self):
        from repro_torch.checkpoint import ckpt

        self._real = ckpt.CheckpointManager.save_async
        calls = self.calls

        def stand_in(mgr, step, tree, extra=None):
            calls.append(step)
            time.sleep(SAVE_STAND_IN_S)

        ckpt.CheckpointManager.save_async = stand_in
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint import ckpt

        ckpt.CheckpointManager.save_async = self._real


def launch_quietly(main, argv):
    """``main(argv)`` with its output captured: (result, text, seconds).
    The plan and the tracer a launch installs are taken down after."""
    import io

    from repro_torch import obs
    from repro_torch.core import managed

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(argv)
    except SystemExit as e:
        fail(f"{argv} exited {e.code}: {buf.getvalue()[-3000:]}")
    finally:
        managed.install_plan(None)
        obs.install_tracer(None)
    return out, buf.getvalue(), time.perf_counter() - t0


def plan_train(torch, tmp, card):
    """(a) phi4-mini-3.8b uncut through launch.train, planned, verified
    strictly and traced, against the same launcher's plain launch."""
    import gc

    from repro_torch import obs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import trace as trace_cli
    from repro_torch.launch import train as train_cli

    t0 = time.perf_counter()
    runs = {}
    for name, flags in (("local", ["--plan", "local", "--verify", "off"]),
                        ("program", ["--plan", "program", "--verify",
                                     "strict"])):
        path = os.path.join(tmp, f"train_{name}.json")
        argv = ["--arch", "phi4-mini-3.8b", "--batch", "2", "--seq", "1024",
                "--steps", "3", "--seed", str(SEED), "--ckpt",
                os.path.join(tmp, f"ck_{name}"), "--trace", path] + flags
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        saves = []
        with saves_stood_in(saves), kept_train_steps(train_cli) as made:
            out, text, wall = launch_quietly(train_cli.main, argv)
        torch.cuda.synchronize()
        if "train step: graph" not in text:
            fail(f"launch.train ({name}) did not print its step's mode "
                 f"graph: {text[-2000:]}")
        runs[name] = dict(losses=[h["loss"] for h in out["history"]],
                          fwd=fa.FWD_LAUNCHES, bwd=fa.BWD_LAUNCHES,
                          text=text, wall=wall, path=path, saves=saves,
                          step_ms=[h["time_s"] * 1e3
                                   for h in out["history"]],
                          graph=check_train_graph(
                              made[0], f"launch.train ({name})", 2))
        del out, made
        gc.collect()
        torch.cuda.empty_cache()
    prog, local = runs["program"], runs["local"]
    for line in prog["text"].splitlines():
        if line.startswith(("decision program_plan", "  trail", "mdmplint")):
            print(f"  launch.train --plan program: {line.strip()}",
                  flush=True)
    if "decision program_plan(" not in prog["text"] or \
            "mdmplint: train:phi4-mini-3.8b clean (0 diagnostics)" \
            not in prog["text"]:
        fail(f"launch.train --plan program --verify strict printed no "
             f"program_plan line or a verifier finding: "
             f"{prog['text'][-2000:]}")
    for name, r in runs.items():
        if (r["fwd"], r["bwd"]) != (3 * 64, 3 * 32):
            fail(f"launch.train ({name}): flash launches {r['fwd']} / "
                 f"{r['bwd']} over 3 steps, not 64 / 32 a step")
    if prog["losses"][0] != local["losses"][0]:
        fail(f"the planned launch's first loss {prog['losses'][0]!r} != "
             f"the plain launch's {local['losses'][0]!r}")
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                 local["losses"])]
    if len(gaps) != 3 or max(gaps) > PLAN_LOSS_RTOL:
        fail(f"planned losses {prog['losses']} against plain "
             f"{local['losses']} (relative gaps {gaps}, tolerance "
             f"{PLAN_LOSS_RTOL} after the first)")
    doc = obs.load_trace(prog["path"])
    names = [e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"]
    if names.count("train.step") != 3 or "lint.preflight" not in names \
            or "plan.resolve" not in names:
        fail(f"the planned launch's trace holds spans {sorted(set(names))}")
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_sum = trace_cli.main([prog["path"]])
        rc_diff = trace_cli.main(["--diff", local["path"], prog["path"]])
    summary = buf.getvalue()
    if rc_sum != 0 or rc_diff != 0 or "train.step" not in summary:
        fail(f"launch.trace on the two traces: summary rc {rc_sum}, diff rc "
             f"{rc_diff}: {summary[-2000:]}")
    for line in summary.splitlines():
        if line.strip().startswith(("train.step", "lint.preflight",
                                    "plan.resolve", "OK:", "diff ")):
            print(f"  launch.trace: {line.strip()}", flush=True)
    print(f"  (a) launch.train phi4-mini-3.8b uncut, B=2 x S=1024, 3 steps "
          f"at 1x1: planned + verified + traced losses {prog['losses']} "
          f"against plain {local['losses']} (first bit for bit, relative "
          f"gaps {[f'{g:.2e}' for g in gaps]}); flash launches 64 / 32 a "
          f"step in both; host wall per step {prog['step_ms']} / "
          f"{local['step_ms']} ms; launch walls {prog['wall']:.1f} / "
          f"{local['wall']:.1f} s; end-of-run saves stood in "
          f"{prog['saves']} / {local['saves']}; trace "
          f"{len(names)} spans; both launches' {prog['graph']}; "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)


def plan_serve(torch, tmp, card):
    """(b) phi4-mini uncut through launch.serve, planned, verified and
    traced, on phase 3's 8 requests."""
    import gc

    from repro_torch import configs
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.launch import serve as serve_cli

    t0 = time.perf_counter()
    cfg = configs.get_config("phi4-mini-3.8b")
    path = os.path.join(tmp, "serve.json")
    argv = ["--arch", "phi4-mini-3.8b", "--seed", str(SEED), "--requests",
            "8", "--min-prompt-len", "64", "--prompt-len", "256",
            "--new-tokens", "32", "--slots", "8", "--page-size", "16",
            "--max-seq", "512", "--plan", "program", "--verify", "warn",
            "--trace", path]
    # launch.serve draws its requests from default_rng(0), phase 3 drew
    # them (in the same order) from default_rng(SEED + 1): map the one
    # seed to the other so the launcher serves phase 3's requests
    real_rng = np.random.default_rng
    np.random.default_rng = lambda seed=None: real_rng(
        SEED + 1 if seed == 0 else seed)
    paged.LAUNCHES = 0
    try:
        out, text, wall = launch_quietly(serve_cli.main, argv)
    finally:
        np.random.default_rng = real_rng
    torch.cuda.synchronize()
    launches, steps = paged.LAUNCHES, out["engine"].decode_steps
    way = check_graph(out["engine"], "(15) (b) launch.serve")
    got = out["tokens"]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    if "decision program_plan(" not in text or "mdmplint: serve:" not in text:
        fail(f"launch.serve --plan program printed no program_plan or "
             f"mdmplint line: {text[-2000:]}")
    want = PHASE3["tokens"]
    if len(got) != len(want) or any(
            g is None or not np.array_equal(g, w) for g, w in zip(got, want)):
        fail(f"launch.serve's tokens differ from phase 3's: "
             f"{[None if g is None else g[:8].tolist() for g in got]} vs "
             f"{[w[:8].tolist() for w in want]}")
    if launches != cfg.n_layers * steps:
        fail(f"launch.serve: paged launches {launches} != {cfg.n_layers} x "
             f"{steps} decode steps")
    for line in text.splitlines():
        if line.startswith(("decision program_plan", "  trail", "mdmplint",
                            "decision serve_schedule", "trace:")):
            print(f"  launch.serve --plan program: {line.strip()}",
                  flush=True)
    print(f"  (b) launch.serve phi4-mini-3.8b uncut, phase 3's 8 requests: "
          f"tokens equal phase 3's; {way}; paged launches {launches} = "
          f"{cfg.n_layers} x {steps} decode steps (phase 3: "
          f"{PHASE3['decode_steps']}); launch wall {wall:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)


def plan_mesh_rank_main(rank: int, init: str, out_dir: str) -> None:
    """One of phase 15 (c)'s two processes: launch.train on a 1x2 mesh
    over gloo, planned and verified strictly, then plainly; the losses,
    gradient norms, installed knobs and decision records go to
    rank{r}.json."""
    import io

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import managed
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as train_cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch_mesh.init_distributed("cuda", init_method=init, rank=rank,
                                 world_size=2)
    cut = dataclasses.replace(configs.get_config("phi4-mini-3.8b"),
                              n_layers=MESH_LAYERS, dtype="float32",
                              attn_impl="auto")
    configs.get_config = lambda name: cut
    metrics = []
    real_build = train_cli.build_train_step

    def build(*a, **k):
        fn = real_build(*a, **k)

        def step(opt, batch):
            opt, m = fn(opt, batch)
            metrics.append({"loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"])})
            return opt, m
        # a mesh of gloo processes: eager, as the launcher prints
        step.step_mode = fn.step_mode
        return step

    train_cli.build_train_step = build
    res = {}
    for name, flags in (("program", ["--plan", "program", "--verify",
                                     "strict"]),
                        ("local", ["--plan", "local", "--verify", "off"])):
        metrics.clear()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with saves_stood_in([]), contextlib.redirect_stdout(buf):
            train_cli.main(["--arch", "phi4-mini-3.8b", "--mesh", "1x2",
                            "--batch", str(MESH_B), "--seq",
                            str(PLAN_MESH_S), "--steps", "1", "--seed",
                            str(SEED), "--ckpt",
                            os.path.join(out_dir, f"ck_{name}")] + flags)
        plan = managed.active_plan()
        res[name] = dict(metrics[0], wall=time.perf_counter() - t0,
                         knobs=None if plan is None else plan.knobs,
                         records=[[r.op, r.axis, r.mode, r.chunks]
                                  for r in managed.decision_log()],
                         text=buf.getvalue())
        managed.install_plan(None)
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()


def plan_mesh(torch, card):
    """(c) a real plan over two ranks on the one card."""
    t0 = time.perf_counter()
    res = run_rank_pair("--plan-mesh-rank", "phase 15 (c)", 600)
    for r in range(2):
        prog, local = res[r]["program"], res[r]["local"]
        knobs = prog["knobs"] or {}
        if "decision program_plan(" not in prog["text"] and r == 0:
            fail(f"(c) rank 0 printed no program_plan line: "
                 f"{prog['text'][-2000:]}")
        if "attention_schedule|model" not in knobs:
            fail(f"(c) rank {r}: the installed plan binds {knobs}, not the "
                 f"model axis's attention schedule")
        knob = knobs["attention_schedule|model"]
        bound = [rec for rec in prog["records"]
                 if rec[:2] == ["attention_schedule", "model"]]
        # the planner's trail record comes first; the model's own follow
        # (their chunks hold the axis size)
        if len(bound) < 2 or any(rec[2] != knob["mode"] for rec in bound):
            fail(f"(c) rank {r}: attention_schedule records {bound} do not "
                 f"carry the plan's knob {knob}")
        if abs(prog["loss"] - local["loss"]) > MESH_LOSS_RTOL * abs(
                local["loss"]):
            fail(f"(c) rank {r}: planned loss {prog['loss']} != plain "
                 f"{local['loss']} (rtol {MESH_LOSS_RTOL})")
        if abs(prog["grad_norm"] - local["grad_norm"]) > MESH_NORM_RTOL * \
                abs(local["grad_norm"]):
            fail(f"(c) rank {r}: planned grad norm {prog['grad_norm']} != "
                 f"plain {local['grad_norm']} (rtol {MESH_NORM_RTOL})")
    p0, l0 = res[0]["program"], res[0]["local"]
    print(f"  (c) launch.train over a 1x2 mesh of two processes (phi4-mini "
          f"full width, {MESH_LAYERS} layers, f32, attn_impl auto, B="
          f"{MESH_B}, S={PLAN_MESH_S}): plan {p0['knobs']}; "
          f"{sum(rec[0] == 'attention_schedule' for rec in p0['records'])} "
          f"attention_schedule records carry it; loss {p0['loss']!r} / "
          f"plain {l0['loss']!r}, grad norm {p0['grad_norm']!r} / "
          f"{l0['grad_norm']!r} (rtol {MESH_LOSS_RTOL} / {MESH_NORM_RTOL}); "
          f"launch walls {p0['wall']:.1f} / {l0['wall']:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)


def kernel_counts() -> tuple:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.kernels import stencil

    return (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES, fa.CARRY_LAUNCHES,
            fa.BWD_BLOCK_LAUNCHES, paged.LAUNCHES, gm.GROUPED_LAUNCHES,
            stencil.STEP_LAUNCHES, stencil.KSWEEP_LAUNCHES)


def plan_workflow(torch, root, card):
    """(d) the paper's workflow: CommRegion.plan on meta specs costs the
    card nothing; then the two examples over two processes."""
    from repro_torch.core import instrument, managed
    from repro_torch.examples import jacobi_mdmp

    t0 = time.perf_counter()
    for ranks, m, n in ((2, 1024, 514), (2, JACOBI_N, JACOBI_N)):
        rows = m // ranks
        torch.cuda.synchronize()
        mem0, c0 = torch.cuda.memory_allocated(), kernel_counts()
        region, plan = jacobi_mdmp.plan_region(ranks, rows, n)
        report = instrument.analyze_region(
            jacobi_mdmp.shard_compute, instrument.Spec((rows, n)),
            instrument.Spec((rows, n)), labels=("u", "f"))
        torch.cuda.synchronize()
        mem1, c1 = torch.cuda.memory_allocated(), kernel_counts()
        if (mem1, c1) != (mem0, c0):
            fail(f"(d) instrumenting the Jacobi region moved the card: "
                 f"memory {mem0} -> {mem1}, launches {c0} -> {c1}")
        k = managed.resolve_halo_aggregation("x", ranks, rows, n).k
        if plan.k_for("halo_agg") != k:
            fail(f"(d) the plan's k {plan.k_for('halo_agg')} != "
                 f"resolve_halo_aggregation's {k} at {rows} x {n}")
        recs = report.records
        if report.total_eqns != 1 or (recs["u"].reads, recs["f"].reads,
                                      recs["u"].writes) != (1, 1, 0):
            fail(f"(d) the stencil region's report {report}")
        print(f"  (d) CommRegion.plan at {rows} x {n} a rank on meta specs: "
              f"k={k} (resolve_halo_aggregation's), card memory "
              f"{mem0} -> {mem1} B, kernel launches unchanged; the report "
              f"counts {report.total_eqns} op (jacobi_step) reading u "
              f"{recs['u'].reads}x and f {recs['f'].reads}x; "
              f"{region.last_report.total_eqns} op in the region's report",
              flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    for example, want in (("jacobi_mdmp", "== one rank"),
                          ("moe_dispatch", "all three dispatch schedules "
                                           "allclose")):
        t1 = time.perf_counter()
        got = subprocess.run([sys.executable, "-m",
                              f"repro_torch.examples.{example}", "--ranks",
                              "2"], env=env, capture_output=True, text=True,
                             timeout=600)
        if got.returncode != 0 or want not in got.stdout:
            fail(f"(d) {example} --ranks 2 on the card: {got.stdout[-2000:]} "
                 f"{got.stderr[-2000:]}")
        for line in got.stdout.splitlines():
            print(f"  {example} --ranks 2: {line}", flush=True)
        if example == "moe_dispatch":
            launches = {}
            for line in got.stdout.splitlines():
                parts = line.split()
                if "grouped-kernel" in parts:
                    launches[parts[0]] = int(parts[-1])
            if launches.get("bulk") != 1 or not launches.get("stream") \
                    or launches.get("dense") != 0:
                fail(f"(d) moe_dispatch's grouped-kernel launches on rank 0 "
                     f"{launches}: want bulk 1, stream > 0, dense 0")
        print(f"  (d) {example} --ranks 2 took "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    print(f"  (d) took {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)


def phase_plan(torch, root, card):
    """Phase 15: the slice's path on the card: the planned, verified and
    traced launchers, a real plan over two ranks, and CommRegion.plan."""
    t15 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    try:
        plan_train(torch, tmp, card)
        plan_serve(torch, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    plan_mesh(torch, card)
    plan_workflow(torch, root, card)
    print(f"  phase 15 took {time.perf_counter() - t15:.1f} s on {card}",
          flush=True)


#: phase 16's band for the dry run's predicted peak memory against
#: torch.cuda.max_memory_allocated() over the same step (two runs on the
#: H100 set it, PERF.md §6: ratios 0.964-0.999; the measured peak also
#: holds what earlier phases leave allocated, 0.4 GB in a whole run)
DRYRUN_PEAK_BAND = 0.08

#: phase 16 (d): production cells counted on abstract tensors (arch,
#: shape, multi-pod); grok-1 stands for the 2x16x16 decode
DRYRUN_CELLS = (("phi4-mini-3.8b", "train_4k", False),
                ("moonshot-v1-16b-a3b", "prefill_32k", False),
                ("mamba2-130m", "long_500k", False),
                ("grok-1-314b", "decode_32k", True))


def dryrun_one_card(arch, kind, b, s):
    """The dry run of one step of ``arch`` at B=b x S=s on one rank (1x1):
    (record, counter)."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, hlo
    from repro_torch.launch.mesh import AXES

    with dryrun.fake_mesh((1, 1), AXES) as ctx:
        counter = dryrun.count_step(configs.get_config(arch),
                                    ShapeConfig(kind, s, b, kind), ctx)
    return hlo.analyze_compiled(counter, 1), counter


def dryrun_check(torch, card, what, rec, counter, want_launches,
                 measured_ms, fastest_ms, measured_peak=None):
    """Launches predicted == measured; the roofline bound of the count at
    or below the fastest measured time; the predicted peak within
    DRYRUN_PEAK_BAND of the measured one (where given)."""
    from repro_torch.core import cost_model as cm

    got = counter.launches()
    if got != want_launches:
        fail(f"(16) {what}: the dry run predicts launches {got}, the card "
             f"launched {want_launches}")
    terms = cm.roofline(rec["flops_per_chip"], rec["hbm_bytes_per_chip"],
                        0.0, 1, cm.H100)
    bound_ms = terms.bound_s * 1e3
    peak = rec["memory"]["peak_bytes"]
    line = (f"  (16) {what}: predicted launches {got} = measured; "
            f"{rec['flops_per_chip']:.4e} flop, "
            f"{rec['hbm_bytes_per_chip']:.4e} B of device memory traffic "
            f"-> H100 bound {bound_ms:.2f} ms ({terms.dominant}; compute "
            f"{terms.compute_s * 1e3:.2f} ms, memory "
            f"{terms.memory_s * 1e3:.2f} ms), measured {measured_ms:.2f} ms "
            f"(fastest {fastest_ms:.2f}): share "
            f"{bound_ms / measured_ms * 100:.1f}%; predicted peak "
            f"{peak / 1e9:.3f} GB")
    if measured_peak is not None:
        line += (f", measured {measured_peak / 1e9:.3f} GB (ratio "
                 f"{peak / measured_peak:.4f})")
    print(line + f" on {card}", flush=True)
    if bound_ms > fastest_ms:
        fail(f"(16) {what}: the bound {bound_ms:.2f} ms exceeds the "
             f"measured {fastest_ms:.2f} ms: the count is wrong")
    if measured_peak is not None and \
            abs(peak / measured_peak - 1.0) > DRYRUN_PEAK_BAND:
        fail(f"(16) {what}: predicted peak {peak} B is not within "
             f"{DRYRUN_PEAK_BAND:.0%} of the measured {measured_peak} B")


def phase_dryrun(torch, card, train):
    """Phase 16: the dry run's counts held against what phases 5 and 8
    measured, and four production cells counted on abstract tensors, with
    the card untouched."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core import cost_model as cm
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_loop import build_train_step

    t16 = time.perf_counter()
    torch.cuda.synchronize()
    mem0, c0 = torch.cuda.memory_allocated(), kernel_counts()
    b, s = TRAIN_ATTN["b"], TRAIN_ATTN["s"]

    # (a) phase 5's training step, (b) its prefill
    rec, counter = dryrun_one_card("phi4-mini-3.8b", "train", b, s)
    fwd, bwd = train["step_counts"][0]
    walls = train["walls_ms"]
    dryrun_check(torch, card, f"(a) phi4-mini-3.8b training step {b} x {s}",
                 rec, counter, {"flash_attention_fwd": fwd,
                                "flash_attention_bwd": bwd},
                 train["ms"], min(walls[2:]), train["steps_peak"])
    rec, counter = dryrun_one_card("phi4-mini-3.8b", "prefill", b, s)
    dryrun_check(torch, card, f"(b) phi4-mini-3.8b prefill_sp {b} x {s}",
                 rec, counter, {"flash_attention_fwd": train["prefill_fwd"]},
                 train["prefill_ms"], train["prefill_ms"],
                 train["prefill_peak"])

    # the counted step is the eager one: on meta tensors nothing captures
    meta = build_train_step(Model(configs.get_reduced("phi4-mini-3.8b"),
                                  device="meta"), AdamWConfig())
    if meta.step_mode != "eager":
        fail(f"(16) a step on meta tensors runs {meta.step_mode}")
    print("  (16) the counted steps run eager (meta tensors), phase 5's as "
          "a captured graph: the counts hold for both", flush=True)

    # (c) phase 8's moonshot prefill (host wall), grouped work at capacity
    p, m = MOE_PREFILL, MOE_MEASURED
    rec, counter = dryrun_one_card("moonshot-v1-16b-a3b", "prefill", p["b"],
                                   p["s"])
    dryrun_check(torch, card, f"(c) moonshot-v1-16b-a3b prefill_sp "
                 f"{p['b']} x {p['s']}", rec, counter,
                 {"flash_attention_fwd": m["launches"]["fwd"],
                  "grouped_expert_ffn": m["launches"]["grouped"]},
                 m["prefill_ms"], m["prefill_ms"])
    rows = sum(k.shapes[0][0] * k.shapes[0][1] for k in counter.kernels
               if k.name == "grouped_expert_ffn")
    print(f"  (16) (c) the grouped work is counted at {rows} capacity rows; "
          f"phase 8's calls kept {m['kept_rows']} of their "
          f"{m['capacity_rows']} capacity rows", flush=True)
    if rows != m["capacity_rows"]:
        fail(f"(16) (c) counted {rows} capacity rows, the card's calls had "
             f"{m['capacity_rows']}")

    # (d) production cells on the fake 256 / 512-rank group
    for arch, shape, multi_pod in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.lower_cell(arch, shape, multi_pod)
        if rec.get("status") != "ok":
            fail(f"(16) (d) {arch} {shape}: {rec}")
        terms = cm.roofline(rec["flops_per_chip"], rec["hbm_bytes_per_chip"],
                            rec["collective_bytes_per_chip"], 1, cm.H100)
        print(f"  (16) (d) {arch} {shape} {rec['mesh']} (rank 0 of "
              f"{rec['n_chips']}): {rec['flops_per_chip']:.4e} flop, "
              f"{rec['hbm_bytes_per_chip']:.4e} B device memory, "
              f"{rec['collective_bytes_per_chip']:.4e} B on the links, peak "
              f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB a chip; H100 "
              f"terms compute {terms.compute_s * 1e3:.2f} / memory "
              f"{terms.memory_s * 1e3:.2f} / collective "
              f"{terms.collective_s * 1e3:.2f} ms, dominant "
              f"{terms.dominant}; counted in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    mem1, c1 = torch.cuda.memory_allocated(), kernel_counts()
    if dist.is_initialized():
        fail("(16) the dry run left a process group behind")
    if (mem1, c1) != (mem0, c0):
        fail(f"(16) the dry run moved the card: memory {mem0} -> {mem1}, "
             f"launches {c0} -> {c1}")
    print(f"  (16) card memory {mem0} -> {mem1} B and every launch count "
          f"unchanged, no process group left; phase 16 took "
          f"{time.perf_counter() - t16:.1f} s on {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 17: nemotron-4-340b (head_dim 192) at full width, cut in depth
# ---------------------------------------------------------------------------

#: phase 17's depth: every width is nemotron's published one; 2 layers
#: in bf16 are 32.7 GB of weights (the embedding and the untied head are
#: 2 x 4.7 B parameters), 1 layer in f32 is 51.6 GB
NEMO_LAYERS = 2
NEMO_PREFILL_S = 4096
NEMO_RING_S = 8192
#: bf16 logits of two attention engines (or schedules) on the same
#: weights, of the largest logit: phase 13's bf16 tolerance
NEMO_BF16_TOL = 2e-2
#: (b): one in this many paged calls of the served run (558 calls on an
#: H100) is held to the plain version
NEMO_PAGED_EVERY = 70
#: (d): prompts and greedy tokens of the f32 parity
NEMO_PARITY = dict(b=4, s=128, new=8)
#: (e): nemotron's reduced config widened to its head_dim (768 / 4 = 192),
#: trained at B=2 x S=2048
NEMO_NARROW = dict(d_model=768, n_heads=4, n_kv_heads=2, d_ff=3072)
NEMO_TRAIN = dict(b=2, s=2048, steps=3)


def nemo_prefill_turns(torch, model, tokens):
    """(a) and (f): prefill_sp with the flash kernels and with the plain
    engine pinned, in turns (kernel, plain, plain, kernel) while
    nvidia-smi reads the SM clock; returns ({engine: [ms, ms]}, [MHz])."""
    def turns():
        ms = {"auto": [], "torch": []}
        for engine in ("auto", "torch", "torch", "auto"):
            model.attn_engine = engine
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill_sp({"tokens": tokens})
            torch.cuda.synchronize()
            ms[engine].append((time.perf_counter() - t0) * 1e3)
        model.attn_engine = "auto"
        return ms

    ms, samples = with_clocks(turns)
    return ms, [mhz for _, mhz, _, _ in samples]


def phase_nemotron(torch, card):
    """Phase 17: nemotron-4-340b at full width through the normal entry
    points, on the flash kernels at head_dim 192."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as paged
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.serve_loop import Generator
    from repro_torch.train.train_loop import build_train_step

    t17 = time.perf_counter()
    full = configs.get_config("nemotron-4-340b")
    cfg = dataclasses.replace(full, n_layers=NEMO_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"  nemotron-4-340b at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff} {cfg.mlp}, vocab {cfg.vocab_size}, untied), "
          f"{cfg.n_layers} of {full.n_layers} layers: "
          f"{cfg.param_count() / 1e9:.2f} B params in bf16, init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    rng = np.random.default_rng(SEED + 17)

    # (a) prefill of 1 x 4096, against the plain engine on the same weights
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size - 1, size=(1, NEMO_PREFILL_S)).astype(
            np.int32)).cuda()
    model.prefill_sp({"tokens": tokens[:, :256]})              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.FWD_LAUNCHES = 0
    logits, _ = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if fa.FWD_LAUNCHES != cfg.n_layers:
        fail(f"(17) (a) prefill launched the flash forward "
             f"{fa.FWD_LAUNCHES} times, not {cfg.n_layers}")
    if tuple(logits.shape) != (1, cfg.padded_vocab):
        fail(f"(17) (a) prefill logits {tuple(logits.shape)}")
    model.attn_engine = "torch"
    plain, _ = model.prefill_sp({"tokens": tokens})
    model.attn_engine = "auto"
    if fa.FWD_LAUNCHES != cfg.n_layers:
        fail("(17) (a) the plain engine launched the flash forward")
    err = rel_check(torch, logits, plain, NEMO_BF16_TOL,
                    "(17) (a) prefill logits, kernels against plain")
    scale = plain.float().abs().max().item()
    del plain
    ms, mhz = nemo_prefill_turns(torch, model, tokens)
    print(f"  (a) prefill_sp 1 x {NEMO_PREFILL_S}: {cfg.n_layers} flash "
          f"forward launches; logits within {err:.3e} of the plain "
          f"engine's (tolerance {NEMO_BF16_TOL} x {scale:.3g}); in turns "
          f"kernel {ms['auto'][0]:.1f} ms, plain {ms['torch'][0]:.1f} / "
          f"{ms['torch'][1]:.1f} ms, kernel {ms['auto'][1]:.1f} ms host wall"
          f" (SM clock {min(mhz, default=0):.0f}-{max(mhz, default=0):.0f} "
          f"MHz over {len(mhz)} reads); peak memory {peak:.2f} GB",
          flush=True)
    del logits

    # (b) the paged ServeEngine on phase 3's request mix
    prompts = make_prompts(cfg.vocab_size)
    plan = paged.launch_plan(
        torch.empty((8, cfg.n_heads, cfg.head_dim), dtype=torch.bfloat16,
                    device="cuda"),
        torch.empty((1, 16, cfg.n_kv_heads, cfg.head_dim),
                    dtype=torch.bfloat16, device="meta"),
        torch.empty((8, 512 // 16), dtype=torch.int32, device="meta"))
    if plan.engine != "mma":
        fail(f"(17) (b) the paged kernel would take {plan} at head_dim 192")
    torch.cuda.reset_peak_memory_stats()
    fa.FWD_LAUNCHES = 0
    got, eng, wall, launches = serve(torch, model, prompts, 32,
                                     schedule="auto")
    way = check_graph(eng, "(17) (b)")
    steps = eng.decode_steps
    s = eng.metrics.summary()
    del eng
    # the same requests with the step run from Python (run_eager): every
    # NEMO_PAGED_EVERY-th paged call's inputs and output are kept (the
    # engine writes its pools in place) and held to the plain version in
    # f32 after the run; a replay runs no Python, so no spy sees its calls
    kept, real = [], paged.paged_attention

    def spy(*args, **kw):
        out = real(*args, **kw)
        if spy.calls % NEMO_PAGED_EVERY == 0:
            kept.append(([a.clone() for a in args], kw, out.clone()))
        spy.calls += 1
        return out

    spy.calls = 0
    paged.paged_attention = spy
    try:
        eager, eng, e_wall, e_launches = serve(torch, model, prompts, 32,
                                               schedule="auto", eager=True)
    finally:
        paged.paged_attention = real
    e_steps = eng.decode_steps
    del eng
    for i, (a, b) in enumerate(zip(got, eager)):
        if not np.array_equal(a, b):
            fail(f"(17) (b) request {i}: graph replays {a.tolist()} != "
                 f"run_eager {b.tolist()}")
    if spy.calls != e_launches or e_launches != cfg.n_layers * e_steps:
        fail(f"(17) (b) run_eager: {spy.calls} paged calls, {e_launches} "
             f"launches, {e_steps} decode steps")
    paged_err, top = 0.0, 0
    for args, kw, out in kept:
        q, kp, vp, table, lens = args
        want = paged.paged_attention_torch(q.float(), kp.float(), vp.float(),
                                           table, lens,
                                           window=kw.get("window", 0))
        try:
            torch.testing.assert_close(out.float(), want, atol=2e-2,
                                       rtol=2e-2)
        except AssertionError as e:
            fail(f"(17) (b) a served paged call (lens "
                 f"{lens.tolist()}) disagrees with the plain version: {e}")
        paged_err = max(paged_err, (out.float() - want).abs().max().item())
        top = max(top, int(lens.max()))
    if len(kept) != -(-spy.calls // NEMO_PAGED_EVERY):
        fail(f"(17) (b) kept {len(kept)} of {spy.calls} paged calls")
    del kept
    for i, toks in enumerate(got):
        if len(toks) != 32 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"(17) (b) request {i} returned {len(toks)} tokens in "
                 f"[{toks.min()}, {toks.max()}]")
    if launches != cfg.n_layers * steps:
        fail(f"(17) (b) paged launches {launches} != {cfg.n_layers} x "
             f"{steps} decode steps")
    if fa.FWD_LAUNCHES:
        fail(f"(17) (b) the engine launched the flash forward "
             f"{fa.FWD_LAUNCHES} times: its prompts go through the paged "
             f"decode step (chunked prefill)")
    print(f"  (b) ServeEngine: 8 requests (prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))}, 32 new each)"
          f" in {wall:.2f} s, mean TTFT {s['mean_ttft_s'] * 1e3:.1f} ms, "
          f"mean TPOT {s['mean_tpot_s'] * 1e3:.2f} ms, {way}; paged launches "
          f"{launches} = {cfg.n_layers} x {steps} decode steps "
          f"(paged_mma_kernel<192>, G = {cfg.n_heads // cfg.n_kv_heads}, "
          f"{plan.n_splits} splits of {plan.pages_per_split} pages, "
          f"{plan.ctas} CTAs at 512 positions), the prompts included "
          f"(chunked prefill through the paged decode step: no flash "
          f"launch); {wall / steps * 1e3:.2f} ms host wall per decode step;"
          f" served again through run_eager ({e_wall:.2f} s, "
          f"{e_wall / e_steps * 1e3:.2f} ms a step): tokens equal the "
          f"replays', and every {NEMO_PAGED_EVERY}th paged call "
          f"({-(-spy.calls // NEMO_PAGED_EVERY)} calls, chains up to {top}) "
          f"within {paged_err:.3e} of the plain version in f32 (atol and "
          f"rtol 2e-2, phase 2's bf16 tolerance); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del got, eager

    # (c) ring attention at one rank, against the megatron prefill
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size - 1, size=(1, NEMO_RING_S)).astype(np.int32)).cuda()
    set_attn_impl(model, "ring")
    model.prefill_sp({"tokens": tokens[:, :256]})              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.FWD_LAUNCHES = fa.CARRY_LAUNCHES = 0
    t0 = time.perf_counter()
    ring, _ = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    if (fa.CARRY_LAUNCHES, fa.FWD_LAUNCHES) != (cfg.n_layers, 0):
        fail(f"(17) (c) ring prefill: carry / flash launches "
             f"{fa.CARRY_LAUNCHES} / {fa.FWD_LAUNCHES}, not "
             f"{cfg.n_layers} / 0")
    set_attn_impl(model, "megatron")
    t0 = time.perf_counter()
    mega, _ = model.prefill_sp({"tokens": tokens})
    torch.cuda.synchronize()
    mega_ms = (time.perf_counter() - t0) * 1e3
    if fa.FWD_LAUNCHES != cfg.n_layers:
        fail("(17) (c) the megatron prefill did not run the flash forward")
    err = rel_check(torch, ring, mega, NEMO_BF16_TOL,
                    "(17) (c) ring prefill logits against megatron's")
    print(f"  (c) attn_impl='ring', 1 rank: prefill_sp 1 x {NEMO_RING_S} in "
          f"{ring_ms:.1f} ms ({cfg.n_layers} carry launches, 0 flash), "
          f"megatron {mega_ms:.1f} ms; logits within {err:.3e} of "
          f"megatron's (tolerance {NEMO_BF16_TOL} x "
          f"{mega.float().abs().max().item():.3g}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del model, ring, mega, tokens
    torch.cuda.empty_cache()

    # (d) 1 layer in f32 (TF32 off): the kernel path against the plain one
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg1 = dataclasses.replace(full, n_layers=1, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg1, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    p = NEMO_PARITY
    prompts = rng.integers(0, cfg1.vocab_size - 1,
                           size=(p["b"], p["s"])).astype(np.int32)
    shape = ShapeConfig("nemo", p["s"] + p["new"], p["b"], "decode")
    runs = {}
    for engine in ("auto", "torch"):
        model.attn_engine = engine
        fa.FWD_LAUNCHES = 0
        logits, _ = model.prefill_sp({"tokens": torch.from_numpy(
            prompts).cuda()})
        gen = Generator(model, shape)
        toks = gen.prefill_generate(prompts, p["new"])
        runs[engine] = (logits, np.asarray(toks), fa.FWD_LAUNCHES)
        nemo_way = check_decode_graph(gen, f"(17) (d) {engine}")
        del gen
    model.attn_engine = "auto"
    (lk, tk, nk), (lp, tp, npl) = runs["auto"], runs["torch"]
    if nk < 2 * cfg1.n_layers or npl:
        fail(f"(17) (d) flash launches {nk} (kernels) / {npl} (plain)")
    err = rel_check(torch, lk, lp, 1e-4,
                    "(17) (d) f32 prefill logits, kernels against plain",
                    floor=1e-30)
    if not np.array_equal(tk, tp):
        fail(f"(17) (d) greedy tokens {tk.tolist()} (kernels) != "
             f"{tp.tolist()} (plain)")
    print(f"  (d) 1 layer in f32 (TF32 off, "
          f"{cfg1.param_count() / 1e9:.2f} B params): prefill logits of "
          f"{p['b']} x {p['s']} within {err:.3e} of the plain engine's "
          f"(tolerance 1e-4 of {lp.abs().max().item():.3g}); "
          f"{p['new']} greedy tokens from each prefill equal ({nemo_way}); "
          f"flash launches {nk} / 0; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del model, runs, lk, lp
    torch.cuda.empty_cache()

    # (e) training at head_dim 192: the reduced config widened
    narrow = dataclasses.replace(configs.get_reduced("nemotron-4-340b"),
                                 name="nemotron-4-340b reduced to hd 192",
                                 **NEMO_NARROW)
    tr = NEMO_TRAIN
    torch.cuda.reset_peak_memory_stats()
    model = Model(narrow, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(SEED))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
    step = build_train_step(model, opt_cfg)
    opt = adamw_init(model.params(), opt_cfg)
    n = narrow.n_layers
    want = (2 * n if narrow.remat else n, n)
    losses, walls = [], []
    for i in range(tr["steps"]):
        batch = family_batch(torch, narrow, tr["b"], tr["s"], SEED + i)
        fa.FWD_LAUNCHES = fa.BWD_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, m = step(opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if (fa.FWD_LAUNCHES, fa.BWD_LAUNCHES) != want:
            fail(f"(17) (e) step {i}: flash launches {fa.FWD_LAUNCHES} / "
                 f"{fa.BWD_LAUNCHES}, not {want}")
    if not all(np.isfinite(losses)):
        fail(f"(17) (e) losses {losses}")
    print(f"  (e) reduced nemotron at head_dim 192 (d_model "
          f"{narrow.d_model}, {narrow.n_heads}/{narrow.n_kv_heads} heads, "
          f"d_ff {narrow.d_ff}, {n} layers, vocab {narrow.vocab_size}, bf16),"
          f" B={tr['b']} x S={tr['s']}: {tr['steps']} AdamW steps, losses "
          f"{[round(x, 4) for x in losses]}, {', '.join(f'{w:.1f}' for w in walls)}"
          f" ms host wall, flash launches {want[0]} / {want[1]} a step; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"{check_train_graph(step, '(17) (e)', tr['steps'] - 1)}",
          flush=True)
    del model, step, opt, batch
    torch.cuda.empty_cache()
    worst = family_parity(torch, dataclasses.replace(narrow, dtype="float32"),
                          tr["b"], tr["s"])
    print(f"  (e) f32: kernels against plain, worst gradient {worst:.2e} "
          f"of its largest magnitude; phase 17 took "
          f"{time.perf_counter() - t17:.1f} s on {card}", flush=True)


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
    counts = hgmma_counts(build, "flash_attention", r"flash_[a-z_]+_kernel")
    for kernel, n in sorted(counts.items()):
        print(f"  {kernel}: {n} HGMMA instructions", flush=True)
    wgmma = [k for k in counts if "_wgmma_" in k]
    if sorted(wgmma) != sorted(FLASH_WGMMA) or not all(
            counts[k] for k in wgmma):
        fail(f"the bf16 forward, carry, backward and block backward "
             f"kernels (hd 64, 128 and 192) must be {FLASH_WGMMA}, each "
             f"on the tensor cores; HGMMA counts {counts}")
    counts = hgmma_counts(build, "grouped_matmul",
                          r"ffn_bwd_[a-z0-9]+_wgmma_kernel")
    for kernel, n in sorted(counts.items()):
        print(f"  {kernel}: {n} HGMMA instructions", flush=True)
    if sorted(counts) != sorted(GROUPED_BWD_WGMMA) or not all(
            counts.values()):
        fail(f"the grouped FFN's tensor-core backward kernels must be "
             f"{GROUPED_BWD_WGMMA}, each on wgmma; HGMMA counts {counts}")

    # the paged bf16 fast path, the grouped tensor-core kernels and the
    # k-sweep kernel's instantiations (their sweeps' windows live in
    # registers): read from the built library, so a cached build is
    # checked too
    checks = (("flash_attention", r"flash_[a-z]+_wgmma_[a-z_]*kernel",
               FLASH_WGMMA),
              ("paged_attention", r"paged_(?:mma|merge)_kernel",
               [f"paged_mma_kernel<{hd}>" for hd in (32, 64, 128, 192)]
               + ["paged_merge_kernel"]),
              ("grouped_matmul", r"ffn_(?:up|down)_wgmma_kernel",
               [f"ffn_up_wgmma_kernel<{a}, {g}>" for a, g in (
                   (0, "true"), (1, "true"), (2, "false"), (3, "false"))]
               + ["ffn_down_wgmma_kernel<bf16>",
                  "ffn_down_wgmma_kernel<float>"]),
              ("grouped_matmul", r"ffn_bwd_[a-z0-9]+_wgmma_kernel",
               GROUPED_BWD_WGMMA),
              ("stencil", r"jacobi_ksweep_kernel",
               [f"jacobi_ksweep_kernel<{t}, {k}>" for t in ("float", "bf16")
                for k in range(1, 9)]))
    for source, kernel, want in checks:
        usage = res_usage(build, source, kernel)
        if sorted(usage) != sorted(want):
            fail(f"cuobjdump -res-usage shows the kernels {sorted(usage)} "
                 f"of {source}.cu, not {want}")
        for name, u in sorted(usage.items()):
            print(f"  {name}: {u.get('reg')} registers, stack "
                  f"{u.get('stack')} B, local {u.get('local')} B "
                  f"(cuobjdump -res-usage)", flush=True)
        if any(u.get("stack", 1) or u.get("local", 1)
               for u in usage.values()):
            fail(f"{source}.cu's fast path spills registers: {usage}")
    grouped = hgmma_counts(build, "grouped_matmul",
                           r"ffn_(?:up|down)_wgmma_kernel")
    print(f"  grouped tensor-core kernels' HGMMA instructions: {grouped}",
          flush=True)
    if len(grouped) != 6 or not all(grouped.values()):
        fail(f"the grouped bf16 kernels must run on the tensor cores; "
             f"HGMMA counts {grouped}")
    print("phase 2: kernels vs plain versions", flush=True)
    main_t, err = phase_kernel(torch)
    partials_t, partials_err_max = phase_paged_partials(torch)
    flash_t, flash_err = phase_flash(torch, 128)
    phase_flash(torch, 192)
    stencil_t, stencil_err = phase_stencil(torch)
    grouped_t, grouped_err = phase_grouped(torch)
    grouped_bwd_t, grouped_bwd_err = phase_grouped_bwd(torch)
    carry_t, carry_err = phase_carry(torch)
    print("phase 3: serve phi4-mini-3.8b at full size", flush=True)
    launches = phase_serve(torch)
    print("phase 4: kernel path vs plain path, end to end", flush=True)
    phase_e2e(torch)
    print("phase 5: train phi4-mini-3.8b at full size", flush=True)
    flash_launches, plain_train = phase_train(torch)
    train_measured = dict(plain_train)
    print("phase 6: training, prefill and generation, kernels vs plain",
          flush=True)
    phase_parity(torch)
    print("phase 7: the paper's Jacobi solve at 16386 x 16386 on one rank",
          flush=True)
    jacobi_launches_run = phase_jacobi(torch)
    print("phase 8: moonshot-v1-16b-a3b (MoE): prefill, serving, training "
          "and parity", flush=True)
    t8 = time.perf_counter()
    with plain_spy() as spy:
        grouped_launches, _ = phase_moe_serve(torch)
        grouped_bwd_launches = phase_moe_train(torch)
    spy.check("phase 8 (prefill, serving, training)")
    phase_moe_parity(torch)
    print("  phase 8: no plain version handed a CUDA tensor on the kernel "
          "path", flush=True)
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s", flush=True)
    print("phase 9: ring attention (context parallelism) on phi4-mini-3.8b",
          flush=True)
    t9 = time.perf_counter()
    ring_launches = phase_ring_prefill_and_train(torch)
    phase_ring_parity(torch)
    print(f"  phase 9 took {time.perf_counter() - t9:.1f} s", flush=True)
    print("phase 10: the examples (quickstart, train_100m)", flush=True)
    t10 = time.perf_counter()
    phase_examples(torch, card)
    print(f"  phase 10 took {time.perf_counter() - t10:.1f} s", flush=True)
    print("phase 11: two ranks on one card (1x2 and 2x1 meshes, serving, "
          "Jacobi)", flush=True)
    mesh_launches = phase_mesh(torch, root, card)
    print("phase 12: MoE across ranks (moonshot-v1-16b-a3b on a 1x2 mesh "
          "of two processes)", flush=True)
    phase_moe_mesh(torch, card)
    print("phase 13: the SSM, hybrid, audio and vision families",
          flush=True)
    phase_families(torch, root, card)
    print("phase 14: pipeline parallelism (one rank; two processes as "
          "stages), the int8 pod reduction, the fault-tolerant loop",
          flush=True)
    phase_pipeline(torch, card, plain_train)
    print("phase 15: the directives, the whole-program planner, the static "
          "verifier and the trace export", flush=True)
    phase_plan(torch, root, card)
    print("phase 16: the dry run (one rank's step counted on abstract "
          "tensors) against phases 5 and 8, and four production cells",
          flush=True)
    phase_dryrun(torch, card, train_measured)
    print("phase 17: nemotron-4-340b (head_dim 192) at full width: prefill, "
          "serving, ring, parity and training", flush=True)
    phase_nemotron(torch, card)
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
               dict(name="paged_attention_partials", route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces="src/repro/kernels/paged_attention.py:152",
                    launches=mesh_launches["paged_partials"],
                    max_abs_err=partials_err_max, **partials_t),
               dict(name="grouped_expert_ffn", route="cuda",
                    source="src/repro_torch/kernels/csrc/grouped_matmul.cu",
                    replaces="src/repro/kernels/grouped_matmul.py:142",
                    launches=grouped_launches, max_abs_err=grouped_err,
                    **grouped_t),
               dict(name="grouped_expert_ffn_bwd", route="cuda",
                    source="src/repro_torch/kernels/csrc/grouped_matmul.cu",
                    replaces="src/repro/kernels/grouped_matmul.py:200",
                    launches=grouped_bwd_launches,
                    max_abs_err=grouped_bwd_err, **grouped_bwd_t),
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
    RANK_MAINS = {"--mesh-rank": mesh_rank_main,
                  "--moe-mesh-rank": moe_mesh_rank_main,
                  "--pipe-mesh-rank": pipe_mesh_rank_main,
                  "--plan-mesh-rank": plan_mesh_rank_main}
    if sys.argv[1:2] and sys.argv[1] in RANK_MAINS:
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "src"))
        rank_main = RANK_MAINS[sys.argv[1]]
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        sys.exit(0)
    sys.exit(main())
