"""Alpha-beta cost model for the managed decisions (port of
``repro.core.cost_model``).

The port prices with an NVIDIA H100 (``H100``, the ``DEFAULT_HW``).
``TPU_V5E`` is kept so tests can hold the port's decisions to the
reference's on the same machine model.  Ported: the collective times and
the generic bulk-vs-interleaved decision (``decide``), and the serve,
preemption, halo, MoE dispatch and attention-schedule decisions, and
the pipeline-schedule and checkpoint-cadence (Young/Daly) decisions, and
the whole-program planner's per-collective components
(``CommComponents``, ``collective_wire_s``, ``collective_msgs``,
``collective_components``), the paper's PingPong model and its two
crossovers (``pingpong_times``, ``crossover_compute_per_element``,
``crossover_compute_chunked``, priced on the paper's machines
``HECTOR_XE6`` / ``HELIOS_BULLX`` / ``JUQUEEN_BGQ``), and the three-term
roofline of a counted step (``RooflineTerms``, ``roofline``; the dry
run's counts come from ``launch/hlo.py``).
The halo-aggregation decision keeps
the reference's formulas; only its fit test prices what the machine's
k-sweep kernel holds on chip (the TPU's whole-row tile, or the CUDA
kernel's shared-memory ring and the deepest k its registers hold: the
``ksweep_*`` fields).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.kernels import stencil

# ---------------------------------------------------------------------------
# Hardware models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Alpha-beta(-gamma) machine description.

    alpha_s:        per-message latency, seconds
    link_bw:        per-link bandwidth, bytes/second
    peak_flops:     per-chip peak (bf16 dense), flop/s
    hbm_bw:         per-chip device-memory bandwidth, bytes/second
    vmem_bytes:     per-core fast-memory capacity (a TPU core's VMEM; on a
                    GPU the shared memory one thread block may use)
    hbm_bytes:      per-chip main memory capacity
    tile_rows:      centre rows of the TPU k-sweep kernel's whole-row
                    tile (its ``(blk_m, N)`` block, in the array's type)
    ksweep_max_k:   the deepest k the CUDA k-sweep kernel takes, whose
                    shared memory (kernels/stencil.py::ksweep_smem_bytes)
                    the fit then prices (0: the TPU kernel, any k)
    """

    name: str
    alpha_s: float
    link_bw: float
    peak_flops: float
    hbm_bw: float
    vmem_bytes: int = 0
    hbm_bytes: int = 0
    issue_overhead_s: float = 1.0e-7
    overlap_eff: float = 1.0
    scalar_flops: float = 0.0
    tile_rows: int = 256
    ksweep_max_k: int = 0


# TPU v5e — the reference's production target (kept for decision parity
# tests; none of its numbers describe the port's hardware).
TPU_V5E = HardwareModel(
    name="tpu_v5e",
    alpha_s=1.0e-6,
    link_bw=50.0e9,
    peak_flops=197.0e12,
    hbm_bw=819.0e9,
    vmem_bytes=128 * 1024 * 1024,
    hbm_bytes=16 * 1024 ** 3,
)

# NVIDIA H100 SXM, data-sheet values: 989 TFLOP/s dense bf16, 3.35 TB/s
# HBM3, 80 GB, 227 KB of shared memory per thread block, NVLink 450 GB/s
# each way; the k-sweep fit is the CUDA kernel's
# (kernels/stencil.py::ksweep_smem_bytes).  alpha_s is a placeholder
# until the torch.distributed collectives measure it; the one-card
# serving path never prices it except in the swap term's per-chunk
# latency.
H100 = HardwareModel(
    name="h100_sxm",
    alpha_s=1.0e-6,
    link_bw=450.0e9,
    peak_flops=989.0e12,
    hbm_bw=3.35e12,
    vmem_bytes=227 * 1024,
    hbm_bytes=80 * 10 ** 9,
    ksweep_max_k=stencil.KSWEEP_MAX_K,
)

# The paper's evaluation machines, with representative 2013-era constants
# (interconnect latency / bandwidth from published specs), as the
# reference keeps them: the paper-reproduction crossovers read them
# (HECToR/JUQUEEN cross over, HELIOS's network without asynchronous
# progress does not).  ``scalar_flops`` is the delay loop's one-core rate.
HECTOR_XE6 = HardwareModel(
    name="hector_cray_xe6", alpha_s=1.5e-6, link_bw=5.0e9,
    peak_flops=147.2e9 * 32, hbm_bw=85.0e9,
    issue_overhead_s=2.0e-7, overlap_eff=1.0, scalar_flops=2.3e9)
HELIOS_BULLX = HardwareModel(
    name="helios_bullx_b510", alpha_s=1.2e-6, link_bw=4.0e9,
    peak_flops=2.7e9 * 8 * 16, hbm_bw=102.0e9,
    # the paper found MPI always beat MDMP on HELIOS: its MPI did not
    # progress non-blocking messages asynchronously -> no overlap benefit
    issue_overhead_s=2.0e-7, overlap_eff=0.0, scalar_flops=2.7e9)
JUQUEEN_BGQ = HardwareModel(
    name="juqueen_bgq", alpha_s=2.5e-6, link_bw=2.0e9,
    peak_flops=204.8e9, hbm_bw=42.6e9,
    issue_overhead_s=4.0e-7, overlap_eff=1.0, scalar_flops=1.6e9)

DEFAULT_HW = H100


# ---------------------------------------------------------------------------
# Collective cost primitives (ring algorithms, as the reference's managed
# collectives emit them)
# ---------------------------------------------------------------------------


def ring_all_gather_time(nbytes_shard: float, n: int, hw: HardwareModel,
                         chunks: int = 1) -> float:
    """Ring all-gather of an ``nbytes_shard`` shard across ``n`` ranks."""
    if n <= 1:
        return 0.0
    steps = (n - 1) * max(1, chunks)
    return steps * hw.alpha_s + (n - 1) * nbytes_shard / hw.link_bw


def ring_reduce_scatter_time(nbytes_full: float, n: int, hw: HardwareModel,
                             chunks: int = 1) -> float:
    """Ring reduce-scatter of an ``nbytes_full`` operand across ``n``
    ranks."""
    if n <= 1:
        return 0.0
    shard = nbytes_full / n
    steps = (n - 1) * max(1, chunks)
    return steps * hw.alpha_s + (n - 1) * shard / hw.link_bw


def ring_all_reduce_time(nbytes: float, n: int, hw: HardwareModel,
                         chunks: int = 1) -> float:
    """RS + AG ring all-reduce."""
    return (ring_reduce_scatter_time(nbytes, n, hw, chunks)
            + ring_all_gather_time(nbytes / max(n, 1), n, hw, chunks))


def all_to_all_time(nbytes_local: float, n: int, hw: HardwareModel,
                    chunks: int = 1) -> float:
    """Ring-style all-to-all: each rank exchanges 1/n of its local operand
    with every peer ((n-1) permute steps of nbytes_local/n each)."""
    if n <= 1:
        return 0.0
    steps = (n - 1) * max(1, chunks)
    return steps * hw.alpha_s + (n - 1) * (nbytes_local / n) / hw.link_bw


def point_to_point_time(nbytes: float, hw: HardwareModel,
                        messages: int = 1) -> float:
    """The paper's PingPong primitive: ``messages`` sends carrying
    ``nbytes`` total."""
    return messages * hw.alpha_s + nbytes / hw.link_bw


def _pipeline_time(comm_total: float, compute_total: float, stages: int,
                   alpha: float, per_stage_msgs: int = 1) -> float:
    """Pipelined schedule over ``stages`` equal stages: comm of stage i
    overlaps compute of stage i-1 (the classic software-pipeline bound
    ``c + k + (stages-1) * max(c, k)`` plus every message's latency)."""
    if stages <= 1:
        return comm_total + compute_total + alpha * per_stage_msgs
    c = comm_total / stages
    k = compute_total / stages
    latency = alpha * per_stage_msgs * stages
    return c + k + (stages - 1) * max(c, k) + latency


# ---------------------------------------------------------------------------
# Bulk vs interleaved decision (the "managed" in MDMP)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduleDecision:
    mode: str                 # "bulk" | "interleaved"
    chunks: int               # ring sub-chunks per step (1 = plain ring)
    bulk_time_s: float        # predicted comm+compute, bulk schedule
    interleaved_time_s: float  # predicted comm+compute, chosen interleave
    comm_time_s: float        # raw transfer time of the collective
    compute_time_s: float     # compute available for overlap

    @property
    def predicted_speedup(self) -> float:
        if self.interleaved_time_s <= 0:
            return 1.0
        return self.bulk_time_s / self.interleaved_time_s


def decide(nbytes: float, axis_size: int, *, compute_time_s: float = 0.0,
           hw: HardwareModel = DEFAULT_HW,
           collective: str = "all_gather",
           candidate_chunks: Sequence[int] = (1, 2, 4),
           force_mode: str | None = None) -> ScheduleDecision:
    """Pick bulk vs interleaved (and a chunk count) for one managed call
    site.

    ``nbytes``          bytes of the *sharded* operand that each step moves
                        (AG: shard bytes; RS/AR: full bytes; A2A: local
                        bytes).
    ``compute_time_s``  the compute adjacent to this collective that an
                        interleaved schedule can hide.
    """
    n = max(1, axis_size)
    timer = {
        "all_gather": ring_all_gather_time,
        "reduce_scatter": ring_reduce_scatter_time,
        "all_reduce": ring_all_reduce_time,
        "all_to_all": all_to_all_time,
    }[collective]

    comm_bulk = timer(nbytes, n, hw, 1)
    bulk_total = comm_bulk + compute_time_s

    best_mode, best_chunks, best_time = "bulk", 1, bulk_total
    if n > 1:
        ring_steps = n - 1
        for c in candidate_chunks:
            comm_c = timer(nbytes, n, hw, c)
            stages = ring_steps * c
            t = _pipeline_time(comm_c - stages * hw.alpha_s, compute_time_s,
                               stages, hw.alpha_s)
            if t < best_time * (1.0 - 1e-9):
                best_mode, best_chunks, best_time = "interleaved", c, t

    if force_mode == "bulk":
        best_mode, best_chunks, best_time = "bulk", 1, bulk_total
    elif force_mode == "interleaved" and best_mode == "bulk":
        best_mode = "interleaved"
        best_chunks = 1
        comm_c = timer(nbytes, n, hw, 1)
        stages = max(1, (n - 1))
        best_time = _pipeline_time(comm_c - stages * hw.alpha_s,
                                   compute_time_s, stages, hw.alpha_s)

    return ScheduleDecision(
        mode=best_mode, chunks=best_chunks,
        bulk_time_s=bulk_total, interleaved_time_s=best_time,
        comm_time_s=comm_bulk, compute_time_s=compute_time_s)


# ---------------------------------------------------------------------------
# Serving schedule decision (static waves vs continuous batching, quantum C)
def pingpong_times(n_elements: int, delay_elements: float,
                   hw: HardwareModel = DEFAULT_HW,
                   nbytes_per_element: float = 4.0,
                   flops_per_delay_element: float = 1.0,
                   sent_elements: int | None = None
                   ) -> tuple[float, float]:
    """LogP-flavoured model of the paper's (Selective)DelayPingPong family.

    One half-iteration copies ``n_elements`` between buffers with
    ``delay_elements`` adds of artificial compute per element, and sends
    ``sent_elements`` of them (default: all).

    bulk (MPI baseline): compute fully, then one message —
        T = compute + alpha + bytes/bw
    fine (MDMP): one message per sent element, issued as its last write
    retires; transfers progress asynchronously with efficiency
    ``hw.overlap_eff`` while the remaining compute runs —
        T = compute_exposed + per-message issue overhead
            + un-overlappable message time.
    A machine without a scalar rate (``scalar_flops`` 0, the H100) prices
    the delay loop at its peak.  Returns (bulk_s, fine_s)."""
    scalar = hw.scalar_flops or hw.peak_flops
    t_el = delay_elements * flops_per_delay_element / scalar
    s = n_elements if sent_elements is None else sent_elements
    compute = n_elements * t_el
    msg_bytes = s * nbytes_per_element

    bulk = compute + hw.alpha_s + msg_bytes / hw.link_bw

    per_msg = hw.alpha_s + nbytes_per_element / hw.link_bw
    transfer = s * per_msg
    overhead = s * hw.issue_overhead_s
    hidden = hw.overlap_eff * min(transfer, compute)
    fine = compute + overhead + (transfer - hidden)
    return bulk, fine


def _crossover(diff) -> float:
    """The least delay per element at which ``diff`` (fine - bulk) is <=
    0, by bisection over [0, 1e9]; ``inf`` when fine never wins."""
    lo, hi = 0.0, 1e9
    if diff(hi) > 0:
        return math.inf
    if diff(lo) <= 0:
        return 0.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if diff(mid) <= 0:
            hi = mid
        else:
            lo = mid
    return hi


def crossover_compute_per_element(n_elements: int,
                                  hw: HardwareModel = DEFAULT_HW,
                                  nbytes_per_element: float = 4.0,
                                  sent_elements: int | None = None) -> float:
    """The paper's DelayPingPong crossover (Fig 5b/6b): the number of
    delay elements per communicated element above which MDMP's
    fine-grained intermingled messaging beats the bulk message.  Returns
    ``inf`` when fine-grained never wins (the paper's HELIOS result)."""
    def diff(d: float) -> float:
        bulk, fine = pingpong_times(n_elements, d, hw,
                                    nbytes_per_element,
                                    sent_elements=sent_elements)
        return fine - bulk

    return _crossover(diff)


def crossover_compute_chunked(n_elements: int, chunks: int,
                              hw: HardwareModel = DEFAULT_HW,
                              nbytes_per_element: float = 4.0) -> float:
    """The crossover when messages are intermingled at *tile* granularity
    (``chunks`` messages of n/chunks elements) instead of the paper's
    per-element messages: per-message overheads amortise over the tile,
    so the crossover exists at realistic constants.  Returns
    delay-elements-per-element at which chunked-interleaved beats bulk."""
    scalar = hw.scalar_flops or hw.peak_flops
    msg_bytes = n_elements * nbytes_per_element

    def diff(d: float) -> float:
        compute = n_elements * d / scalar
        bulk = compute + hw.alpha_s + msg_bytes / hw.link_bw
        per_chunk = hw.alpha_s + (msg_bytes / chunks) / hw.link_bw
        transfer = chunks * per_chunk
        hidden = hw.overlap_eff * min(transfer * (chunks - 1) / chunks,
                                      compute)
        fine = compute + chunks * hw.issue_overhead_s + transfer - hidden
        return fine - bulk

    return _crossover(diff)


# ---------------------------------------------------------------------------
#
# Per-engine-step time is the decode roofline: every step streams the
# weights once from HBM and does 2*N flops per slot-token —
# max(P_bytes/hbm_bw, 2*N*B/peak).  The scheduler seeds C and the mode
# from this model and corrects both online from the measured step-latency
# counters (serve/metrics.py) — the paper's iteration-(k)->(k+1) loop.


#: default per-dispatch overhead (host scheduling + launch) used when no
#: measurement is available yet
DISPATCH_OVERHEAD_S = 1.0e-4


@dataclasses.dataclass(frozen=True)
class ServeScheduleDecision:
    """Outcome of the serve-schedule decision for one serving call site."""
    mode: str                      # "static" | "continuous"
    chunk: int                     # scheduling quantum C (tokens/slot/call)
    tok_s: dict[str, float]        # "mode:C" -> modeled useful tokens/s
    static_tok_s: float            # best static variant
    chosen_tok_s: float
    step_s: float                  # per-engine-step seconds (whole batch)
    dispatch_s: float              # per-quantum dispatch overhead
    ttft_s: float                  # modeled mean TTFT at the chosen schedule

    @property
    def predicted_speedup(self) -> float:
        if self.chosen_tok_s <= 0:
            return 1.0
        return self.chosen_tok_s / max(self.static_tok_s, 1e-30)


def serve_step_time(n_params: float, batch_slots: int, *,
                    dtype_bytes: int = 2,
                    hw: HardwareModel = DEFAULT_HW) -> float:
    """Decode-step roofline: one token for each of ``batch_slots`` slots
    streams the weights once from HBM (memory-bound at small batch) against
    2*N flops per slot-token (compute-bound once the batch is large)."""
    mem = n_params * dtype_bytes / hw.hbm_bw
    flops = 2.0 * n_params * max(1, batch_slots) / hw.peak_flops
    return max(mem, flops)


def serve_schedule_times(n_params: float, batch_slots: int,
                         mean_prompt: float, mean_new: float, *,
                         max_prompt: float | None = None,
                         dtype_bytes: int = 2,
                         hw: HardwareModel = DEFAULT_HW,
                         dispatch_s: float = DISPATCH_OVERHEAD_S,
                         measured_step_s: float | None = None,
                         measured_dispatch_s: float | None = None,
                         candidate_chunks: Sequence[int] = (1, 2, 4, 8, 16,
                                                            32)
                         ) -> tuple[dict[str, float], float, float]:
    """(variant -> useful tokens/s, step_s, dispatch_s) for every
    "mode:C" candidate.  Measured overrides replace the modeled roofline
    terms (metrics.py feeds them back between quanta)."""
    b = max(1, batch_slots)
    step = measured_step_s if measured_step_s is not None else \
        serve_step_time(n_params, b, dtype_bytes=dtype_bytes, hw=hw)
    disp = measured_dispatch_s if measured_dispatch_s is not None \
        else dispatch_s
    mean_total = max(1.0, float(mean_prompt) + float(mean_new))
    max_total = max(mean_total,
                    float(max_prompt if max_prompt is not None
                          else mean_prompt) + float(mean_new))
    times: dict[str, float] = {}
    for c in sorted({int(c) for c in candidate_chunks if c >= 1}):
        quantum = disp + c * step
        # static: padding to the wave's longest request is the only waste
        occ_static = mean_total / max_total
        times[f"static:{c}"] = b * c * occ_static / quantum
        # continuous: a request completing mid-quantum idles its slot for
        # C/2 steps on average before the boundary refill
        occ_cont = max(0.0, 1.0 - 0.5 * c / mean_total)
        times[f"continuous:{c}"] = b * c * occ_cont / quantum
    return times, step, disp


def serve_ttft_s(chunk: int, mean_prompt: float, step_s: float,
                 dispatch_s: float) -> float:
    """Modeled TTFT for a request admitted from the queue: half a quantum
    of boundary wait plus the prompt steps (each quantum pays one
    dispatch)."""
    c = max(1, int(chunk))
    quanta = math.ceil(max(1.0, float(mean_prompt)) / c)
    return 0.5 * (dispatch_s + c * step_s) + quanta * dispatch_s \
        + float(mean_prompt) * step_s


def decide_serve_schedule(n_params: float, batch_slots: int,
                          mean_prompt: float, mean_new: float, *,
                          max_prompt: float | None = None,
                          dtype_bytes: int = 2,
                          hw: HardwareModel = DEFAULT_HW,
                          dispatch_s: float = DISPATCH_OVERHEAD_S,
                          measured_step_s: float | None = None,
                          measured_dispatch_s: float | None = None,
                          candidate_chunks: Sequence[int] = (1, 2, 4, 8, 16,
                                                             32),
                          ttft_budget_s: float | None = None,
                          force_mode: str | None = None,
                          force_chunk: int | None = None
                          ) -> ServeScheduleDecision:
    """Pick the batching mode and scheduling quantum for one serving call
    site.  ``force_mode``/``force_chunk`` pin the choice (an MDMPConfig
    bulk override, or an explicit caller pin) while still reporting the
    modeled table; a ``ttft_budget_s`` drops continuous candidates whose
    modeled TTFT overruns it (the smallest candidate always survives)."""
    times, step, disp = serve_schedule_times(
        n_params, batch_slots, mean_prompt, mean_new,
        max_prompt=max_prompt, dtype_bytes=dtype_bytes, hw=hw,
        dispatch_s=dispatch_s, measured_step_s=measured_step_s,
        measured_dispatch_s=measured_dispatch_s,
        candidate_chunks=candidate_chunks)

    def ttft(c: int) -> float:
        return serve_ttft_s(c, mean_prompt, step, disp)

    chunks = sorted({int(v.split(":")[1]) for v in times})
    static_best = max((times[f"static:{c}"], c) for c in chunks)
    cont_ok = [c for c in chunks
               if ttft_budget_s is None or ttft(c) <= ttft_budget_s]
    if not cont_ok:
        cont_ok = [min(chunks)]
    cont_best = max((times[f"continuous:{c}"], c) for c in cont_ok)

    mode, chunk = (("continuous", cont_best[1])
                   if cont_best[0] > static_best[0]
                   else ("static", static_best[1]))
    if force_mode is not None:
        if force_mode not in ("static", "continuous"):
            raise ValueError(f"unknown serve schedule {force_mode!r}")
        mode = force_mode
        chunk = (cont_best if mode == "continuous" else static_best)[1]
    if force_chunk is not None:
        chunk = max(1, int(force_chunk))
        if f"{mode}:{chunk}" not in times:
            times[f"{mode}:{chunk}"] = serve_schedule_times(
                n_params, batch_slots, mean_prompt, mean_new,
                max_prompt=max_prompt, dtype_bytes=dtype_bytes, hw=hw,
                dispatch_s=dispatch_s, measured_step_s=measured_step_s,
                measured_dispatch_s=measured_dispatch_s,
                candidate_chunks=(chunk,))[0][f"{mode}:{chunk}"]
    return ServeScheduleDecision(
        mode=mode, chunk=chunk, tok_s=times,
        static_tok_s=static_best[0], chosen_tok_s=times[f"{mode}:{chunk}"],
        step_s=step, dispatch_s=disp, ttft_s=ttft(chunk))


# ---------------------------------------------------------------------------
# Preemption decision (swap vs drop-and-recompute vs head-of-line wait)
# ---------------------------------------------------------------------------
#
#   swap       — D2H the victim's page chain (row-sliced chunks metered
#                by overlap.drain_chunk_bytes), H2D it back on
#                re-admission.  Cost: 2 * KV bytes over the host-link
#                bandwidth (measured from prior swaps when available)
#                plus per-chunk alpha.
#   recompute  — release the pages and rebuild the victim as a
#                prompt+generated continuation: the KV is re-earned by
#                prefill-replay FLOPs, 2*N per replayed token.
#   wait       — evict nobody: stall the growing slot for a quantum and
#                let retirements free pages naturally (the soonest-
#                finishing other slot's remaining steps at the measured
#                step time); infinite when every slot is stalled.


#: default D2H/H2D bandwidth for KV swap traffic before any transfer has
#: been measured (a PCIe gen4 x16 host link; the measured swap bandwidth
#: replaces it after the first swap)
PCIE_BW = 1.6e10


@dataclasses.dataclass(frozen=True)
class PreemptDecision:
    """Outcome of the preemption-policy decision for one overload event."""
    policy: str                    # "swap" | "recompute" | "wait"
    victim_pages: int
    swap_bytes: int                # KV bytes resident in the victim chain
    chunk_bytes: int               # metered D2H slice size
    pcie_bw: float                 # bytes/s (measured or default)
    replay_tokens: int
    times: dict[str, float]        # policy -> predicted seconds
    recompute_s: float             # the unmanaged drop-everything baseline
    chosen_s: float

    @property
    def predicted_speedup(self) -> float:
        """Modeled gain over always-drop-and-recompute."""
        return max(self.recompute_s, 1e-12) / max(self.chosen_s, 1e-12)


def decide_preempt(victim_pages: int, page_bytes: int,
                   replay_tokens: int, n_params: float, *,
                   step_s: float | None = None,
                   batch_slots: int = 1, dtype_bytes: int = 2,
                   pcie_bw: float | None = None,
                   chunk_bytes: int | None = None,
                   wait_s: float | None = None,
                   allow_swap: bool = True,
                   hw: HardwareModel = DEFAULT_HW,
                   force_policy: str | None = None) -> PreemptDecision:
    """Pick the preemption policy for one pool-exhaustion event.

    ``victim_pages``/``page_bytes`` size the swap transfer (both
    directions), ``replay_tokens`` the prefill-replay FLOPs, ``wait_s``
    the instrumented head-of-line estimate (None = nothing will free —
    waiting can't help).  ``chunk_bytes`` is the metered D2H slice
    (overlap.drain_chunk_bytes); when absent the same budget formula is
    applied to the step time.  ``allow_swap=False`` removes swap from
    the candidate set.  ``force_policy`` pins the choice while still
    reporting the modeled table."""
    bw = float(pcie_bw) if pcie_bw else PCIE_BW
    step = (float(step_s) if step_s is not None else
            serve_step_time(n_params, batch_slots,
                            dtype_bytes=dtype_bytes, hw=hw))
    swap_bytes = int(victim_pages) * int(page_bytes)
    if chunk_bytes is None:
        # overlap.drain_chunk_bytes' budget formula, inlined to keep the
        # cost model import-cycle-free (budget=0.1 of one step)
        chunk_bytes = max(1 << 16, min(1 << 27, int(0.1 * step * bw)))
    chunk_bytes = max(1, int(chunk_bytes))
    n_chunks = max(1, math.ceil(max(1, swap_bytes) / chunk_bytes))
    times = {
        "swap": (2.0 * swap_bytes / bw + 2.0 * n_chunks * hw.alpha_s
                 if allow_swap else math.inf),
        "recompute": 2.0 * max(0, replay_tokens) * max(n_params, 1.0)
        / hw.peak_flops,
        "wait": float(wait_s) if wait_s is not None else math.inf,
    }
    recompute_s = times["recompute"]
    if force_policy is not None:
        if force_policy not in times:
            raise ValueError(f"unknown preempt policy {force_policy!r}")
        policy = force_policy
    else:
        policy = min(times, key=lambda p: (times[p], p))
    chosen = times[policy]
    if not math.isfinite(chosen):
        # a pinned-but-impossible policy (wait with nothing retiring)
        # degrades to the always-possible rebuild
        policy, chosen = "recompute", recompute_s
    return PreemptDecision(
        policy=policy, victim_pages=int(victim_pages),
        swap_bytes=swap_bytes, chunk_bytes=chunk_bytes, pcie_bw=bw,
        replay_tokens=int(replay_tokens), times=times,
        recompute_s=recompute_s, chosen_s=chosen)


# ---------------------------------------------------------------------------
# Halo aggregation decision (the paper's message-AGGREGATION knob)
# ---------------------------------------------------------------------------
#
# MDMP's manager may also COARSEN communication: when per-message latency
# (alpha) dominates, ship one k-row halo slab per k iterations instead of a
# 1-row slab per iteration, and redundantly compute the ghost trapezoid.
# Per sweep, for a (rows x cols) local block:
#
#   comm(k)  = 2*alpha/k + 2*cols*B/link_bw        alpha amortised k x;
#                                                  halo bytes/sweep constant
#   mem(k)   = (3*rows + 4*k)*cols*B/(k*hbm_bw)    the temporally-blocked
#                                                  kernel streams the tile
#                                                  once per k sweeps
#   flops(k) = (rows + 2*(k-1))*cols*c/peak        redundant ghost rows
#
#   t(k)     = max(mem, flops) + comm
#
# k=1 is exactly the bulk schedule.  What the k-sweep kernel holds on
# chip caps k: on a TPU its tile of 3 resident arrays, (min(rows, 256) +
# 2k) x cols in the array's type, against VMEM; on the card the CUDA
# kernel's shared-memory ring against a block's shared memory, and the
# deepest k whose sweeps' windows its registers hold.


#: flops per grid point of the 5-point Jacobi update (4 adds + 1 mul + ...)
JACOBI_FLOPS_PER_POINT = 6.0


@dataclasses.dataclass(frozen=True)
class HaloAggregationDecision:
    """Outcome of the aggregation decision for one halo call site."""
    k: int                        # chosen sweeps per exchange (1 = bulk)
    per_sweep_s: dict[int, float]  # candidate k -> predicted seconds/sweep
    bulk_sweep_s: float           # t(1)
    aggregated_sweep_s: float     # t(k chosen)
    comm_sweep_s: float           # comm term at chosen k
    mem_sweep_s: float            # memory term at chosen k
    flop_sweep_s: float           # redundant-compute term at chosen k

    @property
    def mode(self) -> str:
        return "aggregated" if self.k > 1 else "bulk"

    @property
    def predicted_speedup(self) -> float:
        if self.aggregated_sweep_s <= 0:
            return 1.0
        return self.bulk_sweep_s / self.aggregated_sweep_s


def halo_sweep_terms(k: int, rows_local: int, cols: int, *,
                     dtype_bytes: int = 4, hw: HardwareModel = DEFAULT_HW,
                     flops_per_point: float = JACOBI_FLOPS_PER_POINT,
                     axis_size: int = 2) -> tuple[float, float, float]:
    """(comm_s, mem_s, flops_s) per sweep of the k-aggregated schedule.
    With ``axis_size <= 1`` no bytes cross a link, so the comm term drops
    and only the temporal-blocking (HBM) saving remains."""
    k = max(1, k)
    halo_bytes = cols * dtype_bytes
    comm = (0.0 if axis_size <= 1
            else 2.0 * hw.alpha_s / k + 2.0 * halo_bytes / hw.link_bw)
    mem = ((3.0 * rows_local + 4.0 * k) * cols * dtype_bytes
           / (k * hw.hbm_bw))
    flops = ((rows_local + 2.0 * (k - 1)) * cols * flops_per_point
             / hw.peak_flops)
    return comm, mem, flops


def halo_sweep_time(k: int, rows_local: int, cols: int, *,
                    dtype_bytes: int = 4, hw: HardwareModel = DEFAULT_HW,
                    flops_per_point: float = JACOBI_FLOPS_PER_POINT,
                    axis_size: int = 2) -> float:
    comm, mem, flops = halo_sweep_terms(
        k, rows_local, cols, dtype_bytes=dtype_bytes, hw=hw,
        flops_per_point=flops_per_point, axis_size=axis_size)
    return max(mem, flops) + comm


def halo_tile_bytes(k: int, rows_local: int, cols: int, *,
                    dtype_bytes: int = 4,
                    hw: HardwareModel = DEFAULT_HW) -> int:
    """Fast-memory bytes the k-sweep kernel holds: the TPU kernel's three
    whole-row tiles (u in and out, and f), or the shared memory a CTA of
    the CUDA kernel opts into (kernels/stencil.py::ksweep_smem_bytes)."""
    if hw.ksweep_max_k:
        return stencil.ksweep_smem_bytes(k, dtype_bytes)
    rows = min(rows_local, hw.tile_rows) + 2 * k
    return 3 * rows * cols * dtype_bytes


def decide_halo_aggregation(rows_local: int, cols: int, axis_size: int, *,
                            dtype_bytes: int = 4,
                            hw: HardwareModel = DEFAULT_HW,
                            candidate_k: Sequence[int] = (1, 2, 4, 8),
                            flops_per_point: float = JACOBI_FLOPS_PER_POINT,
                            force_k: int | None = None
                            ) -> HaloAggregationDecision:
    """Pick how many sweeps each halo exchange should carry.

    Candidates are dropped when what the k-sweep kernel holds no longer
    fits the machine's fast memory (``halo_tile_bytes``), when k is
    deeper than the machine's kernel takes, or when k exceeds the
    local block (the ghost trapezoid would swallow the whole shard); k=1
    is the plain bulk schedule and always survives.  ``axis_size=1``
    still aggregates — the HBM-round-trip saving is local — but its comm
    term is zero.  ``force_k`` is clamped to the same validity caps, so
    the returned k is always safe to feed to ``halo.jacobi_solve``.
    """
    def sweep_time(k: int) -> float:
        return halo_sweep_time(
            k, rows_local, cols, dtype_bytes=dtype_bytes, hw=hw,
            flops_per_point=flops_per_point, axis_size=axis_size)

    def valid(k: int) -> bool:
        if k > max(1, rows_local):
            return False
        if hw.ksweep_max_k and k > hw.ksweep_max_k:
            return False
        if k > 1 and hw.vmem_bytes and halo_tile_bytes(
                k, rows_local, cols, dtype_bytes=dtype_bytes,
                hw=hw) > hw.vmem_bytes:
            return False
        return True

    times = {k: sweep_time(k) for k in sorted({1, *candidate_k})
             if k >= 1 and valid(k)}
    if force_k is not None:
        best_k = max(1, int(force_k))
        while best_k > 1 and not valid(best_k):
            best_k -= 1
        times.setdefault(best_k, sweep_time(best_k))
    else:
        best_k = min(times, key=lambda k: (times[k], k))
    comm, mem, flops = halo_sweep_terms(
        best_k, rows_local, cols, dtype_bytes=dtype_bytes, hw=hw,
        flops_per_point=flops_per_point, axis_size=axis_size)
    return HaloAggregationDecision(
        k=best_k, per_sweep_s=times,
        bulk_sweep_s=times.get(1, sweep_time(1)),
        aggregated_sweep_s=times[best_k],
        comm_sweep_s=comm, mem_sweep_s=mem, flop_sweep_s=flops)


# ---------------------------------------------------------------------------
# MoE dispatch decision (bulk a2a vs chunked-stream vs dense-fallback,
# plus the capacity factor itself)
# ---------------------------------------------------------------------------
#
# Three schedules share the knob:
#
#   bulk    one all_to_all of the [E, C, D] capacity buffers each way
#           around the expert FFN (the unmanaged baseline); the grouped
#           GEMM computes the kept rows only.
#   stream  the capacity buffers split into g chunks per ring block and
#           sent around the EP axis, each chunk's transfer issued before
#           the previous chunk's expert FFN: same bytes, wire hidden under
#           compute, (n-1)*g pipeline stages of 2 messages.
#   dense   no dispatch: all-gather the t*D tokens, every rank runs its
#           LOCAL experts on the full token set gate-masked,
#           reduce-scatter the outputs.  Capacity-free: never drops a
#           token.
#
# With no routing measurement the declared capacity factor stands; a
# measured imbalance re-picks the smallest candidate that covers it.


@dataclasses.dataclass(frozen=True)
class MoEDispatchDecision:
    """Outcome of the three-way MoE dispatch decision for one call site."""
    schedule: str                  # "bulk" | "stream" | "dense"
    g: int                         # stream chunks per ring block (1 else)
    capacity_factor: float         # chosen cf (declared or re-resolved)
    capacity: int                  # C = ceil(t * K * cf / E)
    times_s: dict[str, float]      # "schedule:g" -> predicted seconds/layer
    bulk_s: float
    chosen_s: float
    comm_s: float                  # comm term of the chosen schedule
    compute_s: float               # expert-FFN term of the chosen schedule
    drop_frac: float               # modeled residual drop rate at chosen cf
    a2a_bytes: int                 # per-direction capacity-buffer bytes
    dense_bytes: int               # per-rank token bytes of the fallback

    @property
    def predicted_speedup(self) -> float:
        if self.chosen_s <= 0:
            return 1.0
        return self.bulk_s / self.chosen_s


def moe_capacity(tokens_local: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """ceil-rounded per-expert capacity (moe.dispatch.capacity_for)."""
    return max(1, math.ceil(tokens_local * top_k * capacity_factor
                            / n_experts))


def _moe_terms(tokens_local: int, d_model: int, n_experts: int,
               top_k: int, d_ff_expert: int, n: int, mults: int,
               dtype_bytes: int, capacity_factor: float, layout: str,
               hw: HardwareModel) -> tuple[int, float, float, float]:
    """(capacity C, per-row FFN flops, capacity-path comm seconds, dense
    FFN seconds) of one layout.

    ep_a2a     experts sharded by id: dispatch = 2 x a2a of the [E, C, D]
               capacity buffers (C from LOCAL tokens); each kept row
               costs the full-F expert FFN; dense = AG(t*D) + every rank
               runs its E/n experts on all n*t tokens + RS(t*D).
    expert_tp  every expert ff-sharded: the wire is the sequence AG/RS
               (identical for every schedule; C from the FULL token set);
               each row costs F/n; dense runs all E experts at F/n on all
               rows.
    """
    if layout == "expert_tp":
        cap = moe_capacity(tokens_local * n, top_k, n_experts,
                           capacity_factor)
        flops_row = 2.0 * mults * d_model * d_ff_expert / n
        x_bytes = tokens_local * d_model * dtype_bytes
        comm = (ring_all_gather_time(x_bytes, n, hw)
                + ring_reduce_scatter_time(n * x_bytes, n, hw))
        dense_ffn = (n_experts * tokens_local * n * flops_row
                     / hw.peak_flops)
    else:  # ep_a2a
        cap = moe_capacity(tokens_local, top_k, n_experts,
                           capacity_factor)
        flops_row = 2.0 * mults * d_model * d_ff_expert
        a2a_bytes = n_experts * cap * d_model * dtype_bytes
        comm = 2.0 * all_to_all_time(a2a_bytes, n, hw)
        dense_ffn = n_experts * tokens_local * flops_row / hw.peak_flops
    return cap, flops_row, comm, dense_ffn


def moe_dispatch_times(tokens_local: int, d_model: int, n_experts: int,
                       top_k: int, d_ff_expert: int, axis_size: int, *,
                       mults: int = 3, dtype_bytes: int = 2,
                       capacity_factor: float = 1.25,
                       occupancy: float | None = None,
                       hw: HardwareModel = DEFAULT_HW,
                       candidate_g: Sequence[int] = (2, 4, 8),
                       layout: str = "ep_a2a") -> dict[str, float]:
    """Predicted seconds per MoE layer for every "schedule:g" candidate
    (dispatch comm on the critical path + expert-FFN flops).  Stream
    candidates are restricted to g dividing the layout's chunk unit (the
    capacity C for ep_a2a, the per-rank sequence rows for expert_tp),
    since the executors degrade a non-dividing g to 1."""
    n = max(1, axis_size)
    cap, flops_row, comm, dense_ffn = _moe_terms(
        tokens_local, d_model, n_experts, top_k, d_ff_expert, n, mults,
        dtype_bytes, capacity_factor, layout, hw)
    unit = tokens_local if layout == "expert_tp" else cap
    occ = (min(1.0, 1.0 / max(capacity_factor, 1e-6))
           if occupancy is None else max(0.0, min(1.0, occupancy)))
    ffn_s = n_experts * cap * occ * flops_row / hw.peak_flops

    times: dict[str, float] = {}
    times["bulk:1"] = comm + ffn_s
    if n > 1:
        # the wire the stream can hide: everything but the per-hop alphas
        wire = max(0.0, comm - 2.0 * (n - 1) * hw.alpha_s)
        for g in sorted({int(g) for g in candidate_g
                         if g >= 1 and unit % g == 0}):
            stages = (n - 1) * g
            times[f"stream:{g}"] = _pipeline_time(
                wire, ffn_s, stages, hw.alpha_s, per_stage_msgs=2)
    if layout == "expert_tp":
        times["dense:1"] = comm + dense_ffn
    else:
        dense_bytes = tokens_local * d_model * dtype_bytes
        dense_comm = (ring_all_gather_time(dense_bytes, n, hw)
                      + ring_reduce_scatter_time(n * dense_bytes, n, hw))
        times["dense:1"] = dense_comm + dense_ffn
    return times


def decide_moe_dispatch(tokens_local: int, d_model: int, n_experts: int,
                        top_k: int, d_ff_expert: int, axis_size: int, *,
                        mults: int = 3, dtype_bytes: int = 2,
                        capacity_factor: float = 1.25,
                        candidate_cf: Sequence[float] = (1.0, 1.25, 1.5,
                                                         2.0, 4.0, 8.0),
                        candidate_g: Sequence[int] = (2, 4, 8),
                        measured_imbalance: float | None = None,
                        measured_drop_rate: float | None = None,
                        measured_occupancy: float | None = None,
                        hw: HardwareModel = DEFAULT_HW,
                        layout: str = "ep_a2a",
                        force_schedule: str | None = None,
                        force_g: int | None = None,
                        force_capacity_factor: float | None = None
                        ) -> MoEDispatchDecision:
    """Pick (schedule, g, capacity_factor) for one MoE dispatch call site.

    With no routing measurement the DECLARED capacity factor stands.  A
    ``measured_imbalance`` re-picks the smallest candidate cf covering
    the hottest expert; a bare ``measured_drop_rate`` > 0 escalates to
    the next candidate above the declared cf.  The dense schedule is
    capacity-free and ignores cf.  ``force_*`` pin choices while still
    reporting the modeled table."""
    cands = sorted({float(c) for c in candidate_cf if c > 0}
                   | {float(capacity_factor)})
    if force_capacity_factor is not None:
        cf = float(force_capacity_factor)
    elif measured_imbalance is not None:
        need = max(1.0, float(measured_imbalance))
        covering = [c for c in cands if c >= need]
        cf = covering[0] if covering else cands[-1]
    elif measured_drop_rate is not None and measured_drop_rate > 0:
        above = [c for c in cands if c > float(capacity_factor)]
        cf = above[0] if above else cands[-1]
    else:
        cf = float(capacity_factor)
    if measured_imbalance is not None:
        # the hottest expert holds imbalance x the mean load; capacity
        # covers cf x the mean: the overhang is the modeled residual drop
        drop = max(0.0, 1.0 - cf / max(1.0, float(measured_imbalance)))
    elif measured_drop_rate and cf == float(capacity_factor):
        drop = float(measured_drop_rate)
    else:
        drop = 0.0
    occ = measured_occupancy
    if occ is None:
        occ = min(1.0, (1.0 - drop) / max(cf, 1e-6))

    times = moe_dispatch_times(
        tokens_local, d_model, n_experts, top_k, d_ff_expert, axis_size,
        mults=mults, dtype_bytes=dtype_bytes, capacity_factor=cf,
        occupancy=occ, hw=hw, candidate_g=candidate_g, layout=layout)
    n = max(1, axis_size)
    cap, flops_row, _, dense_ffn = _moe_terms(
        tokens_local, d_model, n_experts, top_k, d_ff_expert, n, mults,
        dtype_bytes, cf, layout, hw)

    unit = tokens_local if layout == "expert_tp" else cap

    def clamp_g(gg: int) -> int:
        # the executors degrade a non-dividing g to 1: clamp to the
        # nearest divisor of the chunk unit so the logged g is executed
        gg = max(1, int(gg))
        while gg > 1 and unit % gg:
            gg -= 1
        return gg

    def best_stream_g() -> int:
        cands_g = [(t, int(k.split(":")[1])) for k, t in times.items()
                   if k.startswith("stream:")]
        return min(cands_g)[1] if cands_g else clamp_g(2)

    if force_schedule is not None:
        if force_schedule not in ("bulk", "stream", "dense"):
            raise ValueError(f"unknown MoE schedule {force_schedule!r}")
        if force_schedule == "stream":
            gg = clamp_g(force_g) if force_g else best_stream_g()
        else:
            gg = 1
        key = f"{force_schedule}:{gg}"
        if key not in times:
            times[key] = moe_dispatch_times(
                tokens_local, d_model, n_experts, top_k, d_ff_expert,
                axis_size, mults=mults, dtype_bytes=dtype_bytes,
                capacity_factor=cf, occupancy=occ, hw=hw,
                candidate_g=(gg,), layout=layout).get(key,
                                                      times["bulk:1"])
        chosen = key
    elif force_g is not None and f"stream:{clamp_g(force_g)}" in times:
        chosen = f"stream:{clamp_g(force_g)}"
    else:
        chosen = min(times, key=lambda k: (times[k], k))
    sched, g_str = chosen.split(":")
    g = int(g_str)

    if sched == "dense":
        compute_s = dense_ffn
        drop = 0.0                      # capacity-free: nothing to drop
    else:
        compute_s = n_experts * cap * occ * flops_row / hw.peak_flops
    return MoEDispatchDecision(
        schedule=sched, g=g, capacity_factor=cf, capacity=cap,
        times_s=times, bulk_s=times["bulk:1"], chosen_s=times[chosen],
        comm_s=max(0.0, times[chosen] - compute_s), compute_s=compute_s,
        drop_frac=drop,
        a2a_bytes=n_experts * cap * d_model * dtype_bytes,
        dense_bytes=tokens_local * d_model * dtype_bytes)


# ---------------------------------------------------------------------------
# Attention schedule decision (bulk gather vs ulysses a2a vs ring streaming)
# ---------------------------------------------------------------------------
#
# The SP-flow attention has three managed schedules (models/attention.py):
#
#   bulk (megatron)  — all-gather the SEQUENCE activations for the qkv
#                      matmuls (bytes ∝ S·B·D) + matmul-reduce-scatter of
#                      the output, then one full-sequence flash on local
#                      heads.
#   ulysses          — gather the q/o WEIGHTS over 'model' (bytes ∝ D·H·hd)
#                      and switch seq<->head sharding with two all_to_alls
#                      (bytes ∝ S·B·H·hd/tp) + a small KV seq-gather, then
#                      the same full-sequence flash.
#   ring             — q stays sequence-sharded; KV blocks stream around
#                      the ring under the flash compute.  Per step the
#                      cost is max(flash_flops, link_time) + alpha.
#
# qkv/o projection FLOPs are identical across schedules and excluded.  For
# causal masks the ring skips fully-masked future blocks; the ring is
# charged the same 0.5x causal factor per step as the bulk schedules.  At
# one rank every communication term is zero and the three times tie; the
# tie is broken by name, so ``bulk`` wins.


@dataclasses.dataclass(frozen=True)
class AttentionScheduleDecision:
    """Outcome of the three-way attention-schedule decision."""
    schedule: str                  # "bulk" | "ulysses" | "ring"
    times_s: dict[str, float]      # schedule -> predicted seconds/layer
    bulk_s: float
    chosen_s: float
    comm_s: float                  # comm on the chosen schedule's crit path
    flash_s: float                 # attention compute (chosen schedule)

    @property
    def predicted_speedup(self) -> float:
        if self.chosen_s <= 0:
            return 1.0
        return self.bulk_s / self.chosen_s


def attention_flash_step_s(batch: int, s_local: int, heads: int,
                           head_dim: int,
                           hw: HardwareModel = DEFAULT_HW) -> float:
    """Seconds for ONE q-block x kv-block flash step (all heads, local
    sequence) — the unit every schedule's compute term is built from."""
    return (4.0 * batch * float(s_local) ** 2 * heads * head_dim
            / hw.peak_flops)


def attention_schedule_times(batch: int, s_local: int, heads: int,
                             kv_heads: int, head_dim: int, d_model: int,
                             axis_size: int, *, dtype_bytes: int = 2,
                             causal: bool = True,
                             hw: HardwareModel = DEFAULT_HW
                             ) -> dict[str, float]:
    """Predicted seconds per attention call for each schedule (comm on the
    critical path + attention flops; shared projection flops excluded)."""
    n = max(1, axis_size)
    cf = 0.5 if causal else 1.0
    flash_step = attention_flash_step_s(batch, s_local, heads, head_dim, hw)
    attn_full = cf * n * flash_step          # full-seq flash == n ring steps

    x_shard = batch * s_local * d_model * dtype_bytes
    t_bulk = (ring_all_gather_time(x_shard, n, hw)
              + ring_reduce_scatter_time(x_shard * n, n, hw)
              + attn_full)

    wq_shard = d_model * (heads * head_dim // n) * dtype_bytes
    w_gather = 2.0 * ring_all_gather_time(wq_shard, n, hw)   # wq and wo
    qo_local = batch * s_local * heads * head_dim * dtype_bytes
    kv_shard = 2.0 * batch * s_local * kv_heads * head_dim * dtype_bytes
    t_ulysses = (w_gather + 2.0 * all_to_all_time(qo_local, n, hw)
                 + ring_all_gather_time(kv_shard, n, hw) + attn_full)

    link_step = hw.alpha_s + kv_shard / hw.link_bw
    t_ring = (w_gather + cf * flash_step
              + (n - 1) * max(cf * flash_step, link_step))
    return {"bulk": t_bulk, "ulysses": t_ulysses, "ring": t_ring}


def decide_attention_schedule(batch: int, s_local: int, heads: int,
                              kv_heads: int, head_dim: int, d_model: int,
                              axis_size: int, *, dtype_bytes: int = 2,
                              causal: bool = True,
                              hw: HardwareModel = DEFAULT_HW,
                              force_schedule: str | None = None
                              ) -> AttentionScheduleDecision:
    """Pick the attention schedule for one call site.  ``force_schedule``
    pins the choice (an MDMPConfig override, or a measured winner) while
    still reporting the modeled times."""
    times = attention_schedule_times(
        batch, s_local, heads, kv_heads, head_dim, d_model, axis_size,
        dtype_bytes=dtype_bytes, causal=causal, hw=hw)
    if force_schedule is not None:
        if force_schedule not in times:
            raise ValueError(f"unknown attention schedule "
                             f"{force_schedule!r}")
        best = force_schedule
    else:
        best = min(times, key=lambda s: (times[s], s))
    n = max(1, axis_size)
    cf = 0.5 if causal else 1.0
    flash_s = cf * n * attention_flash_step_s(batch, s_local, heads,
                                              head_dim, hw)
    comm_s = max(0.0, times[best] - flash_s)
    return AttentionScheduleDecision(
        schedule=best, times_s=times, bulk_s=times["bulk"],
        chosen_s=times[best], comm_s=comm_s, flash_s=flash_s)




# ---------------------------------------------------------------------------
# Pipeline schedule decision (gpipe vs 1f1b vs interleaved + microbatching)
# ---------------------------------------------------------------------------
#
# The pipeline executor (parallel/pipeline.py) runs lock-step ticks: per
# tick every stage does at most one forward and one backward unit and
# hands activations forward / gradients backward with one collective
# permute each.  The knob is (schedule, microbatch count M, virtual chunk
# factor v), and the trade is exactly the paper's control-vs-data-flow
# decision (El-Nashar, arXiv:1311.0731) at schedule granularity:
#
#   gpipe        ticks = 2(M+S-1),  critical compute = (M+S-1)(cf+cb),
#                stash = M microbatch activations per stage.
#                The bubble fraction is the classic (S-1)/(M+S-1).
#   1f1b         ticks = M+2S-1,    compute ~= M(cf+cb) + (2S-1) cb,
#                stash <= 2S (O(n_stage), independent of M).
#   interleaved  ticks = Mv+vS+S-1, compute ~= M(cf+cb) + (vS+S-1) cb / v,
#                stash <= 2vS chunk activations (each 1/1 of a microbatch
#                block).  The ramp's compute shrinks ~v x but every tick
#                still pays the per-message alpha — v x more messages.
#
# Per tick the two handoffs (activation fwd + gradient bwd) cost
# 2 alpha + 2 bytes / bw, with the bytes hidden under the tick's compute
# to the extent the stage boundary is ready early (the instrument.py
# readiness budget of the boundary operand).


#: backward flops per forward flop of a transformer chunk (dgrad + wgrad)
PIPELINE_BWD_FLOP_RATIO = 2.0


@dataclasses.dataclass(frozen=True)
class PipelineScheduleDecision:
    """Outcome of the pipeline-schedule decision for one training loop."""
    schedule: str                  # "gpipe" | "1f1b" | "interleaved"
    n_micro: int                   # microbatch count M
    virtual: int                   # virtual chunks per rank (1 unless interleaved)
    times_s: dict[str, float]      # "sched:M:v" -> predicted step seconds
    bulk_s: float                  # best gpipe variant (unmanaged baseline)
    chosen_s: float
    bubble_frac: float             # idle fraction of the chosen schedule
    stash_bytes: int               # peak activation stash per stage

    @property
    def predicted_speedup(self) -> float:
        if self.chosen_s <= 0:
            return 1.0
        return self.bulk_s / self.chosen_s


def pipeline_stash_slots(schedule: str, n_micro: int, n_stage: int,
                         virtual: int = 1) -> int:
    """Closed-form peak live activation count per stage (upper bound,
    matches the executor's host-allocated stash within +1).  Each slot
    holds ONE microbatch activation block — GPipe's slot count grows with
    M (whole batch stashed), 1f1b's is capped at 2S."""
    m, s = max(1, n_micro), max(1, n_stage)
    if schedule == "gpipe":
        return m
    if schedule == "1f1b":
        return min(m, 2 * s)
    return min(m * max(1, virtual), 2 * max(1, virtual) * s + s)


def pipeline_schedule_time(schedule: str, n_micro: int, n_stage: int,
                           virtual: int, batch_fwd_s: float,
                           batch_bytes: float, *,
                           hw: HardwareModel = DEFAULT_HW,
                           overlap_budget: float = 1.0
                           ) -> tuple[float, int]:
    """(predicted step seconds, tick count) of one schedule variant.

    ``batch_fwd_s``     one rank's forward compute for the WHOLE batch
                        (its full layer chunk set, all M microbatches) —
                        per-microbatch compute is batch_fwd_s / M.
    ``batch_bytes``     the whole batch's activation block at the stage
                        boundary — each handoff carries batch_bytes / M
                        (the gradient handoff is charged the same).
    ``overlap_budget``  fraction of a tick's compute under which the
                        transfer can hide (instrument readiness of the
                        stage boundary; 1.0 = fully hideable).
    """
    m, s, v = max(1, n_micro), max(1, n_stage), max(1, virtual)
    cf = batch_fwd_s / m
    cb = PIPELINE_BWD_FLOP_RATIO * cf
    if schedule == "gpipe":
        ticks = 2 * (m + s - 1)
        compute = (m + s - 1) * (cf + cb)
    elif schedule == "1f1b":
        ticks = m + 2 * s - 1
        compute = m * (cf + cb) + (2 * s - 1) * cb
    elif schedule == "interleaved":
        ticks = m * v + v * s + s - 1
        compute = m * (cf + cb) + (v * s + s - 1) * cb / v
    else:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    link = 2.0 * (batch_bytes / m) / hw.link_bw
    exposed = max(0.0, link - max(0.0, min(1.0, overlap_budget))
                  * compute / ticks)
    return ticks * (2.0 * hw.alpha_s + exposed) + compute, ticks


def decide_pipeline_schedule(n_stage: int, batch_fwd_s: float,
                             batch_bytes: float, *,
                             n_layers: int | None = None,
                             stash_cap_bytes: float | None = None,
                             candidate_micro: Sequence[int] = (4, 8, 16, 32),
                             candidate_virtual: Sequence[int] = (2,),
                             hw: HardwareModel = DEFAULT_HW,
                             overlap_budget: float = 1.0,
                             force_schedule: str | None = None,
                             force_micro: int | None = None,
                             force_virtual: int | None = None
                             ) -> PipelineScheduleDecision:
    """Pick (schedule, M, v) for one pipeline-parallel training loop.

    Candidates are dropped when their activation stash (slot count x
    batch_bytes/M per slot) overruns ``stash_cap_bytes`` — this is what
    retires GPipe, whose stash is the whole batch regardless of M — or,
    for interleaved, when M %% S != 0 or v*S exceeds ``n_layers``.  1f1b
    variants are exempt from the cap (smallest stash, the always-safe
    fallback).  ``force_*`` pin the choice (an MDMPConfig override, or
    the tuner's measured winner) while still reporting the modeled
    table."""
    s = max(1, n_stage)
    micros = sorted({int(c) for c in candidate_micro if c >= 1})
    if force_micro is not None:
        # an explicit M pins the microbatch count for EVERY schedule (the
        # CLI contract), not just when the schedule is forced too
        micros = [max(1, int(force_micro))]
    virtuals = sorted({int(c) for c in candidate_virtual if c >= 2})
    if force_virtual is not None and int(force_virtual) >= 2:
        virtuals = sorted({*virtuals, int(force_virtual)})

    def variants():
        for m in micros:
            yield "gpipe", m, 1
            yield "1f1b", m, 1
            for v in virtuals:
                if m % s:
                    continue
                if n_layers is not None and v * s > n_layers:
                    continue
                yield "interleaved", m, v

    times: dict[str, float] = {}
    for sched, m, v in variants():
        if stash_cap_bytes is not None and sched != "1f1b":
            stash = pipeline_stash_slots(sched, m, s, v) * batch_bytes / m
            if stash > stash_cap_bytes:
                continue
        t, _ = pipeline_schedule_time(
            sched, m, s, v, batch_fwd_s, batch_bytes, hw=hw,
            overlap_budget=overlap_budget)
        times[f"{sched}:{m}:{v}"] = t

    def pick(pred):
        cands = [(t, k) for k, t in times.items() if pred(k)]
        return min(cands) if cands else None

    bulk = pick(lambda k: k.startswith("gpipe:"))
    if bulk is None:        # every gpipe stash overran the cap
        bulk = pick(lambda k: True)
    if force_schedule is not None:
        if force_schedule not in ("gpipe", "1f1b", "interleaved"):
            raise ValueError(f"unknown pipeline schedule "
                             f"{force_schedule!r}")
        sched = force_schedule
        m = int(force_micro) if force_micro is not None else None
        v = int(force_virtual) if force_virtual is not None else None
        key = pick(lambda k, sched=sched, m=m, v=v:
                   k.startswith(sched + ":")
                   and (m is None or k.split(":")[1] == str(m))
                   and (v is None or k.split(":")[2] == str(v)))
        if key is None:     # forced variant not in the surviving table
            mm = m if m is not None else min(micros)
            vv = v if v is not None else \
                (min(virtuals) if sched == "interleaved" and virtuals else 1)
            if sched == "interleaved":
                # fail at the decision layer, not deep inside
                # build_schedule, when the forced variant is invalid
                if mm % s:
                    raise ValueError(
                        f"interleaved needs n_micro % n_stage == 0 "
                        f"(got {mm} % {s})")
                if n_layers is not None and vv * s > n_layers:
                    raise ValueError(
                        f"interleaved needs virtual*n_stage <= n_layers "
                        f"(got {vv}*{s} > {n_layers})")
            t, _ = pipeline_schedule_time(
                sched, mm, s, vv, batch_fwd_s, batch_bytes, hw=hw,
                overlap_budget=overlap_budget)
            times[f"{sched}:{mm}:{vv}"] = t
            key = (t, f"{sched}:{mm}:{vv}")
        chosen = key
    else:
        chosen = pick(lambda k: True)
    sched, m_str, v_str = chosen[1].split(":")
    m, v = int(m_str), int(v_str)

    cf = batch_fwd_s / m
    cb = PIPELINE_BWD_FLOP_RATIO * cf
    busy = m * (cf + cb)
    if sched == "gpipe":
        crit = (m + s - 1) * (cf + cb)
    elif sched == "1f1b":
        crit = busy + (2 * s - 1) * cb
    else:
        crit = busy + (v * s + s - 1) * cb / v
    bubble = 0.0 if crit <= 0 else max(0.0, 1.0 - busy / crit)
    return PipelineScheduleDecision(
        schedule=sched, n_micro=m, virtual=v, times_s=times,
        bulk_s=bulk[0] if bulk else chosen[0], chosen_s=chosen[0],
        bubble_frac=bubble,
        stash_bytes=int(pipeline_stash_slots(sched, m, s, v)
                        * batch_bytes / m))


# ---------------------------------------------------------------------------
# Checkpoint cadence decision (the Young/Daly optimum as a managed knob)
# ---------------------------------------------------------------------------
#
# Recovery traffic deserves the same alpha-beta treatment as the forward
# collectives: a checkpoint costs δ seconds (on-device snapshot block +
# the metered D2H drain; the disk write rides the writer thread), and a
# failure with MTBF M loses on average half an interval of work plus the
# restore.  First-order expected overhead per useful second at interval
# τ seconds:
#
#     overhead(τ) = δ/τ + (τ/2 + R)/M            (Daly 2006, first order)
#
# minimised at the Young/Daly optimum τ* = sqrt(2 δ M).  Goodput — useful
# steps per wall second including recovery — is step_s/(1+overhead).  The
# decision quantises τ* to a candidate step interval N (checkpoints only
# land on step boundaries), prices the whole candidate table, and reports
# the fixed-cadence baseline (ckpt_every=25) for the speedup column.
# Measured δ and write bandwidth come from checkpoint/metrics.py; the
# step time is the train loop's EWMA — iteration k prices iteration k+1.


#: default end-to-end checkpoint write bandwidth (D2H + serialisation)
#: used before the first measured save; on-model for a host NVMe path
CKPT_WRITE_BW = 2.0e9

#: the unmanaged fixed cadence every prior PR shipped (TrainLoopConfig)
CKPT_FIXED_INTERVAL = 25


@dataclasses.dataclass(frozen=True)
class CheckpointDecision:
    """Outcome of the checkpoint-cadence decision for one train loop."""
    mode: str                      # "daly" | "fixed"
    interval: int                  # chosen steps between checkpoints
    step_s: float                  # instrumented step seconds (EWMA)
    ckpt_cost_s: float             # δ — per-checkpoint critical-path cost
    snapshot_bytes: int
    write_bw: float                # bytes/s (measured or default)
    mtbf_s: float
    restore_s: float
    daly_interval_s: float         # continuous τ* = sqrt(2 δ M)
    overhead: dict[int, float]     # candidate N -> expected overhead frac
    fixed_overhead: float          # overhead at CKPT_FIXED_INTERVAL
    chosen_overhead: float

    @property
    def predicted_speedup(self) -> float:
        """Modeled goodput gain over the fixed cadence."""
        return (1.0 + self.fixed_overhead) / (1.0 + self.chosen_overhead)


def checkpoint_overhead(interval_steps: int, step_s: float,
                        ckpt_cost_s: float, mtbf_s: float,
                        restore_s: float) -> float:
    """Expected overhead fraction (non-useful seconds per useful second)
    of checkpointing every ``interval_steps`` steps under MTBF failures."""
    tau = max(1, int(interval_steps)) * max(step_s, 1e-12)
    return (ckpt_cost_s / tau
            + (0.5 * tau + restore_s) / max(mtbf_s, 1e-12))


def decide_checkpoint(step_s: float, snapshot_bytes: int, *,
                      mtbf_s: float = 1800.0,
                      write_bw: float | None = None,
                      ckpt_cost_s: float | None = None,
                      restore_s: float | None = None,
                      candidate_intervals: Sequence[int] = (2, 4, 5, 8, 10,
                                                            20, 25, 50, 100,
                                                            200),
                      hw: HardwareModel = DEFAULT_HW,
                      force_interval: int | None = None
                      ) -> CheckpointDecision:
    """Pick the checkpoint interval (steps) for one train loop.

    δ defaults to ``snapshot_bytes / write_bw`` (the drain at the write
    bandwidth; the snapshot block is a same-order HBM copy folded into
    the bandwidth term) and is overridden by a measured ``ckpt_cost_s``
    from checkpoint/metrics.py.  ``force_interval`` pins the choice (an
    MDMPConfig bulk override = the fixed baseline, or an explicit
    ``--ckpt-every``) while still reporting the modeled table."""
    bw = float(write_bw) if write_bw else CKPT_WRITE_BW
    delta = (float(ckpt_cost_s) if ckpt_cost_s is not None
             else snapshot_bytes / bw)
    delta = max(delta, 1e-9)
    rest = (float(restore_s) if restore_s is not None
            else snapshot_bytes / bw)
    step = max(float(step_s), 1e-9)
    tau_star = math.sqrt(2.0 * delta * max(mtbf_s, 1e-9))

    cands = sorted({int(n) for n in candidate_intervals if n >= 1}
                   | {CKPT_FIXED_INTERVAL})
    overhead = {n: checkpoint_overhead(n, step, delta, mtbf_s, rest)
                for n in cands}
    fixed_ov = overhead[CKPT_FIXED_INTERVAL]
    if force_interval is not None:
        interval = max(1, int(force_interval))
        mode = "fixed"
        if interval not in overhead:
            overhead[interval] = checkpoint_overhead(interval, step, delta,
                                                     mtbf_s, rest)
    else:
        interval = min(cands, key=lambda n: (overhead[n], n))
        mode = "daly"
    return CheckpointDecision(
        mode=mode, interval=interval, step_s=step, ckpt_cost_s=delta,
        snapshot_bytes=int(snapshot_bytes), write_bw=bw, mtbf_s=mtbf_s,
        restore_s=rest, daly_interval_s=tau_star, overhead=overhead,
        fixed_overhead=fixed_ov, chosen_overhead=overhead[interval])


# ---------------------------------------------------------------------------
# Roofline terms (of the dry run's counts, launch/hlo.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             n_chips: int, hw: HardwareModel = DEFAULT_HW) -> RooflineTerms:
    """The three-term roofline: ``hlo_flops`` / ``hlo_bytes`` over the
    ``n_chips`` chips' peak and memory rate, ``collective_bytes`` (link
    bytes) over their links.  The dry run's counts are one rank's, so a
    step's bound on one chip is ``roofline(flops, bytes, link, 1)``."""
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * hw.peak_flops),
        memory_s=hlo_bytes / (n_chips * hw.hbm_bw),
        collective_s=collective_bytes / (n_chips * hw.link_bw),
    )


# ---------------------------------------------------------------------------
# Joint-plan components (used by plan/planner.py — the MDMP compiler)
# ---------------------------------------------------------------------------
#
# The per-subsystem decide_* functions above price each knob ALONE on the
# link with a private overlap budget.  The whole-program planner instead
# needs each knob candidate decomposed into the terms it must pool across
# ops sharing a mesh axis: the bytes-on-link time (serialised within a
# contention set), the message count (alpha each, never hidden), the
# adjacent compute an interleaved schedule can hide the wire under (one
# account per contention set — compute hides the link once, not once per
# op), and the buffer footprint drawn from the pooled stash cap.


@dataclasses.dataclass(frozen=True)
class CommComponents:
    """Wire/message/hide decomposition of one knob candidate."""
    wire_s: float          # bytes-on-link seconds (no alphas)
    msgs: int              # message count (alpha_s each)
    hide_s: float          # compute available to hide wire_s (0 for bulk)
    stash_bytes: int = 0   # buffer footprint against the pooled cap

    def solo_s(self, alpha: float) -> float:
        """The LOCAL model of this knob: alone on the link, private hide
        budget — what per-subsystem resolution implicitly assumes."""
        return max(0.0, self.wire_s - self.hide_s) + alpha * self.msgs


def collective_wire_s(collective: str, nbytes: float, n: int,
                      hw: HardwareModel = DEFAULT_HW) -> float:
    """Bytes-on-link seconds of one ring collective — the alpha-free term
    of the ring_*_time primitives above (AG: shard bytes in; RS/A2A: full/
    local bytes in; AR = RS + AG of the shard)."""
    if n <= 1:
        return 0.0
    if collective == "all_gather":
        return (n - 1) * nbytes / hw.link_bw
    if collective in ("reduce_scatter", "all_to_all"):
        return (n - 1) * (nbytes / n) / hw.link_bw
    if collective == "all_reduce":
        return 2.0 * (n - 1) * (nbytes / n) / hw.link_bw
    raise ValueError(f"unknown collective {collective!r}")


def collective_msgs(collective: str, n: int, *, mode: str = "bulk",
                    chunks: int = 1) -> int:
    """Message (dispatch) count of one collective knob.  A BULK collective
    is ONE fused op (the one all_gather / all-reduce / all_to_all call
    the managed runtime falls through to — one dispatch regardless of
    n); the interleaved ring issues one point-to-point permute per
    step, ``(n-1) * chunks`` of them (doubled for all_reduce's RS+AG
    rings).  This asymmetry is the
    planner's lever: streaming buys overlap at per-message cost, bulk
    minimises messages — the paper's aggregation counter-knob."""
    if n <= 1:
        return 0
    if mode != "interleaved":
        return 1
    steps = (n - 1) * max(1, chunks)
    return 2 * steps if collective == "all_reduce" else steps


def collective_components(collective: str, nbytes: float, n: int, *,
                          mode: str = "bulk", chunks: int = 1,
                          compute_time_s: float = 0.0,
                          hw: HardwareModel = DEFAULT_HW) -> CommComponents:
    """CommComponents of one generic managed-collective knob candidate."""
    return CommComponents(
        wire_s=collective_wire_s(collective, nbytes, n, hw),
        msgs=collective_msgs(collective, n, mode=mode, chunks=chunks),
        hide_s=compute_time_s if mode == "interleaved" else 0.0)
