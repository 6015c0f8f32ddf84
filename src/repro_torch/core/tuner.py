"""Runtime schedule tuner — the paper's iteration-(k)→(k+1) adaptation
(port of ``repro.core.tuner``).

MDMP records data-access behaviour during early iterations and uses it to
schedule later iterations.  The tuner re-picks
schedules *between* steps: each managed call site is keyed by (op, shape,
dtype, axis), seeded with the cost-model decision, and updated from
measured seconds — the paper's "evaluate different communication
optimisations at runtime to auto-tune" (Sec. 4).

The cache is JSON-serialisable so tuned schedules persist across restarts
(they ride along with checkpoints), in the reference's format: a
reference tuner's JSON loads here and replans the same way, the
whole-program plans it carries (``__program_plans__``, plan/planner.py's
``ProgramPlan``) included.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re

from repro_torch.core import cost_model, managed
from repro_torch.core.cost_model import DEFAULT_HW, HardwareModel


def call_site_key(op: str, shape: tuple, dtype: str, axis: str,
                  axis_size: int) -> str:
    return f"{op}|{'x'.join(map(str, shape))}|{dtype}|{axis}{axis_size}"


@dataclasses.dataclass
class TunerEntry:
    key: str
    mode: str
    chunks: int
    predicted_s: float
    measured_s: dict[str, float] = dataclasses.field(default_factory=dict)
    trials: int = 0

    def best_measured(self) -> tuple[str, float] | None:
        if not self.measured_s:
            return None
        k = min(self.measured_s, key=self.measured_s.get)
        return k, self.measured_s[k]


class ScheduleTuner:
    """Measure-and-adapt schedule cache for managed call sites."""

    #: candidate (mode, chunks) variants trialled per call site
    CANDIDATES = (("bulk", 1), ("interleaved", 1), ("interleaved", 2),
                  ("interleaved", 4))

    #: candidate (mode, k) variants for halo call sites — ``chunks`` carries
    #: the aggregation factor k (sweeps per exchange); bulk is k=1
    HALO_CANDIDATES = (("bulk", 1), ("aggregated", 2), ("aggregated", 4),
                       ("aggregated", 8))

    #: candidate schedules for attention call sites — ``mode`` carries the
    #: schedule name (bulk sequence-gather / ulysses a2a / ring streaming)
    ATTENTION_CANDIDATES = (("bulk", 1), ("ulysses", 1), ("ring", 1))

    #: candidate (mode, C) variants for serving call sites — ``mode``
    #: carries the batching mode, ``chunks`` the scheduling quantum C
    SERVE_CANDIDATES = (("static", 8), ("continuous", 2),
                        ("continuous", 8), ("continuous", 32))

    #: candidate (schedule, M) variants for pipeline call sites — ``mode``
    #: carries the schedule name, ``chunks`` the microbatch count M
    #: (interleaved variants run virtual=2 chunks per rank)
    PIPELINE_CANDIDATES = (("gpipe", 8), ("1f1b", 8), ("1f1b", 16),
                           ("interleaved", 8))

    #: candidate (schedule, g) variants for MoE dispatch call sites —
    #: ``mode`` carries the schedule (bulk a2a / chunked-stream /
    #: dense-fallback), ``chunks`` the stream chunk count g
    MOE_CANDIDATES = (("bulk", 1), ("stream", 2), ("stream", 4),
                      ("dense", 1))

    #: candidate policies for preemption call sites — ``mode`` carries
    #: the policy (swap KV to host / drop-and-recompute / head-of-line
    #: wait), ``chunks`` is unused (always 1)
    PREEMPT_CANDIDATES = (("recompute", 1), ("swap", 1), ("wait", 1))

    #: candidate (mode, N) variants for checkpoint-cadence call sites —
    #: ``mode`` carries fixed/daly, ``chunks`` the interval in steps
    #: (fixed:25 is the unmanaged baseline every prior PR shipped)
    CKPT_CANDIDATES = (("fixed", 25), ("daly", 4), ("daly", 10),
                       ("daly", 50))

    #: reserved JSON key the program plans persist under — never a call
    #: site (call_site_key always contains "|")
    PROGRAM_PLANS_KEY = "__program_plans__"

    def __init__(self, hw: HardwareModel = DEFAULT_HW,
                 path: str | None = None):
        self.hw = hw
        self.path = path
        self._entries: dict[str, TunerEntry] = {}
        self._program_plans: dict[str, dict] = {}
        if path and os.path.exists(path):
            self.load(path)

    # -- decisions ----------------------------------------------------------

    def decide(self, op: str, shape: tuple, dtype_str: str, axis: str,
               axis_size: int, *, nbytes: int,
               compute_time_s: float = 0.0,
               collective: str = "all_gather") -> TunerEntry:
        key = call_site_key(op, shape, dtype_str, axis, axis_size)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide(nbytes, axis_size,
                                  compute_time_s=compute_time_s,
                                  hw=self.hw, collective=collective)
            entry = TunerEntry(key=key, mode=d.mode, chunks=d.chunks,
                               predicted_s=d.interleaved_time_s)
            self._entries[key] = entry
        return entry

    def decide_halo(self, axis: str, axis_size: int, rows_local: int,
                    cols: int, *, dtype_str: str = "float32",
                    dtype_bytes: int = 4) -> TunerEntry:
        """Aggregation decision for a halo call site: seeded from the cost
        model's k (``chunks`` carries k), then overridden by measurements
        fed back through ``record(key, "aggregated", k, seconds)`` — the
        paper's iteration-(k)->(k+1) adaptation applied to the aggregation
        knob.  Persisted like every other entry."""
        key = call_site_key("halo_jacobi", (rows_local, cols), dtype_str,
                            axis, axis_size)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide_halo_aggregation(
                rows_local, cols, axis_size, dtype_bytes=dtype_bytes,
                hw=self.hw)
            entry = TunerEntry(key=key, mode=d.mode, chunks=d.k,
                               predicted_s=d.aggregated_sweep_s)
            self._entries[key] = entry
        return entry

    def decide_attention(self, axis: str, axis_size: int, batch: int,
                         s_local: int, heads: int, kv_heads: int,
                         head_dim: int, d_model: int, *,
                         dtype_str: str = "bfloat16", dtype_bytes: int = 2,
                         causal: bool = True) -> TunerEntry:
        """Schedule decision for an SP attention call site: seeded from the
        three-way cost model (``mode`` carries the schedule name, chunks is
        unused), then overridden by measurements fed back through
        ``record(key, "ring", 1, seconds)`` etc.  Persisted like every
        other entry so a measured winner survives restarts."""
        key = call_site_key(
            "attention_sp", (batch, s_local, heads, kv_heads, head_dim,
                             d_model, int(causal)), dtype_str, axis,
            axis_size)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide_attention_schedule(
                batch, s_local, heads, kv_heads, head_dim, d_model,
                axis_size, dtype_bytes=dtype_bytes, causal=causal,
                hw=self.hw)
            entry = TunerEntry(key=key, mode=d.schedule, chunks=1,
                               predicted_s=d.chosen_s)
            self._entries[key] = entry
        return entry

    def decide_pipeline(self, axis: str, axis_size: int, n_layers: int,
                        batch_shape: tuple, batch_fwd_s: float,
                        batch_bytes: int, *,
                        dtype_str: str = "float32") -> TunerEntry:
        """Schedule decision for a pipeline-parallel call site: seeded from
        the pipeline cost model (``mode`` carries the schedule name,
        ``chunks`` the microbatch count M), then overridden by measured
        step seconds fed back through ``record(key, "1f1b", M, seconds)``
        — the paper's iteration-(k)->(k+1) adaptation applied to the
        pipeline knob.  Persisted like every other entry."""
        key = call_site_key("pipeline", (n_layers, *batch_shape), dtype_str,
                            axis, axis_size)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide_pipeline_schedule(
                axis_size, batch_fwd_s, batch_bytes, n_layers=n_layers,
                hw=self.hw)
            entry = TunerEntry(key=key, mode=d.schedule, chunks=d.n_micro,
                               predicted_s=d.chosen_s)
            self._entries[key] = entry
        return entry

    def decide_moe(self, axis: str, axis_size: int, tokens_local: int,
                   d_model: int, n_experts: int, top_k: int,
                   d_ff_expert: int, *, dtype_str: str = "bfloat16",
                   dtype_bytes: int = 2, mults: int = 3,
                   capacity_factor: float = 1.25) -> TunerEntry:
        """Schedule decision for an MoE dispatch call site: seeded from
        the three-way dispatch cost model (``mode`` carries the schedule
        name, ``chunks`` the stream chunk count g), then overridden by
        measured step seconds fed back through
        ``record(key, "stream", g, seconds)`` — and re-resolved online
        from instrumented routing (imbalance/drop rate) through
        ``managed.resolve_moe_dispatch``'s measured_* inputs, the way
        the serving engine re-resolves after measured quanta.  Persisted
        like every other entry."""
        # the capacity factor is part of the call-site signature: it sizes
        # the [E, C, D] buffers every schedule moves, so different cf =
        # different operand shapes = a separate tuned entry
        cap = cost_model.moe_capacity(tokens_local, top_k, n_experts,
                                      capacity_factor)
        key = call_site_key(
            "moe_dispatch",
            (tokens_local, d_model, n_experts, top_k, d_ff_expert, cap),
            dtype_str, axis, axis_size)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide_moe_dispatch(
                tokens_local, d_model, n_experts, top_k, d_ff_expert,
                axis_size, mults=mults, dtype_bytes=dtype_bytes,
                capacity_factor=capacity_factor, hw=self.hw)
            entry = TunerEntry(key=key, mode=d.schedule, chunks=d.g,
                               predicted_s=d.chosen_s)
            self._entries[key] = entry
        return entry

    def decide_serve(self, batch_slots: int, mean_prompt: int,
                     mean_new: int, n_params: int, *,
                     dtype_str: str = "bfloat16", dtype_bytes: int = 2,
                     max_prompt: int | None = None) -> TunerEntry:
        """Schedule decision for a serving call site: seeded from the
        serve cost model (``mode`` carries static/continuous, ``chunks``
        the scheduling quantum C), then overridden by measured tokens/s
        fed back through ``record(key, "continuous", C, seconds_per_tok)``
        — the paper's iteration-(k)->(k+1) adaptation applied to the
        batching knob.  Persisted like every other entry."""
        key = call_site_key(
            "serve_schedule",
            (batch_slots, int(mean_prompt), int(mean_new), int(n_params)),
            dtype_str, "serve", batch_slots)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide_serve_schedule(
                n_params, batch_slots, mean_prompt, mean_new,
                max_prompt=max_prompt, dtype_bytes=dtype_bytes, hw=self.hw)
            entry = TunerEntry(key=key, mode=d.mode, chunks=d.chunk,
                               predicted_s=1.0 / max(d.chosen_tok_s,
                                                     1e-30))
            self._entries[key] = entry
        return entry

    def decide_preempt(self, axis: str, batch_slots: int, page_bytes: int,
                       n_params: int, *, victim_pages: int = 1,
                       replay_tokens: int = 0,
                       dtype_str: str = "bfloat16", dtype_bytes: int = 2,
                       step_s: float | None = None) -> TunerEntry:
        """Policy decision for a serving preemption call site: seeded
        from the swap-vs-recompute-vs-wait cost model (``mode`` carries
        the policy), then overridden by measured eviction costs fed back
        through ``record(key, "swap", 1, seconds)`` — and re-resolved
        online per event from serve/metrics.py's measured step seconds
        and swap bandwidth through ``managed.resolve_preempt``.  The key
        is per serving SITE (slots, page bytes, params), not per event —
        victim geometry varies every exhaustion, so it parameterises the
        resolve, not the cache."""
        key = call_site_key(
            "preempt", (batch_slots, int(page_bytes), int(n_params)),
            dtype_str, axis, batch_slots)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide_preempt(
                victim_pages, page_bytes, replay_tokens, n_params,
                step_s=step_s, batch_slots=batch_slots,
                dtype_bytes=dtype_bytes, hw=self.hw)
            entry = TunerEntry(key=key, mode=d.policy, chunks=1,
                               predicted_s=d.chosen_s)
            self._entries[key] = entry
        return entry

    def decide_ckpt(self, axis: str, axis_size: int, snapshot_bytes: int,
                    step_s: float, *, mtbf_s: float = 1800.0,
                    write_bw: float | None = None,
                    ckpt_cost_s: float | None = None,
                    restore_s: float | None = None) -> TunerEntry:
        """Cadence decision for a checkpoint call site: seeded from the
        Young/Daly cost model (``mode`` carries fixed/daly, ``chunks``
        the interval in steps), then overridden by measured overhead fed
        back through ``record(key, "daly", N, overhead)`` — and
        re-resolved online by the train loop as the EWMA step time and
        measured write bandwidth (checkpoint/metrics.py) drift.
        Persisted like every other entry so the cadence survives
        restarts (it rides along with the checkpoint itself)."""
        key = call_site_key("ckpt_interval", (int(snapshot_bytes),),
                            "bytes", axis, axis_size)
        entry = self._entries.get(key)
        if entry is None:
            d = cost_model.decide_checkpoint(
                step_s, snapshot_bytes, mtbf_s=mtbf_s, write_bw=write_bw,
                ckpt_cost_s=ckpt_cost_s, restore_s=restore_s, hw=self.hw)
            entry = TunerEntry(key=key, mode=d.mode, chunks=d.interval,
                               predicted_s=d.chosen_overhead)
            self._entries[key] = entry
        return entry

    # -- measurement feedback (iteration k informs iteration k+1) -----------

    def record(self, key: str, mode: str, chunks: int,
               measured_s: float) -> None:
        entry = self._entries.get(key)
        if entry is None:
            entry = TunerEntry(key=key, mode=mode, chunks=chunks,
                               predicted_s=math.inf)
            self._entries[key] = entry
        variant = f"{mode}:{chunks}"
        prev = entry.measured_s.get(variant)
        # EWMA so stragglers/noise don't flip schedules on one sample.
        entry.measured_s[variant] = (measured_s if prev is None
                                     else 0.7 * prev + 0.3 * measured_s)
        entry.trials += 1
        best = entry.best_measured()
        if best is not None:
            mode_s, chunks_s = best[0].split(":")
            entry.mode, entry.chunks = mode_s, int(chunks_s)

    def next_trial(self, key: str) -> tuple[str, int] | None:
        """Suggest an untried candidate variant for this call site (the
        paper's 'evaluate different communication optimisations at
        runtime'), or None when the sweep is complete.  Halo call sites
        sweep the aggregation factors instead of the chunk counts."""
        candidates = (self.HALO_CANDIDATES if key.startswith("halo")
                      else self.ATTENTION_CANDIDATES
                      if key.startswith("attention")
                      else self.PREEMPT_CANDIDATES
                      if key.startswith("preempt")
                      else self.SERVE_CANDIDATES
                      if key.startswith("serve")
                      else self.PIPELINE_CANDIDATES
                      if key.startswith("pipeline")
                      else self.MOE_CANDIDATES
                      if key.startswith("moe")
                      else self.CKPT_CANDIDATES
                      if key.startswith("ckpt")
                      else self.CANDIDATES)
        entry = self._entries.get(key)
        if entry is None:
            return candidates[0]
        tried = set(entry.measured_s)
        for mode, chunks in candidates:
            if f"{mode}:{chunks}" not in tried:
                return mode, chunks
        return None

    # -- program plans (plan/planner.py output, keyed by program+topology) ---

    @staticmethod
    def program_plan_key(signature: str, topology: str) -> str:
        return f"{signature}@{topology}"

    def store_program_plan(self, plan) -> str:
        """Persist a ``plan.planner.ProgramPlan`` keyed by (program
        signature, topology) — the whole-program analogue of a call-site
        entry.  Rides along in the same JSON cache / checkpoint."""
        key = self.program_plan_key(plan.signature, plan.topology)
        self._program_plans[key] = plan.to_dict()
        return key

    def get_program_plan(self, signature: str, topology: str):
        """Return the stored ``ProgramPlan`` for this (program, topology),
        or None.  Lazy import keeps core free of a plan dependency."""
        d = self._program_plans.get(self.program_plan_key(signature,
                                                          topology))
        if d is None:
            return None
        from repro_torch.plan.planner import ProgramPlan
        return ProgramPlan.from_dict(d)

    @property
    def program_plans(self) -> dict[str, dict]:
        return dict(self._program_plans)

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        blob = {k: dataclasses.asdict(v)
                for k, v in self._entries.items()}
        if self._program_plans:
            blob[self.PROGRAM_PLANS_KEY] = dict(self._program_plans)
        return json.dumps(blob, indent=2)

    def save(self, path: str | None = None) -> None:
        path = path or self.path
        if not path:
            raise ValueError("no tuner cache path configured")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            self.load_entries(json.load(f))

    def load_entries(self, raw: dict) -> None:
        """Install entries from a ``to_json``-shaped dict (e.g. the tuner
        state a checkpoint carried along).  The reserved
        ``__program_plans__`` key holds the persisted whole-program plans,
        not a call-site entry."""
        for k, v in raw.items():
            if k == self.PROGRAM_PLANS_KEY:
                self._program_plans.update(v)
                continue
            self._entries[k] = TunerEntry(**v)

    @property
    def entries(self) -> dict[str, TunerEntry]:
        return dict(self._entries)


# ---------------------------------------------------------------------------
# Elastic re-planning — persisted winners replayed onto a new topology
# ---------------------------------------------------------------------------


_DTYPE_BYTES = {"float64": 8, "float32": 4, "int32": 4, "bfloat16": 2,
                "float16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1,
                "int8": 1, "bytes": 1}


def parse_call_site_key(key: str) -> tuple[str, tuple[int, ...], str,
                                           str, int]:
    """Invert ``call_site_key`` -> (op, shape, dtype, axis, axis_size)."""
    op, shape_s, dtype, axis_tag = key.split("|")
    shape = tuple(int(x) for x in shape_s.split("x")) if shape_s else ()
    m = re.match(r"^(.*?)(\d+)$", axis_tag)
    if not m:
        raise ValueError(f"unparseable axis tag in tuner key {key!r}")
    return op, shape, dtype, m.group(1), int(m.group(2))


def replan_for_mesh(tuner: ScheduleTuner, new_axis_sizes: dict[str, int],
                    *, step_s: float = 0.1, mtbf_s: float = 1800.0
                    ) -> list[dict]:
    """Replay every persisted tuner winner onto a NEW topology.

    An N-way-mesh checkpoint restoring onto M ranks invalidates every
    tuned call-site key (keys embed ``axis{axis_size}``, and the per-rank
    operand geometry changes with the shard count).  This pass walks the
    persisted entries, rescales each call site's per-rank shape to the
    new axis extent (total work is conserved: ``local' = local * n_old /
    n_new``), re-resolves the subsystem's managed decision with the OLD
    winner pinned — so the decision trail shows the replay, old->new —
    and installs a fresh entry under the new-topology key carrying the
    winner forward.  Measurements do NOT transfer (a different topology
    is a different machine as far as wall clocks go): the new entries
    start unmeasured, and the normal iteration-(k)->(k+1) loop re-earns
    or overturns each winner.

    Returns one record per replayed entry:
    ``{op, axis, old_key, new_key, mode, chunks, old_n, new_n}``.
    """
    replayed: list[dict] = []
    for old_key, old in sorted(tuner.entries.items()):
        try:
            op, shape, dtype, axis, n_old = parse_call_site_key(old_key)
        except ValueError:
            continue
        n_new = int(new_axis_sizes.get(axis, n_old))
        ib = _DTYPE_BYTES.get(dtype, 4)

        def rescale(local: int) -> int:
            return max(1, local * n_old // max(1, n_new))

        if op == "halo_jacobi" and len(shape) == 2:
            rows_local, cols = rescale(shape[0]), shape[1]
            managed.resolve_halo_aggregation(
                axis, n_new, rows_local, cols, dtype_bytes=ib,
                k=old.chunks)
            entry = tuner.decide_halo(axis, n_new, rows_local, cols,
                                      dtype_str=dtype, dtype_bytes=ib)
        elif op == "attention_sp" and len(shape) == 7:
            b, s_local, h, kv, hd, d_model, causal = shape
            s_local = rescale(s_local)
            managed.resolve_attention_schedule(
                axis, n_new, b, s_local, h, kv, hd, d_model,
                dtype_bytes=ib, causal=bool(causal), schedule=old.mode)
            entry = tuner.decide_attention(
                axis, n_new, b, s_local, h, kv, hd, d_model,
                dtype_str=dtype, dtype_bytes=ib, causal=bool(causal))
        elif op == "pipeline" and len(shape) >= 2:
            n_layers, batch_shape = shape[0], shape[1:]
            rows, width = batch_shape[0], batch_shape[-1]
            batch_bytes = rows * width * ib
            # per-stage forward estimate: ~2 GEMM flops per element over
            # this stage's layer share (the bench's formula)
            batch_fwd_s = (2.0 * 2.0 * rows * width * width
                           * (n_layers / max(1, n_new))
                           / tuner.hw.peak_flops)
            managed.resolve_pipeline_schedule(
                axis, n_new, batch_fwd_s, batch_bytes, n_layers=n_layers,
                schedule=old.mode, n_micro=old.chunks,
                virtual=2 if old.mode == "interleaved" else 1)
            entry = tuner.decide_pipeline(axis, n_new, n_layers,
                                          batch_shape, batch_fwd_s,
                                          batch_bytes, dtype_str=dtype)
        elif op == "moe_dispatch" and len(shape) == 6:
            t_loc, d_model, e, k, f, cap = shape
            t_loc = rescale(t_loc)
            cf = cap * e / max(1, shape[0] * k)      # invert moe_capacity
            managed.resolve_moe_dispatch(
                axis, n_new, t_loc, d_model, e, k, f, dtype_bytes=ib,
                capacity_factor=cf, schedule=old.mode, g=old.chunks)
            entry = tuner.decide_moe(axis, n_new, t_loc, d_model, e, k, f,
                                     dtype_str=dtype, dtype_bytes=ib,
                                     capacity_factor=cf)
        elif op == "serve_schedule" and len(shape) == 4:
            slots, mp, mn, n_params = shape
            slots = int(new_axis_sizes.get(axis, slots))
            managed.resolve_serve_schedule(
                axis, slots, float(mp), float(mn), float(n_params),
                dtype_bytes=ib, schedule=old.mode, chunk=old.chunks)
            entry = tuner.decide_serve(slots, mp, mn, n_params,
                                       dtype_str=dtype, dtype_bytes=ib)
        elif op == "preempt" and len(shape) == 3:
            slots, page_bytes, n_params = shape
            slots = int(new_axis_sizes.get(axis, slots))
            managed.resolve_preempt(
                axis, 1, page_bytes, 0, float(n_params),
                batch_slots=slots, dtype_bytes=ib, policy=old.mode)
            entry = tuner.decide_preempt(axis, slots, page_bytes,
                                         n_params, dtype_str=dtype,
                                         dtype_bytes=ib)
        elif op == "ckpt_interval" and len(shape) == 1:
            managed.resolve_checkpoint(
                axis, step_s, shape[0], mtbf_s=mtbf_s,
                interval=old.chunks)
            entry = tuner.decide_ckpt(axis, n_new, shape[0], step_s,
                                      mtbf_s=mtbf_s)
        else:
            continue
        # the replayed winner carries forward; measurements start fresh
        entry.mode, entry.chunks = old.mode, old.chunks
        replayed.append({"op": op, "axis": axis, "old_key": old_key,
                         "new_key": entry.key, "mode": old.mode,
                         "chunks": old.chunks, "old_n": n_old,
                         "new_n": n_new})

    replayed.extend(replan_program_plans(tuner, new_axis_sizes))
    return replayed


def replan_program_plans(tuner: ScheduleTuner,
                         new_axis_sizes: dict[str, int]) -> list[dict]:
    """Re-run the whole-program planner over every persisted ProgramPlan
    on the NEW topology.  Each stored plan's CommOps are rebuilt with the
    new axis extents and their per-rank payloads rescaled (total bytes
    conserved, like the call-site replay above); the joint pass then
    re-searches the knob space from scratch — a knob the old topology
    forced off its local optimum may be free again on the new one.  The
    fresh plan is stored under the new-topology key and one
    ``program_plan`` record per re-plan is returned (and logged to the
    decision trail by ``plan_program`` itself)."""
    from repro_torch.plan.ir import CommOp
    from repro_torch.plan.planner import plan_program

    #: per-rank meta fields that shrink/grow with the shard count
    local_fields = ("tokens_local", "s_local", "rows_local")

    out: list[dict] = []
    for old_key, d in sorted(tuner.program_plans.items()):
        ops = [CommOp.from_dict(o) for o in d.get("ops", [])]
        if not ops:
            continue
        changed = False
        for op in ops:
            n_old = max(1, op.axis_size)
            n_new = int(new_axis_sizes.get(op.axis, n_old))
            if n_new == n_old:
                continue
            changed = True
            op.axis_size = n_new
            op.nbytes = max(1, op.nbytes * n_old // n_new)
            for f in local_fields:
                if f in op.meta:
                    op.meta[f] = max(1, int(op.meta[f]) * n_old // n_new)
        plan = plan_program(ops, hw=tuner.hw,
                            notes=[f"replanned from {old_key}"]
                            if changed else [])
        tuner.store_program_plan(plan)
        out.append({"op": "program_plan", "axis": plan.topology,
                    "old_key": old_key,
                    "new_key": tuner.program_plan_key(plan.signature,
                                                      plan.topology),
                    "mode": "coordinated" if plan.coordinated else "local",
                    "chunks": len(plan.choices),
                    "old_n": 0, "new_n": 0})
    return out
