"""Communication regions — the paper's ``#pragma commregion`` facade
(port of ``repro.core.region``).

A ``CommRegion`` is the declarative surface of MDMP: the user states which
operands are sent/received (``region.send(...)`` / ``region.recv(...)``)
and wraps the computation that produces/consumes them.  The region then

  1. runs the wrapped function once under the data-access instrumentation
     (instrument.py: on meta specs it allocates and launches nothing) to
     find each operand's readiness / consumption slack — the analogue of
     the paper's runtime read/write counters;
  2. feeds operand bytes + the overlap budget into the alpha-beta cost
     model to pick bulk vs interleaved and a chunk count per declaration;
  3. exposes the resulting ``Plan`` and executes managed collectives
     accordingly.

Outside a region (paper Table 2), nothing is instrumented and every
managed op that specifies ``mode=None`` falls through to the global
MDMPConfig — by default plain bulk collectives with zero overhead.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Sequence

from repro_torch.core import cost_model, instrument
from repro_torch.core.managed import MDMPConfig, get_config


def _decl_site() -> tuple | None:
    """Repo-relative (file, line) of the user frame declaring a spec —
    the provenance the static verifier renders next to each diagnostic."""
    import inspect
    try:
        for fr in inspect.stack(context=0)[2:8]:
            fn = fr.filename
            if fn.replace("\\", "/").endswith("core/region.py"):
                continue
            for marker in instrument.SOURCE_MARKERS:
                i = fn.find(marker)
                if i >= 0:
                    return (fn[i:], fr.lineno)
            return (os.path.basename(fn), fr.lineno)
    except Exception:
        pass
    return None


class UnknownAxisError(ValueError):
    """A declaration references a mesh axis the region does not know.

    Before this check, a typo'd axis name silently priced as size-1
    (every ``axis_sizes.get(axis, 1)`` lookup), so the declaration cost
    nothing and the managed runtime never scheduled it — exactly the
    silent-drift class the static verifier (repro.analysis, MDMP001)
    exists to catch."""

    def __init__(self, region: str, label: str, axis: str,
                 known: Sequence[str]):
        self.region = region
        self.label = label
        self.axis = axis
        self.known = tuple(known)
        super().__init__(
            f"region {region!r}: declaration {label!r} names axis "
            f"{axis!r}, not one of the region's mesh axes "
            f"{sorted(known)} — a typo'd axis would silently price as "
            f"size-1 and never be scheduled (MDMP001)")


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """One declared communication (a ``#pragma send``/``recv``/collective)."""
    label: str
    kind: str                  # "send" | "recv" | "all_gather" | "halo" ...
    axis: str                  # mesh axis the message crosses
    nbytes: int
    collective: str = "all_gather"   # cost-model family
    #: (rows_local, cols) of the stencil block for kind="halo" — the
    #: aggregation decision needs the block geometry, not just bytes
    shape: tuple | None = None
    #: repo-relative (file, line) of the declaring call — the static
    #: verifier's diagnostics point a drifted declaration back here
    site: tuple | None = None


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    spec: CommSpec
    mode: str
    chunks: int
    overlap_budget: float      # fraction of region compute available
    predicted_bulk_s: float
    predicted_interleaved_s: float


@dataclasses.dataclass
class Plan:
    entries: dict[str, PlanEntry]
    total_eqns: int

    def mode_for(self, label: str) -> str:
        return self.entries[label].mode

    def chunks_for(self, label: str) -> int:
        return self.entries[label].chunks

    def k_for(self, label: str) -> int:
        """Aggregation factor chosen for a halo declaration (sweeps per
        k-row exchange; 1 = bulk).  Alias of ``chunks_for`` — the k rides
        in the chunks slot."""
        return self.entries[label].chunks

    def schedule_for(self, label: str) -> str:
        """Schedule chosen for an attention declaration ("bulk" |
        "ulysses" | "ring").  Alias of ``mode_for`` — the schedule name
        rides in the mode slot; feed it to models/attention.py dispatch
        (or ``cfg.attn_impl``, mapping "bulk" -> "megatron")."""
        return self.entries[label].mode

    def summary(self) -> str:
        lines = [f"MDMP plan ({self.total_eqns} eqns in region):"]
        for e in self.entries.values():
            lines.append(
                f"  {e.spec.label:24s} {e.spec.kind:12s} axis={e.spec.axis} "
                f"{e.spec.nbytes/1e6:9.3f}MB -> {e.mode}(chunks={e.chunks}) "
                f"overlap_budget={e.overlap_budget:.2f} "
                f"bulk={e.predicted_bulk_s*1e6:.1f}us "
                f"interleaved={e.predicted_interleaved_s*1e6:.1f}us")
        return "\n".join(lines)


class CommRegion:
    """Declarative communication region.

    Usage (the paper's Figure 4, in PyTorch)::

        region = CommRegion("jacobi", axis_sizes={"x": 16})
        region.send("halo_lo", axis="x", shape=(NP,), dtype=torch.float32)
        region.send("halo_hi", axis="x", shape=(NP,), dtype=torch.float32)
        plan = region.plan(step_fn, Spec((M, NP)))   # instrument + decide
        mode = plan.mode_for("halo_lo")        # feed into managed halo call
    """

    def __init__(self, name: str, axis_sizes: dict[str, int],
                 config: MDMPConfig | None = None):
        self.name = name
        self.axis_sizes = dict(axis_sizes)
        self.config = config or get_config()
        self._specs: list[CommSpec] = []
        self._plan: Plan | None = None
        self._report: instrument.RegionReport | None = None

    # -- declarations -------------------------------------------------------

    def _add_spec(self, spec: CommSpec) -> None:
        """Validate + append one declaration.  An axis name absent from
        ``axis_sizes`` raises ``UnknownAxisError`` HERE, at declaration
        time — before this check a typo'd axis silently priced as size-1
        (``axis_sizes.get(axis, 1)``) and the communication was never
        scheduled."""
        if spec.axis not in self.axis_sizes:
            raise UnknownAxisError(self.name, spec.label, spec.axis,
                                   self.axis_sizes.keys())
        if spec.site is None:
            spec = dataclasses.replace(spec, site=_decl_site())
        self._specs.append(spec)

    def _declare(self, label: str, kind: str, axis: str, shape, dtype,
                 collective: str) -> None:
        nbytes = _numel(shape) * instrument.itemsize(dtype)
        self._add_spec(CommSpec(label=label, kind=kind, axis=axis,
                                nbytes=nbytes, collective=collective))

    def send(self, label: str, *, axis: str, shape, dtype) -> None:
        self._declare(label, "send", axis, shape, dtype, "all_gather")

    def recv(self, label: str, *, axis: str, shape, dtype) -> None:
        self._declare(label, "recv", axis, shape, dtype, "all_gather")

    def collective(self, label: str, *, axis: str, shape, dtype,
                   collective: str) -> None:
        self._declare(label, collective, axis, shape, dtype, collective)

    def halo(self, label: str, *, axis: str, rows_local: int, cols: int,
             dtype) -> None:
        """Declare a stencil halo exchange (rows sharded over ``axis``).
        Planning runs the AGGREGATION decision for it: the resulting
        PlanEntry's ``chunks`` is the chosen k (sweeps per k-row exchange;
        1 = bulk), to be passed to ``halo.jacobi_solve(mode="aggregated",
        k=plan.chunks_for(label))``."""
        nbytes = int(cols) * instrument.itemsize(dtype)   # one 1-row slab
        self._add_spec(CommSpec(label=label, kind="halo", axis=axis,
                                nbytes=nbytes, collective="halo",
                                shape=(int(rows_local), int(cols))))

    def attention(self, label: str, *, axis: str, batch: int, s_local: int,
                  heads: int, kv_heads: int, head_dim: int, d_model: int,
                  dtype, causal: bool = True) -> None:
        """Declare an SP attention call site (q sequence-sharded over
        ``axis``).  Planning runs the three-way schedule decision for it:
        the resulting PlanEntry's ``mode`` is the chosen schedule ("bulk" |
        "ulysses" | "ring"), read back via ``plan.schedule_for(label)``."""
        ib = instrument.itemsize(dtype)
        nbytes = 2 * batch * s_local * kv_heads * head_dim * ib  # kv block
        self._add_spec(CommSpec(
            label=label, kind="attention", axis=axis, nbytes=nbytes,
            collective="attention",
            shape=(int(batch), int(s_local), int(heads), int(kv_heads),
                   int(head_dim), int(d_model), int(causal), int(ib))))

    def pipeline(self, label: str, *, axis: str, n_layers: int,
                 batch_shape, dtype, batch_fwd_s: float) -> None:
        """Declare a pipeline-parallel stage boundary (layers chunked over
        ``axis``; ``batch_shape`` is the WHOLE batch's activation block at
        the boundary — each tick hands off 1/M of it).  Planning runs the
        pipeline-schedule decision for it, with the boundary operand's
        instrumented readiness as the overlap budget: the resulting
        PlanEntry's ``mode`` is the chosen schedule ("gpipe" | "1f1b" |
        "interleaved", read back via ``plan.schedule_for(label)``) and
        ``chunks`` the microbatch count M, to be fed to
        ``parallel/pipeline.build_schedule``."""
        ib = instrument.itemsize(dtype)
        nbytes = _numel(batch_shape) * ib
        self._add_spec(CommSpec(
            label=label, kind="pipeline", axis=axis, nbytes=nbytes,
            collective="pipeline",
            shape=(int(n_layers), int(round(batch_fwd_s * 1e12)))))

    def moe(self, label: str, *, axis: str, tokens_local: int,
            d_model: int, n_experts: int, top_k: int, d_ff_expert: int,
            dtype, capacity_factor: float = 1.25,
            mults: int = 3) -> None:
        """Declare an MoE expert-dispatch call site (experts sharded by
        id over ``axis``; ``tokens_local`` routed top-k per layer).
        Planning runs the three-way dispatch decision for it: the
        resulting PlanEntry's ``mode`` is the chosen schedule ("bulk" |
        "stream" | "dense", read back via ``plan.schedule_for(label)``)
        and ``chunks`` the stream chunk count g; the chosen capacity
        factor rides in the decision the managed runtime logs."""
        ib = instrument.itemsize(dtype)
        cap = cost_model.moe_capacity(tokens_local, top_k, n_experts,
                                      capacity_factor)
        self._add_spec(CommSpec(
            label=label, kind="moe", axis=axis,
            nbytes=n_experts * cap * d_model * ib, collective="moe",
            shape=(int(tokens_local), int(d_model), int(n_experts),
                   int(top_k), int(d_ff_expert),
                   int(round(capacity_factor * 1000)), int(mults),
                   int(ib))))

    def serve(self, label: str, *, axis: str, batch_slots: int,
              mean_prompt: int, mean_new: int, n_params: int, dtype,
              max_prompt: int | None = None,
              page_bytes: int | None = None,
              mean_pages: int = 1) -> None:
        """Declare a serving call site (the engine's step loop over
        ``batch_slots`` decode slots).  Planning runs the serve-schedule
        decision for it: the resulting PlanEntry's ``mode`` is the chosen
        batching mode ("static" | "continuous") and ``chunks`` the
        scheduling quantum C, read back via ``plan.mode_for(label)`` /
        ``plan.chunks_for(label)`` and fed to ``serve/scheduler.py``.

        When ``page_bytes`` is given (per-KV-page bytes across layers)
        the overload backstop is declared too: an extra
        ``{label}.preempt`` spec whose planned ``mode`` is the preempt
        policy ("swap" | "recompute" | "wait") the engine should start
        from when the page pool exhausts, priced for a mean victim of
        ``mean_pages`` pages holding ``mean_prompt`` replayable tokens."""
        ib = instrument.itemsize(dtype)
        self._add_spec(CommSpec(
            label=label, kind="serve", axis=axis,
            nbytes=int(n_params) * ib, collective="serve",
            shape=(int(batch_slots), int(mean_prompt), int(mean_new),
                   int(max_prompt if max_prompt is not None
                       else mean_prompt), int(n_params), int(ib))))
        if page_bytes is not None:
            self._add_spec(CommSpec(
                label=f"{label}.preempt", kind="preempt", axis=axis,
                nbytes=int(mean_pages) * int(page_bytes),
                collective="preempt",
                shape=(int(batch_slots), int(page_bytes),
                       int(mean_pages), int(mean_prompt), int(n_params),
                       int(ib))))

    def checkpoint(self, label: str, *, axis: str, snapshot_bytes: int,
                   step_s: float, mtbf_s: float = 1800.0,
                   write_bw: float | None = None) -> None:
        """Declare the checkpoint recovery traffic of a train loop (the
        D2H snapshot drain, ``snapshot_bytes`` per save).  Planning runs
        the Young/Daly cadence decision for it: the resulting PlanEntry's
        ``chunks`` is the chosen interval in steps (``mode`` is "daly" |
        "fixed"), read back via ``plan.chunks_for(label)`` and fed to
        ``TrainLoopConfig.ckpt_every`` — recovery traffic priced like any
        other declared communication."""
        self._add_spec(CommSpec(
            label=label, kind="ckpt", axis=axis,
            nbytes=int(snapshot_bytes), collective="ckpt",
            shape=(int(snapshot_bytes), int(round(step_s * 1e9)),
                   int(round(mtbf_s)),
                   int(round(write_bw)) if write_bw else 0)))

    # -- planning -----------------------------------------------------------

    def plan(self, fn: Callable, *example_args: Any,
             tracked_args: Sequence[int] | None = None,
             compute_time_s: float | None = None) -> Plan:
        """Run ``fn`` (the region body, per-shard view) once under the
        instrumentation, record the access pattern of the tracked args
        (positionally matched to the declared specs) and decide each
        communication's schedule.  Example arguments may be specs
        (``instrument.Spec``)."""
        n_specs = len(self._specs)
        if tracked_args is None:
            tracked_args = list(range(min(n_specs, 1)))
        labels = [s.label for s in self._specs[:len(tracked_args)]]
        report = instrument.analyze_region(
            fn, *example_args, tracked_args=list(tracked_args), labels=labels)
        self._report = report

        from repro_torch.core import managed

        entries: dict[str, PlanEntry] = {}
        for spec in self._specs:
            if spec.kind == "halo":
                # The aggregation knob: pick k sweeps per exchange.  Routed
                # through managed.resolve_halo_aggregation so the choice
                # lands in the MDMP decision log like every other schedule.
                rows_local, cols = spec.shape
                n = self.axis_sizes.get(spec.axis, 1)
                with managed.use_config(self.config):
                    d = managed.resolve_halo_aggregation(
                        spec.axis, n, rows_local, cols,
                        dtype_bytes=max(1, spec.nbytes // max(1, cols)))
                entries[spec.label] = PlanEntry(
                    spec=spec, mode=d.mode, chunks=d.k, overlap_budget=1.0,
                    predicted_bulk_s=d.bulk_sweep_s,
                    predicted_interleaved_s=d.aggregated_sweep_s)
                continue
            if spec.kind == "attention":
                # The schedule knob: bulk gather vs ulysses a2a vs ring
                # streaming, routed through the managed runtime so the
                # choice lands in the MDMP decision log.
                (batch, s_local, heads, kv_heads, head_dim, d_model,
                 causal, ib) = spec.shape
                n = self.axis_sizes.get(spec.axis, 1)
                with managed.use_config(self.config):
                    d = managed.resolve_attention_schedule(
                        spec.axis, n, batch, s_local, heads, kv_heads,
                        head_dim, d_model, dtype_bytes=ib,
                        causal=bool(causal))
                entries[spec.label] = PlanEntry(
                    spec=spec, mode=d.schedule, chunks=1,
                    overlap_budget=1.0, predicted_bulk_s=d.bulk_s,
                    predicted_interleaved_s=d.chosen_s)
                continue
            if spec.kind == "pipeline":
                # The schedule knob: gpipe vs 1f1b vs interleaved plus the
                # microbatch count, routed through the managed runtime so
                # the choice lands in the MDMP decision log.  The stage
                # boundary's instrumented readiness bounds how much of a
                # tick's compute can hide the handoff bytes.
                n_layers, fwd_ps = spec.shape
                n = self.axis_sizes.get(spec.axis, 1)
                budget = (report.overlap_budget(spec.label)
                          if spec.label in report.records else 1.0)
                with managed.use_config(self.config):
                    d = managed.resolve_pipeline_schedule(
                        spec.axis, n, fwd_ps * 1e-12, spec.nbytes,
                        n_layers=n_layers, overlap_budget=budget)
                entries[spec.label] = PlanEntry(
                    spec=spec, mode=d.schedule, chunks=d.n_micro,
                    overlap_budget=budget, predicted_bulk_s=d.bulk_s,
                    predicted_interleaved_s=d.chosen_s)
                continue
            if spec.kind == "moe":
                # The dispatch knob: bulk a2a vs chunked-stream vs dense
                # fallback plus the capacity factor, routed through the
                # managed runtime so the choice lands in the MDMP
                # decision log.
                (tokens_local, d_model, n_experts, top_k, d_ff_expert,
                 cf_milli, mults, ib) = spec.shape
                n = self.axis_sizes.get(spec.axis, 1)
                with managed.use_config(self.config):
                    d = managed.resolve_moe_dispatch(
                        spec.axis, n, tokens_local, d_model, n_experts,
                        top_k, d_ff_expert, mults=mults, dtype_bytes=ib,
                        capacity_factor=cf_milli / 1000.0)
                entries[spec.label] = PlanEntry(
                    spec=spec, mode=d.schedule, chunks=d.g,
                    overlap_budget=1.0, predicted_bulk_s=d.bulk_s,
                    predicted_interleaved_s=d.chosen_s)
                continue
            if spec.kind == "ckpt":
                # The cadence knob: the Young/Daly interval, routed
                # through the managed runtime so the choice lands in the
                # MDMP decision log — recovery traffic priced like the
                # forward-path collectives.
                nbytes, step_ns, mtbf_s, bw = spec.shape
                with managed.use_config(self.config):
                    d = managed.resolve_checkpoint(
                        spec.axis, step_ns * 1e-9, nbytes,
                        mtbf_s=float(mtbf_s),
                        measured_write_bw=float(bw) if bw else None)
                entries[spec.label] = PlanEntry(
                    spec=spec, mode=d.mode, chunks=d.interval,
                    overlap_budget=1.0,
                    predicted_bulk_s=d.fixed_overhead,
                    predicted_interleaved_s=d.chosen_overhead)
                continue
            if spec.kind == "serve":
                # The batching knob: static waves vs continuous batching
                # plus the scheduling quantum C, routed through the managed
                # runtime so the choice lands in the MDMP decision log.
                (batch_slots, mean_prompt, mean_new, max_prompt,
                 n_params, ib) = spec.shape
                with managed.use_config(self.config):
                    d = managed.resolve_serve_schedule(
                        spec.axis, batch_slots, mean_prompt, mean_new,
                        n_params, dtype_bytes=ib, max_prompt=max_prompt)
                entries[spec.label] = PlanEntry(
                    spec=spec, mode=d.mode, chunks=d.chunk,
                    overlap_budget=1.0,
                    predicted_bulk_s=1.0 / max(d.static_tok_s, 1e-30),
                    predicted_interleaved_s=1.0 / max(d.chosen_tok_s,
                                                      1e-30))
                continue
            if spec.kind == "preempt":
                # The overload backstop knob: swap-to-host vs drop-and-
                # recompute vs head-of-line wait, routed through the
                # managed runtime so the eviction policy lands in the
                # MDMP decision log next to the serve schedule it backs.
                (batch_slots, page_bytes, mean_pages, mean_prompt,
                 n_params, ib) = spec.shape
                with managed.use_config(self.config):
                    d = managed.resolve_preempt(
                        spec.axis, mean_pages, page_bytes, mean_prompt,
                        n_params, batch_slots=batch_slots,
                        dtype_bytes=ib)
                entries[spec.label] = PlanEntry(
                    spec=spec, mode=d.policy, chunks=1,
                    overlap_budget=1.0,
                    predicted_bulk_s=d.recompute_s,
                    predicted_interleaved_s=d.chosen_s)
                continue
            budget = (report.overlap_budget(spec.label)
                      if spec.label in report.records else 1.0)
            # Compute time available for overlap: caller-supplied estimate
            # scaled by the instrumented budget.
            ct = (compute_time_s or 0.0) * budget
            n = self.axis_sizes.get(spec.axis, 1)
            decision = cost_model.decide(
                spec.nbytes, n, compute_time_s=ct, hw=self.config.hw,
                collective=spec.collective,
                force_mode=None if self.config.mode == "auto"
                else self.config.mode)
            entries[spec.label] = PlanEntry(
                spec=spec, mode=decision.mode, chunks=decision.chunks,
                overlap_budget=budget,
                predicted_bulk_s=decision.bulk_time_s,
                predicted_interleaved_s=decision.interleaved_time_s)
        self._plan = Plan(entries=entries, total_eqns=report.total_eqns)
        return self._plan

    @property
    def last_plan(self) -> Plan | None:
        return self._plan

    @property
    def last_report(self) -> instrument.RegionReport | None:
        """The instrumentation report of the last ``plan()`` — the
        readiness windows and extracted collectives the whole-program
        planner lowers against (plan/ir.lower_region)."""
        return self._report

    def lower(self):
        """Lower this region's declarations to planner CommOps (plan/ir),
        windows refined by the last ``plan()``'s instrumentation when
        available.  Lazy import: core must not depend on plan/."""
        from repro_torch.plan.ir import lower_region
        return lower_region(self, self._report)


def _numel(shape) -> int:
    if isinstance(shape, int):
        return shape
    n = 1
    for d in shape:
        n *= int(d)
    return n
