"""Comm-IR: every declared or extracted communication as one ``CommOp``
(port of ``repro.plan.ir``).

A ``CommOp`` is the planner's unit of work — one communication decision
site with everything the joint cost pass needs: which mesh axis it
crosses, how many bytes, WHEN during the step its operand is ready /
consumed (the readiness window, normalised to [0, 1] of the step), and
the kind-specific geometry the cost model prices from.

Two lowering sources, cross-checked against each other:

  * ``lower_specs`` / ``lower_region`` — the declarative source: every
    ``CommSpec`` a ``CommRegion`` declares (send/recv/collective, halo,
    attention, pipeline, moe, serve(+preempt), checkpoint) lowers to one
    op whose window comes from the region's instrumented readiness when
    available.
  * ``lower_collectives`` — the extracted source: the collectives the
    instrumentation's recorder sees (primitive, axis, payload bytes,
    depth) lower to generic collective ops windowed by program depth.

``crosscheck_collectives`` reconciles the two: per mesh axis, the bytes
the declarations claim should cover what the trace actually moves —
a declaration the trace never exercises, or traced traffic nothing
declared, is exactly the drift the paper's managed runtime exists to
catch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.core import instrument

#: CommSpec.kind -> the DecisionRecord op name the knob resolves under
#: (core/managed.py DECISION_OPS).  send/recv declarations price as the
#: all_gather family — the managed runtime executes them that way.
_KIND_TO_OP = {
    "send": "all_gather",
    "recv": "all_gather",
    "all_gather": "all_gather",
    "reduce_scatter": "reduce_scatter",
    "all_reduce": "all_reduce",
    "all_to_all": "all_to_all",
    "halo": "halo_aggregation",
    "attention": "attention_schedule",
    "pipeline": "pipeline_schedule",
    "moe": "moe_dispatch",
    "serve": "serve_schedule",
    "preempt": "preempt_policy",
    "ckpt": "ckpt_interval",
}

#: default readiness window per kind when no instrumented record pins it:
#: fwd-path streams occupy the front of the step, gradient reductions the
#: back half, step-level schedules (pipeline handoffs, serving quanta)
#: the whole step, recovery traffic the tail.  Deterministic by design —
#: the planner's contention sets must not depend on trace luck.
_DEFAULT_WINDOW = {
    "attention": (0.0, 0.6),
    "moe": (0.1, 0.7),
    "halo": (0.0, 0.6),
    "pipeline": (0.0, 1.0),
    "serve": (0.0, 1.0),
    "preempt": (0.0, 1.0),
    "ckpt": (0.9, 1.0),
    "all_reduce": (0.4, 1.0),       # gradient sync lives in the backward
    "reduce_scatter": (0.4, 1.0),
}


@dataclasses.dataclass
class CommOp:
    """One communication decision site in the program."""
    kind: str                       # CommSpec kind family (see _KIND_TO_OP)
    label: str                      # source declaration / extraction label
    op_name: str                    # DecisionRecord op the knob logs under
    axis: str                       # mesh axis the bytes cross
    axis_size: int
    nbytes: int                     # per-rank payload of one execution
    dtype_bytes: int = 4
    phase: str = "step"             # fwd | bwd | step | io
    window: tuple[float, float] = (0.0, 1.0)   # readiness in [0, 1]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.op_name}|{self.axis}|{self.label}"

    def overlaps(self, other: "CommOp") -> bool:
        """Same link, intersecting readiness windows — the ops CONTEND."""
        if self.axis != other.axis:
            return False
        a0, a1 = self.window
        b0, b1 = other.window
        return a0 < b1 and b0 < a1

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["window"] = list(self.window)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CommOp":
        d = dict(d)
        d["window"] = tuple(d.get("window", (0.0, 1.0)))
        return cls(**d)


def _window_from_report(spec_kind: str, label: str,
                        report: instrument.RegionReport | None
                        ) -> tuple[float, float]:
    """Readiness window of a declared operand: sends open when the last
    write lands (instrumented readiness) and run to the end of the step;
    recvs open at step start and close at the first read (consumption
    slack).  Falls back to the kind's deterministic default."""
    default = _DEFAULT_WINDOW.get(spec_kind, (0.0, 1.0))
    if report is None or label not in report.records:
        return default
    rec = report.records[label]
    total = report.total_eqns
    if rec.writes > 0:
        t0 = max(0.0, min(1.0, rec.readiness(total)))
        return (t0, 1.0) if t0 < 1.0 else (0.99, 1.0)
    t1 = max(0.0, min(1.0, rec.consumption_slack(total)))
    return (0.0, t1) if t1 > 0.0 else (0.0, 0.01)


def _phase_for(kind: str) -> str:
    if kind in ("attention", "moe", "halo", "send", "recv", "all_gather",
                "all_to_all"):
        return "fwd"
    if kind in ("all_reduce", "reduce_scatter"):
        return "bwd"
    if kind == "ckpt":
        return "io"
    return "step"


def lower_specs(specs: Sequence[Any], axis_sizes: dict[str, int],
                report: instrument.RegionReport | None = None
                ) -> list[CommOp]:
    """Lower ``CommSpec`` declarations (core/region.py) to CommOps.

    Each spec's packed ``shape`` tuple is unpacked into the meta dict the
    planner's pricing needs — the same encodings ``CommRegion.plan``
    feeds the per-kind resolvers."""
    ops: list[CommOp] = []
    for spec in specs:
        kind = spec.kind
        op_name = _KIND_TO_OP.get(kind)
        if op_name is None:        # a collective family named directly
            op_name = _KIND_TO_OP.get(spec.collective, "all_gather")
        n = int(axis_sizes.get(spec.axis, 1))
        meta: dict[str, Any] = {"collective": spec.collective}
        site = getattr(spec, "site", None)
        if site is not None:            # declaration provenance -> diagnostics
            meta["site"] = (str(site[0]), int(site[1]))
        dtype_bytes = 4
        if kind == "halo" and spec.shape is not None:
            rows_local, cols = spec.shape
            dtype_bytes = max(1, spec.nbytes // max(1, cols))
            meta.update(rows_local=int(rows_local), cols=int(cols))
        elif kind == "attention" and spec.shape is not None:
            (batch, s_local, heads, kv_heads, head_dim, d_model, causal,
             ib) = spec.shape
            dtype_bytes = int(ib)
            meta.update(batch=int(batch), s_local=int(s_local),
                        heads=int(heads), kv_heads=int(kv_heads),
                        head_dim=int(head_dim), d_model=int(d_model),
                        causal=bool(causal))
        elif kind == "pipeline" and spec.shape is not None:
            n_layers, fwd_ps = spec.shape
            meta.update(n_layers=int(n_layers),
                        batch_fwd_s=float(fwd_ps) * 1e-12,
                        batch_bytes=int(spec.nbytes))
        elif kind == "moe" and spec.shape is not None:
            (tokens_local, d_model, n_experts, top_k, d_ff_expert,
             cf_milli, mults, ib) = spec.shape
            dtype_bytes = int(ib)
            meta.update(tokens_local=int(tokens_local),
                        d_model=int(d_model), n_experts=int(n_experts),
                        top_k=int(top_k), d_ff_expert=int(d_ff_expert),
                        capacity_factor=float(cf_milli) / 1000.0,
                        mults=int(mults))
        elif kind == "serve" and spec.shape is not None:
            (batch_slots, mean_prompt, mean_new, max_prompt, n_params,
             ib) = spec.shape
            dtype_bytes = int(ib)
            meta.update(batch_slots=int(batch_slots),
                        mean_prompt=int(mean_prompt),
                        mean_new=int(mean_new), max_prompt=int(max_prompt),
                        n_params=int(n_params))
        elif kind == "preempt" and spec.shape is not None:
            (batch_slots, page_bytes, mean_pages, mean_prompt, n_params,
             ib) = spec.shape
            dtype_bytes = int(ib)
            meta.update(batch_slots=int(batch_slots),
                        page_bytes=int(page_bytes),
                        mean_pages=int(mean_pages),
                        replay_tokens=int(mean_prompt),
                        n_params=int(n_params))
        elif kind == "ckpt" and spec.shape is not None:
            snapshot_bytes, step_ns, mtbf_s, bw = spec.shape
            meta.update(snapshot_bytes=int(snapshot_bytes),
                        step_s=float(step_ns) * 1e-9,
                        mtbf_s=float(mtbf_s),
                        write_bw=float(bw) if bw else None)
        ops.append(CommOp(
            kind=kind, label=spec.label, op_name=op_name, axis=spec.axis,
            axis_size=n, nbytes=int(spec.nbytes), dtype_bytes=dtype_bytes,
            phase=_phase_for(kind),
            window=_window_from_report(kind, spec.label, report),
            meta=meta))
    return ops


def lower_region(region: Any,
                 report: instrument.RegionReport | None = None
                 ) -> list[CommOp]:
    """Lower everything a ``CommRegion`` declares.  ``report`` (from
    ``instrument.analyze_region`` / ``region.plan``) refines windows with
    the instrumented readiness of each tracked operand."""
    return lower_specs(region._specs, region.axis_sizes, report)


def lower_collectives(records: Sequence[instrument.CollectiveRecord],
                      axis_sizes: dict[str, int],
                      max_depth: int | None = None) -> list[CommOp]:
    """Lower the collectives the instrumentation recorded.  Depth
    orders the window: a collective at depth d of D occupies the
    [d/D, 1] tail of the step (its operand is ready once the producing
    program prefix ran)."""
    total = max_depth if max_depth is not None else \
        max((r.depth for r in records), default=1)
    total = max(1, total)
    prim_to_op = {"psum": "all_reduce", "psum_scatter": "reduce_scatter",
                  "ppermute": "all_to_all"}
    ops = []
    for i, r in enumerate(records):
        op_name = prim_to_op.get(r.primitive, r.primitive)
        if op_name not in _KIND_TO_OP.values():
            op_name = "all_gather"
        t0 = max(0.0, min(0.99, r.depth / total))
        meta: dict[str, Any] = {"collective": op_name,
                                "depth": int(r.depth),
                                "primitive": r.primitive,
                                "trips": int(getattr(r, "trips", 1))}
        src = getattr(r, "source", "")
        if src:                         # call-site provenance -> diagnostics
            meta["source"] = src
        ops.append(CommOp(
            kind="collective", label=f"{r.primitive}#{i}", op_name=op_name,
            axis=r.axis, axis_size=int(axis_sizes.get(r.axis, 1)),
            nbytes=int(r.nbytes), phase="fwd", window=(t0, 1.0),
            meta=meta))
    return ops


def crosscheck_collectives(ops: Sequence[CommOp],
                           report: instrument.RegionReport
                           ) -> list[str]:
    """Reconcile declared ops against the trace's extracted collectives.

    Returns human-readable discrepancy notes (empty = consistent): a mesh
    axis whose TRACED bytes exceed what the declarations cover means
    undeclared traffic the planner cannot coordinate; declared bytes with
    no traced collective on that axis means the declaration didn't
    execute (stale region)."""
    declared: dict[str, int] = {}
    for op in ops:
        declared[op.axis] = declared.get(op.axis, 0) + op.nbytes
    traced = report.collective_bytes_by_axis()
    notes: list[str] = []
    for axis, tb in sorted(traced.items()):
        db = declared.get(axis, 0)
        if db == 0:
            notes.append(f"axis {axis}: {tb}B traced but nothing declared")
        elif tb > 4 * db:
            notes.append(f"axis {axis}: traced {tb}B >> declared {db}B")
    for axis, db in sorted(declared.items()):
        if db > 0 and traced and axis not in traced:
            notes.append(f"axis {axis}: {db}B declared, none traced")
    return notes


def train_geometry(cfg, *, mesh_axes: dict[str, int], batch: int, seq: int,
                   hw, pipeline: str = "none") -> dict:
    """Build the per-subsystem geometry dicts a training launch lowers
    from — the single source launch/train.py's planner path AND the
    static-verifier preflight (launch/lint.py) share, so the linted
    program is exactly the planned one.

    Returns ``{"mesh_axes", "grad_bytes", "attention", "moe",
    "pipeline"}`` — feed the last four straight into ``lower_train_ops``.
    """
    ib = instrument.itemsize(cfg.dtype)
    dp = int(mesh_axes.get("data", 1))
    tp = int(mesh_axes.get("model", 1))
    pods = int(mesh_axes.get("pod", 1))
    b_loc = max(1, int(batch) // max(1, dp))
    attention = None
    if getattr(cfg, "n_heads", 0) and tp > 1:
        attention = {"batch": b_loc, "s_local": max(1, seq // tp),
                     "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
                     "head_dim": cfg.head_dim, "d_model": cfg.d_model,
                     "causal": True, "dtype_bytes": ib}
    moe_geom = None
    if getattr(cfg, "moe", None) is not None and tp > 1:
        moe_geom = {"tokens_local": b_loc * seq,
                    "d_model": cfg.d_model,
                    "n_experts": cfg.moe.n_experts,
                    "top_k": cfg.moe.top_k,
                    "d_ff_expert": cfg.moe.d_ff_expert,
                    "capacity_factor": cfg.moe.capacity_factor,
                    "mults": 3, "dtype_bytes": ib}
    pipe_geom = None
    if pipeline != "none":
        # mirror build_train_step's cost-model inputs exactly
        n_stage = pods
        pipe_geom = {
            "axis": "pod", "n_layers": cfg.n_layers,
            "batch_fwd_s": (2.0 * cfg.param_count() / n_stage
                            * (b_loc * seq) / hw.peak_flops),
            "batch_bytes": (b_loc * (seq // max(1, tp))
                            * cfg.d_model * ib),
            "local_batch": b_loc,
            "candidate_micro": tuple(
                m for m in (1, 2, 4, 8, 16, 32, 64)
                if b_loc % m == 0)}
    return {"mesh_axes": dict(mesh_axes),
            "grad_bytes": int(cfg.param_count()) * 4,
            "attention": attention, "moe": moe_geom,
            "pipeline": pipe_geom}


def lower_train_ops(*, mesh_axes: dict[str, int], model_axis: str = "model",
                    data_axes: Sequence[str] = ("pod", "data"),
                    grad_bytes: int = 0, dtype_bytes: int = 4,
                    pipeline: dict | None = None,
                    attention: dict | None = None,
                    moe: dict | None = None) -> list[CommOp]:
    """Lower a training step's communication set without a trace — the
    launch-path source (launch/train.py --plan).  Emits:

      * one gradient all_reduce per replicated data axis (``grad_bytes``
        per rank, backward window),
      * the pipeline handoff op on its axis when ``pipeline`` geometry is
        given ({axis, n_layers, batch_fwd_s, batch_bytes}),
      * the attention schedule op on the model axis when ``attention``
        geometry is given (resolve_attention_schedule kwargs),
      * the MoE dispatch op on the model axis when ``moe`` geometry is
        given (resolve_moe_dispatch kwargs).
    """
    ops: list[CommOp] = []
    if attention and mesh_axes.get(model_axis, 1) > 1:
        a = dict(attention)
        ib = int(a.get("dtype_bytes", 2))
        nbytes = (2 * a["batch"] * a["s_local"] * a["kv_heads"]
                  * a["head_dim"] * ib)
        ops.append(CommOp(
            kind="attention", label="train.attention",
            op_name="attention_schedule", axis=model_axis,
            axis_size=mesh_axes[model_axis], nbytes=nbytes,
            dtype_bytes=ib, phase="fwd",
            window=_DEFAULT_WINDOW["attention"], meta=a))
    if moe and mesh_axes.get(model_axis, 1) > 1:
        m = dict(moe)
        ib = int(m.get("dtype_bytes", 2))
        from repro_torch.core import cost_model
        cap = cost_model.moe_capacity(m["tokens_local"], m["top_k"],
                                      m["n_experts"],
                                      m.get("capacity_factor", 1.25))
        nbytes = m["n_experts"] * cap * m["d_model"] * ib
        ops.append(CommOp(
            kind="moe", label="train.moe", op_name="moe_dispatch",
            axis=model_axis, axis_size=mesh_axes[model_axis],
            nbytes=nbytes, dtype_bytes=ib, phase="fwd",
            window=_DEFAULT_WINDOW["moe"], meta=m))
    if pipeline:
        p = dict(pipeline)
        axis = p.pop("axis", "pod")
        ops.append(CommOp(
            kind="pipeline", label="train.pipeline",
            op_name="pipeline_schedule", axis=axis,
            axis_size=mesh_axes.get(axis, 1),
            nbytes=int(p.get("batch_bytes", 0)), phase="step",
            window=_DEFAULT_WINDOW["pipeline"], meta=p))
    for axis in data_axes:
        if mesh_axes.get(axis, 1) > 1 and grad_bytes > 0:
            # pipeline training syncs grads over the pipeline axis via the
            # stage executor, not a step-level all_reduce — skip it there
            if pipeline and axis == (pipeline.get("axis") or "pod"):
                continue
            ops.append(CommOp(
                kind="all_reduce", label=f"train.grads.{axis}",
                op_name="all_reduce", axis=axis,
                axis_size=mesh_axes[axis], nbytes=int(grad_bytes),
                dtype_bytes=dtype_bytes, phase="bwd",
                window=_DEFAULT_WINDOW["all_reduce"],
                meta={"collective": "all_reduce"}))
    return ops
