"""Joint planner: price the WHOLE program's communication schedule.

Per-subsystem resolution (core/managed.py) answers "what is the best
knob for THIS op, assuming the link and the overlap budget are mine?".
That assumption breaks the moment two subsystems' readiness windows
overlap on the same mesh axis — an interleaved pipeline handoff and an
MoE expert stream both claiming the ring each hide their wire under the
same compute ONCE, not once each.  This pass prices the joint schedule:

  * every op's candidate knobs reduce to ``(wire_s, msgs, hide_s,
    stash_bytes)`` components (cost_model.CommComponents) plus a
    knob-dependent compute base;
  * ops are grouped into CONTENTION SETS — connected components of
    (same mesh axis AND overlapping readiness windows);
  * each set draws its wires from ONE ``overlap.OverlapAccount`` seeded
    with the LARGEST single hide any member offers (the compute stream
    hides the link once), pays alpha per message, and pools its stash
    bytes against the capacity cap;
  * coordinate descent over the product knob space, seeded from each
    op's LOCAL pick, walks to a fixpoint — the joint cost of the emitted
    plan is never worse than the local seeds', and strictly better
    whenever backing one op off its local optimum frees the link.

The emitted ``ProgramPlan`` carries one knob per (op, axis); installing
it (``managed.install_plan``) makes every ``resolve_*`` entry point
prefer the planner's knob over local resolution, and the decision trail
gets one DecisionRecord per op plus an ``op="program_plan"`` summary.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import cost_model, managed
from repro_torch.core.cost_model import CommComponents
from repro_torch.core.overlap import OverlapAccount
from repro_torch.obs.tracer import get_tracer
from repro_torch.plan.ir import CommOp

_EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One knob setting for one op, priced to shared-constraint units."""
    knob: dict                      # {"mode", "chunks", ["virtual", ...]}
    comps: CommComponents
    base_s: float = 0.0             # knob-dependent compute (never shared)

    def solo_s(self, alpha: float) -> float:
        """This op's cost if it owned the link (the local resolver's
        objective): exposed wire + message latency + its compute."""
        return self.comps.solo_s(alpha) + self.base_s


def _trivial() -> list[Candidate]:
    return [Candidate(knob={"mode": "bulk", "chunks": 1},
                      comps=CommComponents(0.0, 0, 0.0, 0))]


def _collective_candidates(op: CommOp, hw) -> list[Candidate]:
    coll = op.meta.get("collective", op.op_name)
    if coll not in ("all_gather", "reduce_scatter", "all_reduce",
                    "all_to_all"):
        coll = "all_gather"
    hide = float(op.meta.get("compute_time_s", 0.0))
    out = []
    for mode in ("bulk", "interleaved"):
        for chunks in ((1,) if mode == "bulk" else (1, 2, 4)):
            comps = cost_model.collective_components(
                coll, op.nbytes, op.axis_size, mode=mode, chunks=chunks,
                compute_time_s=hide, hw=hw)
            out.append(Candidate(knob={"mode": mode, "chunks": chunks},
                                 comps=comps))
    return out


def _halo_candidates(op: CommOp, hw) -> list[Candidate]:
    rows_local = int(op.meta.get("rows_local", 1))
    cols = int(op.meta.get("cols", max(1, op.nbytes // op.dtype_bytes)))
    out = []
    for k in (1, 2, 4, 8):
        _, mem, flops = cost_model.halo_sweep_terms(
            k, rows_local, cols, dtype_bytes=op.dtype_bytes, hw=hw,
            axis_size=op.axis_size)
        # per sweep: 2 halo slabs cross the link, alpha amortised 1/k
        wire = 2.0 * cols * op.dtype_bytes / hw.link_bw \
            if op.axis_size > 1 else 0.0
        out.append(Candidate(
            knob={"mode": "bulk" if k == 1 else "aggregated", "chunks": k},
            comps=CommComponents(wire_s=wire, msgs=2.0 / k, hide_s=0.0),
            base_s=max(mem, flops)))
    return out


def _attention_candidates(op: CommOp, hw) -> list[Candidate]:
    m = op.meta
    n = max(1, op.axis_size)
    b, s_local = int(m["batch"]), int(m["s_local"])
    h, kv, hd, d = (int(m["heads"]), int(m["kv_heads"]),
                    int(m["head_dim"]), int(m["d_model"]))
    ib = op.dtype_bytes
    cf = 0.5 if m.get("causal", True) else 1.0
    flash_step = cost_model.attention_flash_step_s(b, s_local, h, hd, hw)
    attn_full = cf * n * flash_step
    x_shard = b * s_local * d * ib
    wq_shard = d * (h * hd // n) * ib
    w_gather_wire = 2.0 * cost_model.collective_wire_s(
        "all_gather", wq_shard, n, hw)
    qo_local = b * s_local * h * hd * ib
    kv_shard = 2.0 * b * s_local * kv * hd * ib
    steps = n - 1
    # msgs = collective DISPATCH counts (cost_model.collective_msgs):
    # bulk/ulysses fire fused ops, the ring fires one permute per step
    cands = [
        Candidate(                   # bulk sequence-gather: AG + RS
            knob={"mode": "bulk", "chunks": 1},
            comps=CommComponents(
                wire_s=(cost_model.collective_wire_s("all_gather",
                                                     x_shard, n, hw)
                        + cost_model.collective_wire_s("reduce_scatter",
                                                       x_shard * n, n, hw)),
                msgs=2, hide_s=0.0),
            base_s=attn_full),
        Candidate(                   # ulysses: 2 w-AG + 2 a2a + kv-AG
            knob={"mode": "ulysses", "chunks": 1},
            comps=CommComponents(
                wire_s=(w_gather_wire
                        + 2.0 * cost_model.collective_wire_s(
                            "all_to_all", qo_local, n, hw)
                        + cost_model.collective_wire_s(
                            "all_gather", kv_shard, n, hw)),
                msgs=5, hide_s=0.0),
            base_s=attn_full),
        Candidate(                   # ring kv streaming: wire hides under
            knob={"mode": "ring", "chunks": 1},   # the per-step flash
            comps=CommComponents(
                wire_s=w_gather_wire + steps * kv_shard / hw.link_bw,
                msgs=2 + steps,
                hide_s=steps * cf * flash_step),
            base_s=attn_full),
    ]
    return cands


def _moe_candidates(op: CommOp, hw) -> list[Candidate]:
    m = op.meta
    n = max(1, op.axis_size)
    layout = m.get("layout", "ep_a2a")
    cf = float(m.get("capacity_factor", 1.25))
    cap, flops_row, comm, dense_ffn = cost_model._moe_terms(
        int(m["tokens_local"]), int(m["d_model"]), int(m["n_experts"]),
        int(m["top_k"]), int(m["d_ff_expert"]), n,
        int(m.get("mults", 3)), op.dtype_bytes, cf, layout, hw)
    occ = min(1.0, 1.0 / max(cf, 1e-6))
    ffn_s = int(m["n_experts"]) * cap * occ * flops_row / hw.peak_flops
    steps = max(1, n - 1)
    wire = max(0.0, comm - 2.0 * steps * hw.alpha_s)
    # msgs = dispatch counts: bulk fires two fused a2a ops, the stream
    # fires ~(2 + g) permutes per ring step (block + counts forward, g
    # chunk returns — managed_expert_stream's issue pattern)
    cands = [Candidate(knob={"mode": "bulk", "chunks": 1,
                             "capacity_factor": cf},
                       comps=CommComponents(wire_s=wire, msgs=2,
                                            hide_s=0.0),
                       base_s=ffn_s)]
    unit = int(m["tokens_local"]) if layout == "expert_tp" else cap
    if n > 1:
        for g in (1, 2, 4, 8):
            if unit % g:
                continue
            cands.append(Candidate(
                knob={"mode": "stream", "chunks": g,
                      "capacity_factor": cf},
                comps=CommComponents(wire_s=wire, msgs=steps * (2 + g),
                                     hide_s=ffn_s),
                base_s=ffn_s))
    dense_bytes = int(m["tokens_local"]) * int(m["d_model"]) * op.dtype_bytes
    dense_wire = (cost_model.collective_wire_s("all_gather", dense_bytes,
                                               n, hw)
                  + cost_model.collective_wire_s("reduce_scatter",
                                                 n * dense_bytes, n, hw))
    cands.append(Candidate(
        knob={"mode": "dense", "chunks": 1, "capacity_factor": cf},
        comps=CommComponents(wire_s=dense_wire, msgs=2, hide_s=0.0),
        base_s=dense_ffn))
    return cands


def _pipeline_candidates(op: CommOp, hw) -> list[Candidate]:
    m = op.meta
    s = max(1, op.axis_size)
    batch_fwd_s = float(m.get("batch_fwd_s", 0.0))
    batch_bytes = float(m.get("batch_bytes", op.nbytes))
    n_layers = m.get("n_layers")
    budget = max(0.0, min(1.0, float(m.get("overlap_budget", 1.0))))
    micros = tuple(m.get("candidate_micro", (4, 8, 16, 32)))
    virtuals = tuple(m.get("candidate_virtual", (2,)))
    cands = []
    for mm in sorted({int(c) for c in micros if c >= 1}):
        variants = [("gpipe", mm, 1), ("1f1b", mm, 1)]
        for v in sorted({int(c) for c in virtuals if c >= 2}):
            if mm % s:
                continue
            if n_layers is not None and v * s > int(n_layers):
                continue
            variants.append(("interleaved", mm, v))
        for sched, mmm, v in variants:
            link = 2.0 * (batch_bytes / mmm) / hw.link_bw
            # recover the (wire, hide, compute) decomposition from the
            # same closed form the local decision uses: with budget=0 the
            # whole link is exposed, so compute falls out of t0
            t0, ticks = cost_model.pipeline_schedule_time(
                sched, mmm, s, v, batch_fwd_s, batch_bytes, hw=hw,
                overlap_budget=0.0)
            compute = t0 - ticks * (2.0 * hw.alpha_s + link)
            exp_tick = max(0.0, link - budget * compute / ticks)
            wire = ticks * link
            hide = wire - ticks * exp_tick
            stash = int(cost_model.pipeline_stash_slots(sched, mmm, s, v)
                        * batch_bytes / mmm)
            cands.append(Candidate(
                knob={"mode": sched, "chunks": mmm, "virtual": v},
                comps=CommComponents(wire_s=wire, msgs=2 * ticks,
                                     hide_s=max(0.0, hide),
                                     stash_bytes=stash),
                base_s=max(0.0, compute)))
    return cands


def _pinned_candidate(op: CommOp, hw) -> list[Candidate]:
    """Serve / preempt / ckpt knobs don't contend for step-time links;
    the joint pass carries the LOCAL decision through unchanged so the
    ProgramPlan still binds and trails every declared knob."""
    m = op.meta
    if op.kind == "serve":
        d = cost_model.decide_serve_schedule(
            m["n_params"], m["batch_slots"], m["mean_prompt"],
            m["mean_new"], max_prompt=m.get("max_prompt"),
            dtype_bytes=op.dtype_bytes, hw=hw)
        knob = {"mode": d.mode, "chunks": d.chunk}
    elif op.kind == "preempt":
        d = cost_model.decide_preempt(
            m.get("mean_pages", 1), m["page_bytes"], m["replay_tokens"],
            m["n_params"], batch_slots=m.get("batch_slots", 1),
            dtype_bytes=op.dtype_bytes, hw=hw)
        knob = {"mode": d.policy, "chunks": 1}
    else:                           # ckpt
        d = cost_model.decide_checkpoint(
            m.get("step_s", 1.0), m["snapshot_bytes"],
            mtbf_s=m.get("mtbf_s", 1800.0),
            write_bw=m.get("write_bw"), hw=hw)
        knob = {"mode": d.mode, "chunks": d.interval}
    return [Candidate(knob=knob, comps=CommComponents(0.0, 0, 0.0, 0))]


def candidates_for(op: CommOp, hw=None) -> list[Candidate]:
    """The op's knob space, priced — each subsystem's existing candidate
    list expressed in shared-constraint components."""
    hw = hw or managed.get_config().hw
    if op.axis_size <= 1 and op.kind not in ("serve", "preempt", "ckpt",
                                             "pipeline"):
        return _trivial()
    if op.kind == "halo":
        return _halo_candidates(op, hw)
    if op.kind == "attention":
        return _attention_candidates(op, hw)
    if op.kind == "moe":
        return _moe_candidates(op, hw)
    if op.kind == "pipeline":
        return _pipeline_candidates(op, hw)
    if op.kind in ("serve", "preempt", "ckpt"):
        return _pinned_candidate(op, hw)
    return _collective_candidates(op, hw)


# ---------------------------------------------------------------------------
# Joint pricing under shared constraints
# ---------------------------------------------------------------------------


def contention_sets(ops: Sequence[CommOp]) -> list[list[int]]:
    """Connected components of (same axis AND overlapping windows) —
    the groups whose wires serialise on one link."""
    n = len(ops)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if ops[i].overlaps(ops[j]):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    groups: dict[int, list[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return [sorted(g) for g in sorted(groups.values())]


def joint_cost(ops: Sequence[CommOp], chosen: Sequence[Candidate], *,
               hw=None, stash_cap_bytes: int | None = None,
               sets: Sequence[Sequence[int]] | None = None) -> float:
    """Modeled step seconds of one joint knob assignment.

    Per contention set: ONE OverlapAccount seeded with the largest hide
    any member offers (the adjacent compute hides the link once), every
    member's wire drawn from it, alpha per message on top.  Stash bytes
    pool across the WHOLE program against the cap."""
    hw = hw or managed.get_config().hw
    if sets is None:
        sets = contention_sets(ops)
    if stash_cap_bytes is not None:
        pooled = sum(c.comps.stash_bytes for c in chosen)
        if pooled > stash_cap_bytes:
            return math.inf
    total = sum(c.base_s for c in chosen)
    for group in sets:
        acct = OverlapAccount(
            budget_s=max((chosen[i].comps.hide_s for i in group),
                         default=0.0))
        exposed = 0.0
        msgs = 0
        for i in group:
            exposed += acct.draw(chosen[i].comps.wire_s)
            msgs += chosen[i].comps.msgs
        total += exposed + hw.alpha_s * msgs
    return total


# ---------------------------------------------------------------------------
# The plan object + the search
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpChoice:
    """Per-op row of the coordinated plan's decision trail."""
    op: CommOp
    knob: dict
    local_knob: dict
    local_solo_s: float             # local pick, priced standalone
    chosen_solo_s: float            # planner pick, priced standalone


@dataclasses.dataclass
class ProgramPlan:
    """One coordinated knob assignment for the whole program.

    ``knob_for(op_name, axis)`` is the contract ``managed._plan_knob``
    duck-types against: a dict with at least {"mode", "chunks"} when the
    plan binds that call site, None otherwise."""
    signature: str
    topology: str
    knobs: dict[str, dict]          # "op_name|axis" -> knob dict
    choices: list[OpChoice]
    joint_cost_s: float             # coordinated, shared constraints
    local_joint_cost_s: float       # local picks under shared constraints
    local_solo_sum_s: float         # concatenation of local plans (no sharing)
    notes: list[str] = dataclasses.field(default_factory=list)

    def knob_for(self, op_name: str, axis: str) -> dict | None:
        return self.knobs.get(f"{op_name}|{axis}")

    @property
    def coordinated(self) -> bool:
        return any(c.knob != c.local_knob for c in self.choices)

    def summary(self) -> str:
        lines = [
            f"program_plan[{self.topology}] {len(self.choices)} ops: "
            f"joint={self.joint_cost_s * 1e6:.1f}us "
            f"local-joint={self.local_joint_cost_s * 1e6:.1f}us "
            f"local-concat={self.local_solo_sum_s * 1e6:.1f}us "
            f"({'coordinated' if self.coordinated else 'local picks stand'})"
        ]
        for c in self.choices:
            moved = "" if c.knob == c.local_knob else "   <- coordinated"
            lines.append(
                f"  {c.op.op_name:20s} axis={c.op.axis:6s} "
                f"{c.op.label:24s} "
                f"local={c.local_knob.get('mode')}:"
                f"{c.local_knob.get('chunks')} -> "
                f"plan={c.knob.get('mode')}:{c.knob.get('chunks')}{moved}")
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "signature": self.signature,
            "topology": self.topology,
            "knobs": self.knobs,
            "joint_cost_s": self.joint_cost_s,
            "local_joint_cost_s": self.local_joint_cost_s,
            "local_solo_sum_s": self.local_solo_sum_s,
            "notes": list(self.notes),
            "ops": [c.op.to_dict() for c in self.choices],
            "choices": [{"knob": c.knob, "local_knob": c.local_knob,
                         "local_solo_s": c.local_solo_s,
                         "chosen_solo_s": c.chosen_solo_s}
                        for c in self.choices],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ProgramPlan":
        ops = [CommOp.from_dict(o) for o in d.get("ops", [])]
        choices = [OpChoice(op=op, knob=ch["knob"],
                            local_knob=ch["local_knob"],
                            local_solo_s=ch["local_solo_s"],
                            chosen_solo_s=ch["chosen_solo_s"])
                   for op, ch in zip(ops, d.get("choices", []))]
        return cls(signature=d["signature"], topology=d["topology"],
                   knobs=dict(d["knobs"]),
                   choices=choices,
                   joint_cost_s=float(d["joint_cost_s"]),
                   local_joint_cost_s=float(d["local_joint_cost_s"]),
                   local_solo_sum_s=float(d["local_solo_sum_s"]),
                   notes=list(d.get("notes", [])))


def program_signature(ops: Sequence[CommOp]) -> str:
    return ";".join(sorted(f"{o.op_name}|{o.axis}|{o.nbytes}"
                           for o in ops))


def program_topology(ops: Sequence[CommOp]) -> str:
    axes = {}
    for o in ops:
        axes[o.axis] = max(axes.get(o.axis, 1), o.axis_size)
    return "x".join(f"{a}{n}" for a, n in sorted(axes.items())) or "scalar"


def plan_program(ops: Sequence[CommOp], *, hw=None,
                 stash_cap_bytes: int | None = None,
                 max_rounds: int = 8,
                 notes: Sequence[str] = (),
                 log: bool = True) -> ProgramPlan:
    """Search the product knob space and emit the coordinated plan.

    Coordinate descent seeded from each op's LOCAL pick: one op at a
    time, try its whole candidate list against the others' current
    knobs, keep strict improvements, iterate to a fixpoint.  The result
    can only match or beat the local assignment's joint cost."""
    cfg = managed.get_config()
    hw = hw or cfg.hw
    ops = list(ops)
    with get_tracer().span("plan.resolve", op="program_plan",
                           track="plan", n_ops=len(ops)):
        return _plan_program_body(ops, cfg, hw, stash_cap_bytes,
                                  max_rounds, notes, log)


def _plan_program_body(ops, cfg, hw, stash_cap_bytes, max_rounds, notes,
                       log) -> ProgramPlan:
    order = sorted(range(len(ops)), key=lambda i: ops[i].key)
    cand_lists = [candidates_for(op, hw) for op in ops]
    sets = contention_sets(ops)

    # seed: every op takes its locally-optimal knob (what per-subsystem
    # resolution would have done)
    local_idx = [min(range(len(cl)),
                     key=lambda j: (cl[j].solo_s(hw.alpha_s), j))
                 for cl in cand_lists]
    chosen_idx = list(local_idx)

    def cost_of(idxs):
        return joint_cost(ops, [cand_lists[i][idxs[i]]
                                for i in range(len(ops))],
                          hw=hw, stash_cap_bytes=stash_cap_bytes,
                          sets=sets)

    local_joint = cost_of(local_idx)
    best = local_joint
    for _ in range(max_rounds):
        improved = False
        for i in order:
            cur = chosen_idx[i]
            for j in range(len(cand_lists[i])):
                if j == cur:
                    continue
                chosen_idx[i] = j
                t = cost_of(chosen_idx)
                if t < best - _EPS:
                    best, cur = t, j
                    improved = True
                else:
                    chosen_idx[i] = cur
            chosen_idx[i] = cur
        if not improved:
            break

    alpha = hw.alpha_s
    choices = []
    for i, op in enumerate(ops):
        lc = cand_lists[i][local_idx[i]]
        cc = cand_lists[i][chosen_idx[i]]
        choices.append(OpChoice(op=op, knob=dict(cc.knob),
                                local_knob=dict(lc.knob),
                                local_solo_s=lc.solo_s(alpha),
                                chosen_solo_s=cc.solo_s(alpha)))
    local_solo_sum = sum(c.local_solo_s for c in choices)
    plan = ProgramPlan(
        signature=program_signature(ops),
        topology=program_topology(ops),
        knobs={f"{c.op.op_name}|{c.op.axis}": dict(c.knob)
               for c in choices},
        choices=choices, joint_cost_s=best,
        local_joint_cost_s=local_joint,
        local_solo_sum_s=local_solo_sum, notes=list(notes))

    if log and cfg.log_decisions:
        for c in choices:
            managed.log_decision(managed.DecisionRecord(
                op=c.op.op_name, axis=c.op.axis, nbytes=c.op.nbytes,
                mode=str(c.knob.get("mode")),
                chunks=int(c.knob.get("chunks") or 1),
                predicted_bulk_s=c.local_solo_s,
                predicted_interleaved_s=c.chosen_solo_s))
        managed.log_decision(managed.DecisionRecord(
            op="program_plan", axis=plan.topology,
            nbytes=sum(o.nbytes for o in ops),
            mode="coordinated" if plan.coordinated else "local",
            chunks=len(ops),
            predicted_bulk_s=local_solo_sum,
            predicted_interleaved_s=best))
    return plan
