"""The mdmplint pass pipeline — five families over one CommGraph.

Each pass is a pure function ``CommGraph -> list[Diagnostic]``; the
pipeline (``run_all``) concatenates them errors-first.  The passes only
read the graph — building it (graph.py) is where the three truth
sources were reconciled into one shape, so every pass runs identically
on a launcher preflight and on a corpus JSON case.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.analysis.diagnostics import Diagnostic, make
from repro_torch.analysis.graph import CommGraph

#: declared kinds that name a collective family directly — only these
#: must match the traced primitive family (MDMP104); subsystem kinds
#: (halo/attention/pipeline/moe/serve/preempt/ckpt) lower to whatever
#: mix of primitives their chosen schedule emits.
_DIRECT_KINDS = frozenset({"send", "recv", "all_gather", "all_reduce",
                           "reduce_scatter", "all_to_all", "collective"})

#: traced-vs-declared bytes tolerance — matches ir.crosscheck_collectives
#: (schedules legitimately move up to ~4x the declared payload: ring
#: round-trips, grad + activation traffic on one axis).
_DRIFT_TOL = 4.0


def _op_ref(op) -> str:
    src = op.meta.get("source") or op.meta.get("site") or ""
    trips = op.meta.get("trips", 1)
    t = f" x{trips}" if trips and trips != 1 else ""
    at = f" @ {src}" if src else ""
    return (f"{op.op_name} axis={op.axis} {op.nbytes}B{t} "
            f"kind={op.kind} label={op.label}{at}")


def _traced_bytes(op) -> int:
    return int(op.nbytes) * max(1, int(op.meta.get("trips", 1)))


# -- pass 0: declaration validity -----------------------------------------

def check_axes(g: CommGraph) -> list[Diagnostic]:
    """MDMP001 — every axis referenced must be a mesh axis the graph
    knows; an unknown axis prices as size-1 and is never scheduled."""
    out = []
    known = sorted(g.axis_sizes)
    for op in list(g.declared) + list(g.traced):
        if op.axis not in g.axis_sizes:
            out.append(make(
                "MDMP001",
                f"{op.label!r} names axis {op.axis!r}, not one of "
                f"{known}",
                label=op.label, axis=op.axis,
                site=op.meta.get("site") or op.meta.get("source"),
                spec_ref=_op_ref(op),
                hint=f"declare on one of {known} or add the axis to the "
                     f"mesh"))
    for p in g.permutes:
        if p.axis not in g.axis_sizes:
            out.append(make(
                "MDMP001",
                f"permute {p.label!r} names axis {p.axis!r}, not one of "
                f"{known}",
                label=p.label, axis=p.axis, site=p.site,
                hint=f"permute over one of {known}"))
    return out


# -- pass 1: declared-vs-traced drift -------------------------------------

def check_drift(g: CommGraph) -> list[Diagnostic]:
    """MDMP101/102/103/104 — the declarations are a specification the
    traced program can silently violate; reconcile them per axis."""
    out = []
    if not g.traced:
        return out                    # nothing traced — nothing to drift
    decl_by_axis: dict[str, int] = {}
    for op in g.declared:
        decl_by_axis[op.axis] = decl_by_axis.get(op.axis, 0) + op.nbytes
    traced_by_axis: dict[str, int] = {}
    for op in g.traced:
        traced_by_axis[op.axis] = (traced_by_axis.get(op.axis, 0)
                                   + _traced_bytes(op))
    for axis in sorted(traced_by_axis):
        tb, db = traced_by_axis[axis], decl_by_axis.get(axis, 0)
        ops = [op for op in g.traced if op.axis == axis]
        if db == 0:
            out.append(make(
                "MDMP101",
                f"{tb}B traced on axis {axis!r} but nothing declared",
                axis=axis, label=ops[0].label,
                site=ops[0].meta.get("source"),
                op_ref="; ".join(_op_ref(o) for o in ops[:3]),
                hint="declare the collective on the owning CommRegion "
                     "(region.collective/attention/moe/... on this axis)"))
        elif tb > _DRIFT_TOL * db:
            out.append(make(
                "MDMP102",
                f"axis {axis!r} moves {tb}B traced vs {db}B declared "
                f"(> {_DRIFT_TOL:.0f}x tolerance)",
                axis=axis, label=ops[0].label,
                site=ops[0].meta.get("source"),
                spec_ref="; ".join(_op_ref(o) for o in g.declared
                                   if o.axis == axis)[:200],
                op_ref="; ".join(_op_ref(o) for o in ops[:3]),
                hint="update the declaration's shape/dtype to what the "
                     "program actually sends"))
    for axis in sorted(decl_by_axis):
        if decl_by_axis[axis] > 0 and axis not in traced_by_axis:
            specs = [op for op in g.declared if op.axis == axis]
            out.append(make(
                "MDMP103",
                f"{decl_by_axis[axis]}B declared on axis {axis!r}, "
                f"none traced (stale declaration)",
                axis=axis, label=specs[0].label,
                site=specs[0].meta.get("site"),
                spec_ref="; ".join(_op_ref(o) for o in specs[:3]),
                hint="drop the declaration or trace the region that "
                     "exercises it"))
    # family mismatch: a DIRECT collective declaration on an axis whose
    # trace carries traffic, but none of the declared family
    for op in g.declared:
        if op.kind not in _DIRECT_KINDS or op.axis not in traced_by_axis:
            continue
        fams = {t.op_name for t in g.traced if t.axis == op.axis}
        if op.op_name not in fams:
            out.append(make(
                "MDMP104",
                f"{op.label!r} declares {op.op_name} on axis "
                f"{op.axis!r} but the trace only carries "
                f"{sorted(fams)}",
                axis=op.axis, label=op.label,
                site=op.meta.get("site"), spec_ref=_op_ref(op),
                op_ref="; ".join(_op_ref(t) for t in g.traced
                                 if t.axis == op.axis)[:200],
                hint="declare the family the program emits (kind/"
                     "collective argument)"))
    return out


# -- pass 2: permute validity ---------------------------------------------

def check_permutes(g: CommGraph) -> list[Diagnostic]:
    """MDMP201/202 — every constructed permutation must be a bijection
    on its support; ring permutes must return home after axis_size
    applications; paired stream shifts must compose to the identity."""
    out = []
    for p in g.permutes:
        n = int(p.axis_size)
        srcs = [a for a, _ in p.perm]
        dsts = [b for _, b in p.perm]
        bad = (len(set(srcs)) != len(srcs)
               or len(set(dsts)) != len(dsts)
               or any(not (0 <= v < n) for v in srcs + dsts))
        if not bad and p.ring and len(p.perm) != n:
            bad = True                # a ring must cover the whole axis
        if bad:
            out.append(make(
                "MDMP201",
                f"permute {p.label!r} on axis {p.axis!r} (n={n}) is not "
                f"a bijection: perm={list(p.perm)}",
                label=p.label, axis=p.axis, site=p.site,
                op_ref=f"perm={list(p.perm)}",
                hint="each rank must appear exactly once as source and "
                     "once as destination (in range 0..n-1)"))
            continue
        if p.ring:
            # a ring must be ONE n-cycle: starting anywhere, the data
            # visits every rank and is first home after exactly n hops —
            # shorter sub-cycles (e.g. pair swaps) satisfy f^n == id but
            # never deliver to the ranks outside their orbit
            f = {a: b for a, b in p.perm}
            if _orbit_len(f, 0, n) != n:
                out.append(make(
                    "MDMP202",
                    f"ring permute {p.label!r} on axis {p.axis!r} does "
                    f"not complete a full cycle: orbit of rank 0 has "
                    f"length {_orbit_len(f, 0, n)}, not {n}",
                    label=p.label, axis=p.axis, site=p.site,
                    op_ref=f"perm={list(p.perm)}",
                    hint="a composed ring must be a single n-cycle "
                         "(use one uniform shift coprime to n)"))
        if p.pair is not None:
            fwd, ret = p.pair
            if (fwd + ret) % n != 0:
                out.append(make(
                    "MDMP202",
                    f"stream permute {p.label!r}: forward shift {fwd} "
                    f"and return shift {ret} do not compose to the "
                    f"identity on axis {p.axis!r} (n={n})",
                    label=p.label, axis=p.axis, site=p.site,
                    op_ref=f"fwd_shift={fwd} ret_shift={ret}",
                    hint="the return permute must invert the forward "
                         "one: ret_shift == -fwd_shift (mod n)"))
    return out


def _orbit_len(f: dict, start: int, n: int) -> int:
    i, steps = f[start], 1
    while i != start and steps <= n:
        i, steps = f[i], steps + 1
    return steps


# -- pass 3: ordering / deadlock ------------------------------------------

def check_ordering(g: CommGraph) -> list[Diagnostic]:
    """MDMP301 — happens-before graph: explicit wait edges plus the
    wire-serialization order inside each contention set (same axis,
    overlapping readiness windows, earlier window transmits first).  A
    cycle is a deadlock: two regions each waiting on the other's
    serialized wire."""
    edges: dict[str, set[str]] = {}
    why: dict[tuple[str, str], str] = {}

    def add(a: str, b: str, reason: str) -> None:
        if a == b:
            return
        edges.setdefault(a, set()).add(b)
        why.setdefault((a, b), reason)

    for w in g.waits:
        add(w.src, w.dst, w.reason or "declared wait")
    ops = list(g.declared)
    for i, a in enumerate(ops):
        for b in ops[i + 1:]:
            if not a.overlaps(b):
                continue
            if a.window[0] < b.window[0]:
                add(a.label, b.label,
                    f"serialized wire on axis {a.axis!r}")
            elif b.window[0] < a.window[0]:
                add(b.label, a.label,
                    f"serialized wire on axis {a.axis!r}")
    cycle = _find_cycle(edges)
    if cycle is None:
        return []
    path = " -> ".join(cycle)
    reasons = "; ".join(
        f"{a}->{b}: {why.get((a, b), '?')}"
        for a, b in zip(cycle, cycle[1:]))
    return [make(
        "MDMP301",
        f"wait-for cycle {path}",
        label=cycle[0], op_ref=reasons,
        hint="break the cycle: reorder the windows so the serialized "
             "wire and the declared waits agree on one direction")]


def _find_cycle(edges: dict[str, set]) -> list | None:
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    stack: list[str] = []

    def dfs(u: str):
        color[u] = GREY
        stack.append(u)
        for v in sorted(edges.get(u, ())):
            c = color.get(v, WHITE)
            if c == GREY:
                i = stack.index(v)
                return stack[i:] + [v]
            if c == WHITE:
                got = dfs(v)
                if got:
                    return got
        stack.pop()
        color[u] = BLACK
        return None

    for node in sorted(edges):
        if color.get(node, WHITE) == WHITE:
            got = dfs(node)
            if got:
                return got
    return None


# -- pass 4: overlap races -------------------------------------------------

def check_overlap(g: CommGraph) -> list[Diagnostic]:
    """MDMP401/402 — a buffer marked in flight over (t0, t1) must not be
    touched by compute inside that window (the stale-ghost-read class),
    and two in-flight claims on one buffer must not overlap (donation /
    aliasing hazards)."""
    out = []
    for f in g.inflight:
        for a in g.accesses:
            if a.buffer != f.buffer:
                continue
            if f.t0 < a.time < f.t1:
                code = "MDMP401" if a.access == "read" else "MDMP402"
                what = ("reads stale" if a.access == "read"
                        else "writes into")
                out.append(make(
                    code,
                    f"{a.label or 'compute'} {what} buffer "
                    f"{f.buffer!r} at t={a.time:.2f} while "
                    f"{f.label or 'a transfer'} holds it in flight "
                    f"over ({f.t0:.2f}, {f.t1:.2f})",
                    label=a.label or f.label,
                    op_ref=f"in-flight ({f.t0:.2f}, {f.t1:.2f}) by "
                           f"{f.label or '?'}",
                    hint="move the access outside the readiness window "
                         "or double-buffer the operand"))
    flights = sorted(g.inflight, key=lambda f: (f.buffer, f.t0))
    for i, f in enumerate(flights):
        for h in flights[i + 1:]:
            if h.buffer != f.buffer:
                break
            if h.t0 < f.t1 and f.t0 < h.t1:
                out.append(make(
                    "MDMP402",
                    f"buffer {f.buffer!r} claimed in flight twice: "
                    f"{f.label or '?'} ({f.t0:.2f}, {f.t1:.2f}) and "
                    f"{h.label or '?'} ({h.t0:.2f}, {h.t1:.2f})",
                    label=f.label or h.label,
                    op_ref=f"{f.label}: ({f.t0:.2f},{f.t1:.2f}); "
                           f"{h.label}: ({h.t0:.2f},{h.t1:.2f})",
                    hint="donated/aliased operands need disjoint "
                         "in-flight windows — stage through a copy"))
    return out


# -- pass 5: plan feasibility ----------------------------------------------

def check_feasibility(g: CommGraph) -> list[Diagnostic]:
    """MDMP501/502/503/504 — forced knobs the executor would silently
    degrade (clamped stream chunks, indivisible microbatches, stash over
    capacity, halo k past the block) become hard lint errors."""
    from repro_torch.core import cost_model
    out = []
    for op in g.declared:
        knob = g.knob(op)
        if knob is None:
            continue
        m = op.meta
        if op.kind == "moe" and knob.get("mode") == "stream":
            gch = int(knob.get("chunks", 1))
            cap = cost_model.moe_capacity(
                int(m.get("tokens_local", 0)), int(m.get("top_k", 1)),
                int(m.get("n_experts", 1)),
                float(m.get("capacity_factor", 1.25)))
            if gch < 1 or cap % gch != 0:
                out.append(make(
                    "MDMP501",
                    f"{op.label!r}: stream chunks g={gch} does not "
                    f"divide the per-expert capacity C={cap} — the "
                    f"executor would silently clamp to g=1 (bulk)",
                    label=op.label, axis=op.axis,
                    site=m.get("site"), spec_ref=_op_ref(op),
                    op_ref=f"knob={knob}",
                    hint=f"pick g from the divisors of {cap} (or adjust "
                         f"capacity_factor so C is divisible)"))
        elif op.kind == "pipeline":
            mm = int(knob.get("chunks", 1))
            sched = knob.get("mode", "gpipe")
            v = int(knob.get("virtual", 1))
            s = int(g.axis_sizes.get(op.axis, op.axis_size))
            lb = int(m.get("local_batch", 0))
            if lb and mm >= 1 and lb % mm != 0:
                out.append(make(
                    "MDMP502",
                    f"{op.label!r}: microbatches M={mm} does not "
                    f"divide the local batch {lb}",
                    label=op.label, axis=op.axis, site=m.get("site"),
                    spec_ref=_op_ref(op), op_ref=f"knob={knob}",
                    hint=f"pick M from the divisors of {lb}"))
            if sched == "interleaved" and (v < 2 or mm % max(1, s)):
                out.append(make(
                    "MDMP502",
                    f"{op.label!r}: interleaved needs virtual >= 2 and "
                    f"M % S == 0 (got M={mm}, S={s}, v={v}) — "
                    f"build_schedule would raise at launch",
                    label=op.label, axis=op.axis, site=m.get("site"),
                    spec_ref=_op_ref(op), op_ref=f"knob={knob}",
                    hint="choose M a multiple of the stage count"))
            n_layers = int(m.get("n_layers", 0))
            if sched == "interleaved" and n_layers and v * s > n_layers:
                out.append(make(
                    "MDMP502",
                    f"{op.label!r}: v*S = {v * s} virtual stages exceed "
                    f"{n_layers} layers",
                    label=op.label, axis=op.axis, site=m.get("site"),
                    spec_ref=_op_ref(op), op_ref=f"knob={knob}",
                    hint="lower the virtual factor"))
            bb = int(m.get("batch_bytes", 0))
            cap = g.stash_cap_bytes or int(getattr(g.hw, "hbm_bytes", 0)
                                           or 0)
            if bb and mm >= 1 and cap:
                slots = cost_model.pipeline_stash_slots(
                    sched, mm, max(1, s), v)
                stash = slots * (bb // max(1, mm))
                if stash > cap:
                    out.append(make(
                        "MDMP503",
                        f"{op.label!r}: {sched} stash {slots} slots x "
                        f"{bb // max(1, mm)}B = {stash}B exceeds the "
                        f"{cap}B cap — the runtime would spill or OOM",
                        label=op.label, axis=op.axis, site=m.get("site"),
                        spec_ref=_op_ref(op),
                        op_ref=f"knob={knob} stash={stash}B cap={cap}B",
                        hint="raise M (smaller microbatches), switch to "
                             "1f1b (stash capped at 2S), or shrink the "
                             "boundary activation"))
        elif op.kind == "halo" and knob.get("mode") == "aggregated":
            k = int(knob.get("chunks", 1))
            rows = int(m.get("rows_local", 0))
            if rows and k > rows:
                out.append(make(
                    "MDMP504",
                    f"{op.label!r}: aggregation k={k} exceeds the "
                    f"{rows}-row local block",
                    label=op.label, axis=op.axis, site=m.get("site"),
                    spec_ref=_op_ref(op), op_ref=f"knob={knob}",
                    hint=f"clamp k to <= {rows}"))
    return out


PASSES = (check_axes, check_drift, check_permutes, check_ordering,
          check_overlap, check_feasibility)


def run_all(g: CommGraph,
            passes: Sequence = PASSES) -> list[Diagnostic]:
    """Run the pipeline; errors first, then warnings, stable within."""
    diags: list[Diagnostic] = []
    for p in passes:
        diags.extend(p(g))
    return sorted(diags, key=lambda d: (d.severity != "error", d.code))
