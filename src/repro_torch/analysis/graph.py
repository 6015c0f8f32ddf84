"""The checkable comm-graph — mdmplint's one program representation.

``CommGraph`` lifts the repo's three truth sources into a single object
the pass pipeline (passes.py) runs over:

  1. *declared* — CommRegion declarations lowered to CommOps
     (``plan/ir.lower_specs`` / ``lower_region``), with declaration-site
     provenance in ``meta["site"]``;
  2. *traced* — the collectives the instrumentation recorded
     (``instrument.analyze_region`` -> ``lower_collectives``), with trip
     counts and call-site provenance in ``meta["trips"]`` /
     ``meta["source"]``;
  3. *plan* — the installed ``ProgramPlan`` knobs (duck-typed
     ``knob_for(op_name, axis)``), so feasibility is checked against the
     knobs the executor will actually run.

Permute sites, wait edges, buffer accesses and in-flight claims are
derived from the declared ops + chosen knobs (``derive_permutes``) or
supplied directly (corpus JSON via ``from_corpus``) — the same graph
shape either way, so the lint corpus exercises exactly the production
passes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.plan.ir import CommOp


@dataclasses.dataclass(frozen=True)
class PermuteSite:
    """One ppermute call site with its constructed permutation."""
    label: str
    axis: str
    axis_size: int
    perm: tuple                  # ((src, dst), ...) — may be partial
    ring: bool = False           # composed ring: f^axis_size must be id
    pair: tuple | None = None    # (fwd_shift, ret_shift) for paired a2a
    site: Any = None


@dataclasses.dataclass(frozen=True)
class WaitEdge:
    """``dst`` waits for ``src`` (happens-before edge src -> dst)."""
    src: str
    dst: str
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class InFlight:
    """A buffer an OverlapAccount marks in flight over (t0, t1)."""
    buffer: str
    t0: float
    t1: float
    label: str = ""


@dataclasses.dataclass(frozen=True)
class BufferAccess:
    """A compute read/write of a named buffer at normalised step time."""
    buffer: str
    time: float
    access: str                  # "read" | "write"
    label: str = ""


class _KnobTable:
    """Duck-typed ProgramPlan stand-in for corpus-supplied knob dicts."""

    def __init__(self, knobs: dict[str, dict]):
        self.knobs = dict(knobs)

    def knob_for(self, op_name: str, axis: str):
        return self.knobs.get(f"{op_name}|{axis}")


@dataclasses.dataclass
class CommGraph:
    name: str
    axis_sizes: dict[str, int]
    declared: list = dataclasses.field(default_factory=list)
    traced: list = dataclasses.field(default_factory=list)
    plan: Any = None             # knob_for(op_name, axis) -> dict | None
    permutes: list = dataclasses.field(default_factory=list)
    waits: list = dataclasses.field(default_factory=list)
    inflight: list = dataclasses.field(default_factory=list)
    accesses: list = dataclasses.field(default_factory=list)
    stash_cap_bytes: int | None = None
    hw: Any = None

    def knob(self, op: CommOp) -> dict | None:
        if self.plan is None:
            return None
        return self.plan.knob_for(op.op_name, op.axis)


def ring_perm(n: int, shift: int = 1) -> tuple:
    """The repo's canonical ring permutation (managed._ring_perm)."""
    return tuple((i, (i + shift) % n) for i in range(n))


def derive_permutes(ops: Sequence[CommOp], axis_sizes: dict[str, int],
                    plan: Any = None) -> list[PermuteSite]:
    """Reconstruct every permutation the executors would build for the
    declared ops under the chosen plan knobs — ring attention KV and
    dk/dv rings, pipeline fwd/bwd tick handoffs, MoE stream chunk
    round-trips.  This is the analyzer's pass-2 input when the program
    comes from declarations rather than a corpus file."""
    sites: list[PermuteSite] = []
    for op in ops:
        n = int(axis_sizes.get(op.axis, op.axis_size) or op.axis_size)
        if n <= 1:
            continue
        knob = plan.knob_for(op.op_name, op.axis) if plan is not None \
            else None
        mode = (knob or {}).get("mode")
        site = op.meta.get("site")
        if op.kind == "attention" and mode in (None, "ring"):
            # ring attention streams KV (fwd) and dk/dv (bwd) around the
            # axis one shift-1 hop per step, n steps = home again
            sites.append(PermuteSite(
                label=f"{op.label}.kv_ring", axis=op.axis, axis_size=n,
                perm=ring_perm(n), ring=True, site=site))
            sites.append(PermuteSite(
                label=f"{op.label}.dkv_ring", axis=op.axis, axis_size=n,
                perm=ring_perm(n), ring=True, site=site))
        elif op.kind == "pipeline":
            # pipeline ticks hand activations to stage+1 (fwd) and
            # gradients to stage-1 (bwd); interleaved chunk wraps ride
            # the same ring permutes
            sites.append(PermuteSite(
                label=f"{op.label}.fwd_tick", axis=op.axis, axis_size=n,
                perm=ring_perm(n, 1), ring=True, site=site))
            sites.append(PermuteSite(
                label=f"{op.label}.bwd_tick", axis=op.axis, axis_size=n,
                perm=ring_perm(n, -1), ring=True, site=site))
        elif op.kind == "moe" and mode == "stream":
            # expert stream step s issues shift s+1 forward and returns
            # results with shift -s — each forward/return pair must
            # compose to the identity
            for s in range(1, n):
                sites.append(PermuteSite(
                    label=f"{op.label}.stream{s}", axis=op.axis,
                    axis_size=n, perm=ring_perm(n, s), ring=False,
                    pair=(s, -s), site=site))
    return sites


def from_ops(name: str, *, axis_sizes: dict[str, int],
             declared: Sequence[CommOp] = (),
             traced: Sequence[CommOp] = (),
             plan: Any = None, hw: Any = None,
             stash_cap_bytes: int | None = None,
             derive: bool = True) -> CommGraph:
    """Build the graph from lowered CommOps — the launcher-preflight
    path.  ``derive=True`` reconstructs the permute sites from the
    declarations + knobs."""
    if hw is None:
        from repro_torch.core import managed
        hw = managed.get_config().hw
    g = CommGraph(name=name, axis_sizes=dict(axis_sizes),
                  declared=list(declared), traced=list(traced),
                  plan=plan, stash_cap_bytes=stash_cap_bytes, hw=hw)
    if derive:
        g.permutes = derive_permutes(g.declared, g.axis_sizes, plan)
    return g


def attach_trace(graph: CommGraph, spans: Sequence[Any], *,
                 replace: bool = True) -> CommGraph:
    """Swap the graph's *declared* overlap story for the *measured* one.

    Declared ``inflight``/``accesses`` rows encode when the program
    claims transfers hold buffers and compute touches them.  A runtime
    trace knows when they actually did: every span carrying a
    ``buffer=`` attr is a real in-flight window, and ``reads=``/
    ``writes=`` attrs are real compute touches (pinned at the span
    midpoint).  This rebuilds pass 4's inputs from those spans, so
    MDMP401/402 fire on races that happened rather than races that were
    declared — the trace feedback edge into the static verifier.

    ``replace=False`` appends instead, checking measured windows
    against the declared access story (and vice versa).
    """
    from repro_torch.obs.export import measured_windows
    windows, touches = measured_windows(spans)
    inflight = [] if replace else list(graph.inflight)
    accesses = [] if replace else list(graph.accesses)
    inflight += [InFlight(buffer=b, t0=t0, t1=t1, label=label)
                 for (b, t0, t1, label) in windows]
    accesses += [BufferAccess(buffer=b, time=t, access=acc, label=label)
                 for (b, t, acc, label) in touches]
    return dataclasses.replace(graph, inflight=inflight, accesses=accesses)


def from_corpus(case: dict, hw: Any = None) -> CommGraph:
    """Build the graph from a lint-corpus JSON case (tests/lint_corpus).

    Schema::

        {"name": ..., "axis_sizes": {...}, "stash_cap_bytes": ...,
         "declared": [CommOp dicts], "traced": [CommOp dicts],
         "permutes": [{label, axis, axis_size, perm, ring, pair?}],
         "waits": [{src, dst, reason?}],
         "inflight": [{buffer, t0, t1, label?}],
         "accesses": [{buffer, time, access, label?}],
         "knobs": {"op_name|axis": {mode, chunks, ...}}}
    """
    if hw is None:
        from repro_torch.core import managed
        hw = managed.get_config().hw
    axis_sizes = dict(case.get("axis_sizes", {}))
    declared = [CommOp.from_dict(d) for d in case.get("declared", ())]
    traced = [CommOp.from_dict(d) for d in case.get("traced", ())]
    plan = _KnobTable(case.get("knobs", {})) if case.get("knobs") else None
    g = CommGraph(
        name=case.get("name", "corpus"), axis_sizes=axis_sizes,
        declared=declared, traced=traced, plan=plan,
        stash_cap_bytes=case.get("stash_cap_bytes"), hw=hw)
    g.permutes = [PermuteSite(
        label=p["label"], axis=p["axis"],
        axis_size=int(p.get("axis_size",
                            axis_sizes.get(p["axis"], 1))),
        perm=tuple((int(a), int(b)) for a, b in p.get("perm", ())),
        ring=bool(p.get("ring", False)),
        pair=tuple(p["pair"]) if p.get("pair") else None,
        site=p.get("site")) for p in case.get("permutes", ())]
    if case.get("derive_permutes"):
        g.permutes += derive_permutes(declared, axis_sizes, plan)
    g.waits = [WaitEdge(w["src"], w["dst"], w.get("reason", ""))
               for w in case.get("waits", ())]
    g.inflight = [InFlight(f["buffer"], float(f["t0"]), float(f["t1"]),
                           f.get("label", ""))
                  for f in case.get("inflight", ())]
    g.accesses = [BufferAccess(a["buffer"], float(a["time"]),
                               a["access"], a.get("label", ""))
                  for a in case.get("accesses", ())]
    return g
