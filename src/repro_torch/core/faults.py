"""Deterministic fault injection — the failure taxonomy as a declared plan
(port of ``repro.core.faults``; the training hook and the checkpoint
corruption come with the fault-tolerance slice).

A ``FaultPlan`` is a list of (kind, step) events parsed from a compact
spec string, each firing exactly once at its step.  The serving engine
checks ``serve_quantum`` and ``serve_overload`` at every quantum boundary.

Kinds the serving path fires:

  replica_death@q    the replica dies before quantum q (``ReplicaDeath``);
                     in-flight requests are drained and re-admitted
  burst@q:n          n synthetic requests arrive at quantum q
                     (deterministic prompts seeded from q)
  pool_squeeze@q:f   the usable KV page pool shrinks to fraction f at
                     quantum q (a co-tenant claiming device memory)

The training kinds (transient, rank_death, slow, corrupt) parse but are
fired only by the training loop.

Spec grammar:  ``kind@step[:arg]`` joined by ``;`` or ``,`` — e.g.
``"burst@1:6;pool_squeeze@3:0.8"``.
"""

from __future__ import annotations

import dataclasses


class FaultError(RuntimeError):
    """Base class of every injected failure."""


class RankDeath(FaultError):
    """A training rank died (node loss); restart from checkpoint."""


class ReplicaDeath(FaultError):
    """A serving replica died; drain + re-admit its in-flight requests."""


KINDS = ("transient", "rank_death", "slow", "corrupt", "replica_death",
         "burst", "pool_squeeze")


@dataclasses.dataclass
class FaultEvent:
    kind: str
    step: int
    arg: float = 0.0
    fired: bool = False


@dataclasses.dataclass
class FaultPlan:
    events: list[FaultEvent] = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        events = []
        for tok in spec.replace(",", ";").split(";"):
            tok = tok.strip()
            if not tok:
                continue
            kind, _, rest = tok.partition("@")
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r} (in {spec!r})")
            step_s, _, arg_s = rest.partition(":")
            events.append(FaultEvent(kind=kind, step=int(step_s),
                                     arg=float(arg_s) if arg_s else 0.0))
        return FaultPlan(events=sorted(events, key=lambda e: e.step))

    # -- firing (each event exactly once) ------------------------------------

    def fire(self, kind: str, step: int) -> FaultEvent | None:
        for ev in self.events:
            if ev.kind == kind and ev.step == step and not ev.fired:
                ev.fired = True
                return ev
        return None

    def unfired(self) -> list[FaultEvent]:
        return [ev for ev in self.events if not ev.fired]

    # -- serving -------------------------------------------------------------

    def serve_quantum(self, quantum_idx: int) -> None:
        """Called by the engine before dispatching quantum ``quantum_idx``;
        raises ``ReplicaDeath`` when the plan kills this replica here."""
        ev = self.fire("replica_death", quantum_idx)
        if ev is not None:
            raise ReplicaDeath(
                f"injected replica death before quantum {quantum_idx}")

    def serve_overload(self, quantum_idx: int) -> list[FaultEvent]:
        """Overload events due at this quantum boundary (each fired
        exactly once, in plan order): ``burst`` events the engine turns
        into synthetic submissions, ``pool_squeeze`` into a
        ``PageTable.squeeze``.  Raises nothing — overload degrades
        service, it doesn't kill the replica."""
        out = []
        for kind in ("burst", "pool_squeeze"):
            ev = self.fire(kind, quantum_idx)
            while ev is not None:
                out.append(ev)
                ev = self.fire(kind, quantum_idx)
        return out
