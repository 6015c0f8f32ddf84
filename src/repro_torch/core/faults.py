"""Deterministic fault injection — the failure taxonomy as a declared plan
(port of ``repro.core.faults``).

A ``FaultPlan`` is a list of (kind, step) events parsed from a compact
spec string, each firing exactly once at its step.  The train loop threads
the plan through ``TrainLoop`` (via ``FaultPlan.train_hook``) and the
serving engine checks ``serve_quantum`` and ``serve_overload`` at every
quantum boundary, so the recovery paths — restore-and-retry, checkpoint
fallback, replica drain and re-admit — run under test.

Kinds the training loop fires:

  transient@k        one step-k exception (a flaky collective, a preempted
                     host); the loop restores the latest checkpoint
  rank_death@k       a rank dies at step k (``RankDeath``); the restart
                     path is the same restore (on a new mesh it replays
                     the tuner's winners, ``tuner.replan_for_mesh``)
  slow@k:sec         a straggler: step k stalls ``sec`` seconds (feeds the
                     EWMA straggler detector, raises nothing)
  corrupt@k[:bytes]  step k truncates the LATEST checkpoint's arrays.npz
                     to ``bytes`` (default 16) and then dies — recovery
                     must fall back to the previous step

Kinds the serving path fires:

  replica_death@q    the replica dies before quantum q (``ReplicaDeath``);
                     in-flight requests are drained and re-admitted
  burst@q:n          n synthetic requests arrive at quantum q
                     (deterministic prompts seeded from q)
  pool_squeeze@q:f   the usable KV page pool shrinks to fraction f at
                     quantum q (a co-tenant claiming device memory)

Spec grammar:  ``kind@step[:arg]`` joined by ``;`` or ``,`` — e.g.
``"burst@1:6;pool_squeeze@3:0.8"``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable


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

    # -- training ------------------------------------------------------------

    def train_hook(self, ckpt_dir: str | None = None,
                   settle: Callable[[], None] | None = None
                   ) -> Callable[[int], None]:
        """A ``TrainLoop.fault_hook``: raises / stalls / corrupts per the
        plan.  ``ckpt_dir`` is needed for ``corrupt`` events (they attack
        the latest on-disk checkpoint before dying); ``settle`` (the
        checkpoint manager's ``wait``) lets an asynchronous save in flight
        land first, so that the checkpoint attacked is the one the restore
        would otherwise take (the reference races its writer thread
        here)."""

        def hook(step: int) -> None:
            ev = self.fire("slow", step)
            if ev is not None:
                time.sleep(ev.arg)
            ev = self.fire("corrupt", step)
            if ev is not None:
                if ckpt_dir is None:
                    raise ValueError("corrupt@k fault needs the checkpoint "
                                     "dir")
                if settle is not None:
                    settle()
                corrupt_latest(ckpt_dir,
                               keep_bytes=int(ev.arg) if ev.arg else 16)
                raise RankDeath(f"injected rank death at step {step} "
                                "(latest checkpoint shard corrupted)")
            ev = self.fire("transient", step)
            if ev is not None:
                raise FaultError(f"injected transient fault at step {step}")
            ev = self.fire("rank_death", step)
            if ev is not None:
                raise RankDeath(f"injected rank death at step {step}")

        return hook

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


def corrupt_latest(ckpt_dir: str, *, keep_bytes: int = 16) -> str | None:
    """Truncate the latest checkpoint's ``arrays.npz`` to ``keep_bytes``
    (a torn write / lost object shard).  The manifest survives, so only a
    restore attempt discovers the damage — exercising the fallback-to-
    previous-step path, not just ``latest_step`` validation."""
    from repro_torch.checkpoint import ckpt as ckpt_lib
    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with open(path, "rb+") as f:
        f.truncate(keep_bytes)
    return path
