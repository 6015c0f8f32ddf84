"""mdmplint — the static communication verifier (the sixth managed
subsystem, cross-cutting the other five; port of ``repro.analysis``).

MDMP's premise is that declared communications are a *specification*
the traced program and the installed plan must satisfy.  This package
lifts the three truth sources — CommRegion declarations
(core/region.py), recorded collectives (core/instrument.py ->
plan/ir.lower_collectives), and the installed ProgramPlan
(plan/planner.py) — into one checkable ``CommGraph`` (graph.py) and
runs a pass pipeline over it (passes.py):

  1. declared-vs-traced drift      MDMP101/102/103/104
  2. permute validity              MDMP201/202
  3. ordering / deadlock           MDMP301
  4. overlap races                 MDMP401/402
  5. plan feasibility              MDMP501/502/503/504
  0. declaration validity          MDMP001 (axes)

Entry points: ``python -m repro_torch.launch.lint`` (CLI), and
``preflight()`` — the ``--verify {off,warn,strict}`` hook both
launchers run before committing to a schedule.
"""

from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.analysis.diagnostics import CODES, Diagnostic, Site, make
from repro_torch.analysis.graph import (BufferAccess, CommGraph, InFlight,
                                        PermuteSite, WaitEdge, attach_trace,
                                        derive_permutes, from_corpus, from_ops,
                                        ring_perm)
from repro_torch.analysis.passes import (PASSES, check_axes, check_drift,
                                         check_feasibility, check_ordering,
                                         check_overlap, check_permutes,
                                         run_all)
from repro_torch.analysis.report import exit_code, render, summary


class LintError(SystemExit):
    """Raised by strict preflight on error diagnostics (exit status 1)."""

    def __init__(self, diags: Sequence[Diagnostic]):
        self.diags = list(diags)
        super().__init__(1)


def preflight(graph: CommGraph, mode: str = "warn", *,
              out: Callable[[str], None] = print) -> list[Diagnostic]:
    """Run the verifier as a launcher preflight.

    ``off``   — skip entirely (returns []).
    ``warn``  — print findings, log a DecisionRecord(op="lint") so
                suppressed warnings land in the decision trail, continue.
    ``strict``— print findings with the declared/traced side-by-side and
                fix hints; raise ``LintError`` (exit 1) on any error.
    """
    if mode == "off":
        return []
    from repro_torch.obs.tracer import get_tracer
    with get_tracer().span("lint.preflight", op="lint", track="lint",
                           graph=graph.name):
        diags = run_all(graph)
    errors = sum(1 for d in diags if d.severity == "error")
    if diags:
        out(render(diags, verbose=(mode == "strict")))
    out(summary(diags, graph.name))
    if mode == "warn":
        from repro_torch.core import managed
        managed.log_decision(managed.DecisionRecord(
            op="lint", axis=graph.name, nbytes=errors, mode=mode,
            chunks=len(diags), predicted_bulk_s=0.0,
            predicted_interleaved_s=0.0))
    if mode == "strict" and errors:
        raise LintError(diags)
    return diags


__all__ = [
    "CODES", "Diagnostic", "Site", "make",
    "BufferAccess", "CommGraph", "InFlight", "PermuteSite", "WaitEdge",
    "attach_trace", "derive_permutes", "from_corpus", "from_ops",
    "ring_perm",
    "PASSES", "check_axes", "check_drift", "check_feasibility",
    "check_ordering", "check_overlap", "check_permutes", "run_all",
    "exit_code", "render", "summary",
    "LintError", "preflight",
]
