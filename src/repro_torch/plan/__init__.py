"""Whole-program communication planner — the MDMP compiler (port of
``repro.plan``).

The per-subsystem managed runtime (core/managed.py) resolves every
communication knob LOCALLY: each call site assumes the link and the
overlap budget are its own.  This package closes the gap to the paper's
compiler view: every ``CommRegion`` declaration and every collective the
instrumentation records lowers to a ``CommOp`` node (ir.py), and a
joint pass (planner.py) prices the whole program's schedule under SHARED
constraints — per-link bandwidth serialised across ops whose readiness
windows overlap on the same mesh axis, stash capacity pooled, one overlap
account per contention set — and emits a single coordinated
``ProgramPlan`` whose knobs override local resolution via
``managed.install_plan``.
"""

from repro_torch.plan.ir import (CommOp, crosscheck_collectives,
                                 lower_collectives, lower_region, lower_specs,
                                 lower_train_ops, train_geometry)
from repro_torch.plan.planner import (Candidate, OpChoice, ProgramPlan,
                                      candidates_for, plan_program)

__all__ = [
    "CommOp", "lower_specs", "lower_region", "lower_collectives",
    "lower_train_ops", "train_geometry", "crosscheck_collectives",
    "Candidate", "OpChoice", "ProgramPlan", "candidates_for",
    "plan_program",
]
