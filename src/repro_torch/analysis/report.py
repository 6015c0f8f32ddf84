"""Rendering for mdmplint diagnostics — one format for the CLI, the
launcher preflight, and the CI greps.

The non-verbose line format is stable on purpose::

    MDMP101 error   undeclared-collective: <message> [<file>:<line>]

CI asserts on the ``MDMPxxx`` prefix; humans read the rest.  Verbose
mode adds the declared-op / traced-op side-by-side and the fix hint
under each line (``--verify strict`` failures print this form so the
fix is one click away).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.analysis.diagnostics import Diagnostic


def render(diags: Sequence[Diagnostic], verbose: bool = False) -> str:
    """Render the diagnostics block (empty string when clean)."""
    return "\n".join(d.render(verbose=verbose) for d in diags)


def summary(diags: Sequence[Diagnostic], name: str = "program") -> str:
    """The one-line verdict the launchers print."""
    errors = sum(1 for d in diags if d.severity == "error")
    warnings = len(diags) - errors
    if not diags:
        return f"mdmplint: {name} clean (0 diagnostics)"
    return (f"mdmplint: {name} {errors} error(s), "
            f"{warnings} warning(s)")


def exit_code(diags: Sequence[Diagnostic]) -> int:
    """Process exit status: 1 iff any error-severity diagnostic."""
    return 1 if any(d.severity == "error" for d in diags) else 0
