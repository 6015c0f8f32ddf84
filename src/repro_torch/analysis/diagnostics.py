"""Typed diagnostics for the static communication verifier (mdmplint).

Every finding the analyzer emits is a ``Diagnostic`` — a frozen record
with a registry code (``MDMP...``), a severity, the program site it
anchors to, the declared-side and traced-side renderings it reconciles,
and a fix hint.  The registry below is the single source of truth the CI
greps, the EXPERIMENTS.md table, and ``launch/lint.py`` all enumerate.

Code families (hundreds digit = pass family):

  * MDMP0xx — declaration validity (axes, spec well-formedness)
  * MDMP1xx — declared-vs-traced drift
  * MDMP2xx — permute validity (bijection, ring closure)
  * MDMP3xx — ordering / deadlock (wait-for cycles)
  * MDMP4xx — overlap races (in-flight buffer hazards)
  * MDMP5xx — plan feasibility (knobs the executor would silently clamp)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Site:
    """Repo-relative program location a diagnostic points at."""
    file: str = ""
    line: int = 0

    def __str__(self) -> str:
        if not self.file:
            return "<unknown site>"
        return f"{self.file}:{self.line}" if self.line else self.file

    @classmethod
    def of(cls, obj) -> "Site":
        """Coerce the provenance shapes the graph carries: a (file, line)
        tuple (CommSpec.site), a "file:line" string (CollectiveRecord
        .source), or None."""
        if obj is None:
            return cls()
        if isinstance(obj, Site):
            return obj
        if isinstance(obj, str):
            if ":" in obj:
                f, _, ln = obj.rpartition(":")
                try:
                    return cls(f, int(ln))
                except ValueError:
                    return cls(obj, 0)
            return cls(obj, 0)
        try:
            f, ln = obj
            return cls(str(f), int(ln))
        except Exception:
            return cls()


#: code -> (severity, title).  Severity is fixed per code — a corpus
#: golden file asserting "MDMP501" asserts the severity too.
CODES: dict[str, tuple[str, str]] = {
    "MDMP001": ("error", "unknown-axis"),
    "MDMP101": ("error", "undeclared-collective"),
    "MDMP102": ("error", "bytes-drift"),
    "MDMP103": ("warning", "stale-declaration"),
    "MDMP104": ("warning", "kind-mismatch"),
    "MDMP201": ("error", "non-bijective-permute"),
    "MDMP202": ("error", "ring-no-return"),
    "MDMP301": ("error", "wait-cycle"),
    "MDMP401": ("error", "stale-read-in-flight"),
    "MDMP402": ("error", "write-races-in-flight"),
    "MDMP501": ("error", "non-divisor-stream-chunks"),
    "MDMP502": ("error", "microbatch-indivisible"),
    "MDMP503": ("error", "stash-over-cap"),
    "MDMP504": ("error", "halo-k-exceeds-block"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding."""
    code: str                    # registry key, e.g. "MDMP101"
    severity: str                # "error" | "warning"
    title: str                   # registry short name
    message: str                 # one-line human statement
    label: str = ""              # CommOp/spec label it anchors to
    axis: str = ""
    site: Site = dataclasses.field(default_factory=Site)
    spec_ref: str = ""           # declared-side rendering (side-by-side)
    op_ref: str = ""             # traced/plan-side rendering
    hint: str = ""               # how to fix

    def render(self, verbose: bool = False) -> str:
        head = f"{self.code} {self.severity:7s} {self.title}"
        where = f" [{self.site}]" if self.site.file else ""
        line = f"{head}: {self.message}{where}"
        if not verbose:
            return line
        parts = [line]
        if self.spec_ref:
            parts.append(f"    declared | {self.spec_ref}")
        if self.op_ref:
            parts.append(f"    traced   | {self.op_ref}")
        if self.hint:
            parts.append(f"    fix      | {self.hint}")
        return "\n".join(parts)


def make(code: str, message: str, **kw) -> Diagnostic:
    """Build a Diagnostic with the registry's severity/title for ``code``."""
    sev, title = CODES[code]
    if "site" in kw:
        kw["site"] = Site.of(kw["site"])
    return Diagnostic(code=code, severity=sev, title=title,
                      message=message, **kw)
