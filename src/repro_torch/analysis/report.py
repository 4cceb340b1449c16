"""Result types for the static plan verifier.

Every pass returns ``Violation`` records; the orchestrator folds them into a
``StaticReport`` that ``api.compile(..., check="static")`` attaches to the
session and renders inside ``Session.describe()``.  A FAIL verdict is raised
as ``AnalysisError`` at compile time, before any actor fires.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Violation:
    """One static-analysis finding.

    ``pass_name`` identifies the pass ("deadlock", "sbp", "memory", "trace"),
    ``subject`` the offending object (a cycle, an edge, a tensor), and
    ``message`` the human-readable explanation.
    """

    pass_name: str
    subject: str
    message: str

    def describe(self) -> str:
        return f"[{self.pass_name}] {self.subject}: {self.message}"


@dataclasses.dataclass
class StaticReport:
    """Aggregate outcome of the static passes over one compiled plan."""

    verdict: str  # "PASS" | "FAIL" | "SKIPPED"
    violations: Tuple[Violation, ...] = ()
    checked_edges: int = 0
    checked_channels: int = 0
    peak_bytes_per_device: Dict[str, int] = dataclasses.field(default_factory=dict)
    min_feasible_regs: Optional[Dict[str, int]] = None
    passes: Tuple[str, ...] = ()

    def describe(self) -> str:
        lines: List[str] = []
        if self.verdict == "SKIPPED":
            lines.append("static analysis: skipped")
            return "\n".join(lines)
        ran = ", ".join(self.passes) if self.passes else "none"
        lines.append(
            f"static analysis: {self.verdict} "
            f"(passes: {ran}; {self.checked_edges} edges, "
            f"{self.checked_channels} channels checked)"
        )
        for name, nbytes in sorted(self.peak_bytes_per_device.items()):
            lines.append(f"  static peak bytes [{name}]: {nbytes}")
        for v in self.violations:
            lines.append(f"  {v.describe()}")
        if self.min_feasible_regs is not None:
            pretty = ", ".join(
                f"{k}={q}" for k, q in sorted(self.min_feasible_regs.items())
            )
            lines.append(f"  minimal feasible quotas: {pretty}")
        return "\n".join(lines)


class AnalysisError(ValueError):
    """Raised by ``api.compile`` when a static pass rejects the plan."""

    def __init__(self, report: StaticReport) -> None:
        self.report = report
        detail = "; ".join(v.describe() for v in report.violations[:4])
        more = len(report.violations) - 4
        if more > 0:
            detail += f"; (+{more} more)"
        super().__init__(f"static analysis rejected the plan: {detail}")
