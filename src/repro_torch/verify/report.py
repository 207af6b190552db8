"""VerifyReport — the machine-readable result of a verification pass.

Every checker emits :class:`Violation` records naming the check that
fired, the offending instruction index range (``instr_lo``/``instr_hi``
— the same coordinates ``ExecStats.per_layer`` and the obs layer spans
carry, so a violation is joinable against traces and profiles), and a
human sentence.  A :class:`VerifyReport` rolls the full run up: which
checks ran, which were skipped (and why — a bytes-only verification
cannot re-derive the residency schedule, for instance), and renders as
JSON (CI artifact) or markdown (human artifact).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

# Canonical checker roster, in run order.  ``checks_run`` is always a
# subset of this; anything absent lands in ``checks_skipped`` with a
# reason.
ALL_CHECKS = (
    "structure",
    "def_before_use",
    "use_after_free",
    "partition_coverage",
    "kernel_legality",
    "halo_completeness",
    "resident_budget",
    "liveness_schedule",
)


@dataclasses.dataclass
class Violation:
    """One checker finding, anchored to an instruction index range."""

    check: str
    message: str
    layer_id: int = -1
    instr_lo: int = -1
    instr_hi: int = -1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "check": self.check,
            "message": self.message,
            "layer_id": int(self.layer_id),
            "instr_lo": int(self.instr_lo),
            "instr_hi": int(self.instr_hi),
        }

    def __str__(self) -> str:
        where = ""
        if self.instr_lo >= 0:
            where = f" [instr {self.instr_lo}..{self.instr_hi}]"
        layer = f" layer {self.layer_id}" if self.layer_id >= 0 else ""
        return f"{self.check}:{layer}{where} {self.message}"


@dataclasses.dataclass
class VerifyReport:
    """Outcome of one program verification."""

    program: str = ""
    checks_run: List[str] = dataclasses.field(default_factory=list)
    checks_skipped: Dict[str, str] = dataclasses.field(default_factory=dict)
    violations: List[Violation] = dataclasses.field(default_factory=list)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def checks_failed(self) -> List[str]:
        seen: List[str] = []
        for v in self.violations:
            if v.check not in seen:
                seen.append(v.check)
        return seen

    @property
    def checks_passed(self) -> List[str]:
        bad = set(self.checks_failed)
        return [c for c in self.checks_run if c not in bad]

    # ------------------------------------------------------------------ #
    def add(self, check: str, message: str, layer_id: int = -1,
            instr_lo: int = -1, instr_hi: int = -1) -> None:
        self.violations.append(Violation(
            check=check, message=message, layer_id=layer_id,
            instr_lo=instr_lo, instr_hi=instr_hi))

    def ran(self, check: str) -> None:
        if check not in self.checks_run:
            self.checks_run.append(check)

    def skip(self, check: str, reason: str) -> None:
        if check not in self.checks_run:
            self.checks_skipped[check] = reason

    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return {
            "program": self.program,
            "ok": self.ok,
            "checks_run": list(self.checks_run),
            "checks_passed": list(self.checks_passed),
            "checks_failed": list(self.checks_failed),
            "checks_skipped": dict(self.checks_skipped),
            "violations": [v.to_dict() for v in self.violations],
            "stats": dict(self.stats),
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def to_markdown(self) -> str:
        lines = [f"## `{self.program or 'program'}` — "
                 f"{'PASS' if self.ok else 'FAIL'}", ""]
        lines.append(f"checks passed: {len(self.checks_passed)}/"
                     f"{len(self.checks_run)}"
                     + (" (skipped: "
                        f"{', '.join(sorted(self.checks_skipped))})"
                        if self.checks_skipped else ""))
        if self.stats:
            stat = ", ".join(f"{k}={v}" for k, v in sorted(
                self.stats.items()) if not isinstance(v, dict))
            lines += ["", f"_{stat}_"]
        if self.violations:
            lines += ["", "| check | layer | instrs | message |",
                      "|---|---|---|---|"]
            for v in self.violations:
                span = (f"{v.instr_lo}..{v.instr_hi}"
                        if v.instr_lo >= 0 else "")
                lid = str(v.layer_id) if v.layer_id >= 0 else ""
                lines.append(f"| `{v.check}` | {lid} | {span} | "
                             f"{v.message} |")
        lines.append("")
        return "\n".join(lines)


class VerifyError(RuntimeError):
    """Raised by ``Engine.compile(verify=True)`` on a failing report."""

    def __init__(self, report: VerifyReport) -> None:
        self.report = report
        head = "; ".join(str(v) for v in report.violations[:3])
        more = (f" (+{len(report.violations) - 3} more)"
                if len(report.violations) > 3 else "")
        super().__init__(
            f"program verification failed for {report.program or '?'}: "
            f"{head}{more}")
