"""Shared diagnostic type for the static-analysis passes (the port's own copy
of ``repro.analysis.violations``).

Every pass in the reference's ``analysis`` package — the schedule verifier, the config
compatibility checker and the determinism lint — reports findings as a flat
``list[Violation]`` so callers (the ``verify_schedules`` debug hook, pytest
assertions, the lint CLI) can format, filter and count them uniformly.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Violation", "format_violations"]


@dataclasses.dataclass(frozen=True)
class Violation:
    """One static-analysis finding.

    ``rule`` is the stable machine-readable rule slug (tests key on it);
    ``message`` the human-readable diagnostic.  Location fields are pass-
    specific: the schedule verifier sets ``index`` (a transfer index), the
    lint sets ``file``/``line``, the config checker sets ``file`` to the
    config class name.
    """

    rule: str
    message: str
    index: int | None = None     # schedule verifier: transfer index
    file: str | None = None      # lint: source path; config: class name
    line: int | None = None      # lint: 1-based source line

    def __str__(self) -> str:
        loc = ""
        if self.file is not None:
            loc = f"{self.file}:{self.line}: " if self.line is not None \
                else f"{self.file}: "
        elif self.index is not None:
            loc = f"transfer {self.index}: "
        return f"{loc}[{self.rule}] {self.message}"


def format_violations(violations: list[Violation]) -> str:
    return "\n".join(str(v) for v in violations)
