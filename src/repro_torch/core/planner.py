"""The grouping plan (the port's own copy of ``GroupPlan`` from
``repro.core.planner``).

Only the plan itself is here, because the control plane's events carry
one.  The planners that produce plans (MILP, K-center, the damped
Replanner) come with the control-plane slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["GroupPlan"]


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """A grouping of ``n`` nodes into ``k`` groups with one aggregator each."""

    groups: tuple[tuple[int, ...], ...]
    aggregators: tuple[int, ...]
    method: str = ""
    solve_time_s: float = 0.0
    objective: float = float("nan")

    @property
    def k(self) -> int:
        return len(self.groups)

    @property
    def n(self) -> int:
        return sum(len(g) for g in self.groups)

    def group_of(self) -> np.ndarray:
        """Array mapping node id -> group index."""
        out = np.full(self.n, -1, dtype=int)
        for j, g in enumerate(self.groups):
            for i in g:
                out[i] = j
        return out

    def validate(self, n: int | None = None) -> None:
        nodes = [i for g in self.groups for i in g]
        if len(nodes) != len(set(nodes)):
            raise ValueError("node assigned to multiple groups")
        if n is not None and sorted(nodes) != list(range(n)):
            raise ValueError(f"plan covers {sorted(nodes)}, expected 0..{n-1}")
        if len(self.aggregators) != len(self.groups):
            raise ValueError("need exactly one aggregator per group")
        for j, (g, a) in enumerate(zip(self.groups, self.aggregators)):
            if a not in g:
                raise ValueError(f"aggregator {a} not a member of group {j}")
            if len(g) == 0:
                raise ValueError(f"group {j} is empty")
