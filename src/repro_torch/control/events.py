"""Typed network-control events (the port's own copy of
``repro.control.events``; paper Sec 4.2 "Delay Monitoring" + damping).

The reference's ``ControlPlane`` turns raw latency samples into a small
vocabulary of events that *both* synchronization planes consume:

* :class:`LinkDegraded` / :class:`LinkRecovered` — a single link's sustained
  departure from (return to) its EWMA baseline.
* :class:`PlanChanged` — the damped Replanner produced a new
  :class:`~repro_torch.core.planner.GroupPlan`.
* :class:`RelayOrderChanged` — the TIV relay-order search produced a new
  relay ring; the device plane maps this onto ``relay_psum``'s ``order``
  (``repro_torch.dist.collectives``, whose ``react`` tests ``isinstance``
  against this module's class, not the reference's).

Events are frozen dataclasses: subscribers may hold them and compare them.
The port's :class:`~repro_torch.control.plane.ControlPlane` emits them.
"""

from __future__ import annotations

import dataclasses

from ..core.planner import GroupPlan

__all__ = [
    "NetworkEvent",
    "LinkDegraded",
    "LinkRecovered",
    "PlanChanged",
    "RelayOrderChanged",
]


@dataclasses.dataclass(frozen=True, kw_only=True)
class NetworkEvent:
    """Base class for all control-plane events.

    ``round`` is the ControlPlane's observation counter at emission time;
    ``reason`` carries the trigger ("sustained-deviation", "node-failure",
    "straggler@step12", ...).
    """

    round: int
    reason: str = ""


@dataclasses.dataclass(frozen=True, kw_only=True)
class LinkDegraded(NetworkEvent):
    """Link (i, j) exceeded ``degrade_factor`` x its EWMA baseline for
    ``degrade_sustain`` consecutive samples."""

    i: int
    j: int
    baseline_ms: float
    observed_ms: float


@dataclasses.dataclass(frozen=True, kw_only=True)
class LinkRecovered(NetworkEvent):
    """A previously-degraded link returned under ``recover_factor`` x its
    baseline for ``degrade_sustain`` consecutive samples."""

    i: int
    j: int
    baseline_ms: float
    observed_ms: float


@dataclasses.dataclass(frozen=True, kw_only=True)
class PlanChanged(NetworkEvent):
    """The damped Replanner installed a new grouping plan."""

    plan: GroupPlan
    previous: GroupPlan | None = None


@dataclasses.dataclass(frozen=True, kw_only=True)
class RelayOrderChanged(NetworkEvent):
    """The TIV relay-order search produced a new relay ring.

    ``order`` is canonical (rotation/reflection-normalized), so two
    equivalent rings never produce a spurious event.
    """

    order: tuple[int, ...]
    previous: tuple[int, ...] | None = None
