"""The network control plane: telemetry -> damped replan -> typed events
(the port's own copy of ``repro.control.plane``).

One :class:`ControlPlane` instance feeds *both* synchronization planes
(paper Sec 4.2 "Delay Monitoring" + "Re-group damping"): the **WAN plane**
(``repro_torch.core.replication.GeoCluster``) observes
:class:`~repro_torch.control.events.PlanChanged` to route write-set rounds
over the new grouping, and the **device plane**
(``repro_torch.train.trainer.Trainer``) observes
:class:`~repro_torch.control.events.RelayOrderChanged` to recompute
``relay_psum``'s ring order and rebuild its step.

Event flow::

    NetworkView.sample()         probe traffic, EWMA / Vivaldi estimate
        -> link detector         sustained per-link deviation (damped)
        -> damped Replanner      regroup only on sustained matrix deviation
        -> relay-order search    TIV-effective bottleneck ring
        -> emit(events)          every subscriber, both planes

**Replan timing contract**: :meth:`ControlPlane.force_replan` replans
*immediately* against the most recent observation and emits events before
returning — unlike the bare :meth:`repro_torch.core.planner.Replanner.force`
without a matrix, which only takes effect at the next ``observe()``.  Event
signals (a trainer straggler trip, a node failure) therefore never wait a
round for the plan to react.
"""

from __future__ import annotations

import weakref
from typing import Callable, Iterable

import numpy as np

from ..core.latency import one_relay_effective
from ..core.planner import GroupPlan, Replanner, best_plan
from .events import (
    LinkDegraded,
    LinkRecovered,
    NetworkEvent,
    PlanChanged,
    RelayOrderChanged,
)
from .network import NetworkView, as_view

__all__ = ["ControlPlane", "relay_ring_order", "ring_cost"]


# ---------------------------------------------------------------------------
# TIV relay-order search
# ---------------------------------------------------------------------------


def _canonical_ring(order: list[int]) -> tuple[int, ...]:
    """Rotation/reflection-normalize a ring: start at the smallest node id,
    walk toward its smaller neighbor.  Equivalent rings map to one tuple."""
    n = len(order)
    if n <= 2:
        return tuple(sorted(order))
    s = order.index(min(order))
    rot = order[s:] + order[:s]
    if rot[1] > rot[-1]:
        rot = [rot[0]] + rot[1:][::-1]
    return tuple(rot)


def ring_cost(lat: np.ndarray, order: Iterable[int]) -> tuple[float, float]:
    """(max link, sum of links) of a relay ring on a latency matrix.

    The ring all-reduce proceeds in lockstep, so its per-step time is the
    slowest hop — minimize the max first (the paper's bottleneck objective),
    sum as tie-break.
    """
    o = list(order)
    n = len(o)
    hops = [float(lat[o[i], o[(i + 1) % n]]) for i in range(n)]
    return (max(hops), sum(hops)) if hops else (0.0, 0.0)


def _two_opt(
    eff: np.ndarray,
    order: list[int],
    *,
    touched: set[int] | None = None,
    on_eval: Callable[[], None] | None = None,
) -> list[int]:
    """2-opt refinement on the (max, sum) ring objective.

    ``touched`` restricts the neighborhood to moves whose removed/created
    ring edges involve one of the given nodes (the per-edge incremental
    path); ``None`` sweeps the full neighborhood.  ``on_eval`` is called
    once per candidate evaluated (search-cost accounting).
    """
    n = len(order)
    best_cost = ring_cost(eff, order)
    improved = True
    while improved:
        improved = False
        for a in range(n - 1):
            for b in range(a + 2, n):
                if a == 0 and b == n - 1:
                    continue  # reversing the whole ring is a no-op
                if touched is not None:
                    ends = {order[a], order[a + 1],
                            order[b], order[(b + 1) % n]}
                    if not (ends & touched):
                        continue  # move doesn't touch a signalled edge
                if on_eval is not None:
                    on_eval()
                cand = (order[: a + 1] + order[a + 1: b + 1][::-1]
                        + order[b + 1:])
                c = ring_cost(eff, cand)
                if c < best_cost:
                    order, best_cost = cand, c
                    improved = True
    return order


def _ring_metric(lat: np.ndarray, *, tiv: bool, tiv_margin: float) -> np.ndarray:
    """The symmetric hop-cost matrix the ring searches score against."""
    eff = lat
    if tiv:
        eff, _ = one_relay_effective(lat, margin=tiv_margin)
    return np.maximum(eff, eff.T)


def relay_ring_order(
    lat: np.ndarray, *, tiv: bool = False, tiv_margin: float = 0.05
) -> tuple[int, ...]:
    """Relay ring for ``relay_psum`` from a measured latency matrix.

    Searches a ring minimizing (max hop, sum of hops) — greedy
    nearest-neighbor seeded, 2-opt refined.  The ring itself is the TIV
    exploitation here: a pair whose direct link is congested simply never
    becomes ring-adjacent, traffic between them flows through the
    intermediate ring hops.

    ``tiv=False`` (default) scores hops on *direct* latencies — what
    ``relay_psum``'s ``ppermute`` actually executes.  Pass ``tiv=True``
    only for deployments whose ring hops really ride overlay relays
    (``one_relay_effective``); scoring relay-discounted hops while
    executing direct sends would place a relay-only-cheap pair adjacent
    and hand the ring its worst direct link as the bottleneck.

    The result is canonical (see :func:`_canonical_ring`), so equivalent
    rings compare equal and never fire spurious :class:`RelayOrderChanged`
    events.
    """
    n = lat.shape[0]
    if n <= 2:
        return tuple(range(n))
    eff = _ring_metric(lat, tiv=tiv, tiv_margin=tiv_margin)

    # greedy nearest-neighbor seed
    order = [0]
    left = set(range(1, n))
    while left:
        cur = order[-1]
        nxt = min(left, key=lambda j: (eff[cur, j], j))
        order.append(nxt)
        left.remove(nxt)

    return _canonical_ring(_two_opt(eff, order))


# ---------------------------------------------------------------------------
# ControlPlane
# ---------------------------------------------------------------------------


class ControlPlane:
    """Event-driven replanning over a :class:`NetworkView`.

    Parameters
    ----------
    view:
        Latency source for :meth:`step` (pull mode).  ``None`` is allowed:
        a caller then pushes matrices through :meth:`observe` and the plane
        is purely reactive.
    plan_fn:
        ``fn(lat) -> GroupPlan``.  ``None`` installs a default
        :func:`~repro_torch.core.planner.best_plan` search (ranked by the
        plan's latency cost, or with ``rank_payload_bytes`` by a simulated
        makespan); a consumer with better context (the WAN engine's
        bandwidth/payload-aware ranking) may :meth:`bind_planner` over the
        default once.
    replan_threshold / replan_sustain:
        The damped Replanner's sustained-deviation policy (Sec 4.2).
    degrade_factor / recover_factor / degrade_sustain / link_alpha:
        Per-link detector: a link is degraded after ``degrade_sustain``
        consecutive samples above ``degrade_factor`` x its EWMA baseline,
        recovered after the same number below ``recover_factor`` x baseline.
        The baseline freezes while a link is degraded (otherwise it would
        chase the spike and self-"recover").
    tiv / ring_tiv:
        ``tiv`` governs the *plan* search (the WAN plane's inter-aggregator
        hops ride overlay relays, Sec 5).  ``ring_tiv`` governs the relay
        *ring* search and defaults to False because ``relay_psum`` executes
        direct hops — see :func:`relay_ring_order`.
    rank_payload_bytes / rank_bandwidth_mbps / barrier / rank_streaming:
        Replan-scoring context for the built-in default planner.  With a
        payload estimate, candidate plans are ranked by the simulated round
        makespan — the event-driven transfer-DAG critical path by default
        (``barrier=True`` scores the legacy phase-sum), so replans reward
        grouping that overlaps gather/exchange/scatter stages.
        ``rank_streaming=True`` scores two *stitched* epochs instead of one
        isolated round, so replans additionally reward cross-epoch
        pipelining (epoch e+1 gathers streaming under epoch e scatters) —
        the ranking a streaming replication engine executes.  Consumers
        with live context (the replication engine's payload-EWMA planner)
        still override via :meth:`bind_planner`.
    """

    def __init__(
        self,
        view: NetworkView | np.ndarray | None = None,
        *,
        plan_fn: Callable[[np.ndarray], GroupPlan] | None = None,
        replan_threshold: float = 0.20,
        replan_sustain: int = 3,
        degrade_factor: float = 1.5,
        recover_factor: float = 1.15,
        degrade_sustain: int = 3,
        link_alpha: float = 0.2,
        tiv: bool = True,
        ring_tiv: bool = False,
        tiv_margin: float = 0.05,
        planner: str = "kcenter",
        planner_time_limit_s: float = 5.0,
        rank_payload_bytes: float | None = None,
        rank_bandwidth_mbps: float | np.ndarray | None = None,
        barrier: bool = False,
        rank_streaming: bool = False,
    ):
        if rank_streaming and barrier:
            # fail at construction, not mid-run at the first replan
            raise ValueError(
                "rank_streaming=True scores the event engine; barrier=True "
                "has no cross-epoch semantics"
            )
        self.view = as_view(view) if view is not None else None
        self.tiv = tiv
        self.ring_tiv = ring_tiv
        self.tiv_margin = tiv_margin
        self._default_planner = plan_fn is None
        if plan_fn is None:
            plan_fn = lambda lat: best_plan(  # noqa: E731
                lat, tiv=tiv, tiv_margin=tiv_margin, method=planner,
                time_limit_s=planner_time_limit_s,
                payload_bytes=rank_payload_bytes,
                bandwidth_mbps=rank_bandwidth_mbps,
                barrier=barrier,
                streaming=rank_streaming,
            )
        self.replanner = Replanner(
            plan_fn, threshold=replan_threshold, sustain=replan_sustain
        )
        self.degrade_factor = degrade_factor
        self.recover_factor = recover_factor
        self.degrade_sustain = degrade_sustain
        self.link_alpha = link_alpha

        self._subs: list[tuple[Callable[[NetworkEvent], None], tuple | None]] = []
        self._round = 0
        self._last_lat: np.ndarray | None = None
        self._relay_order: tuple[int, ...] | None = None
        self._base: np.ndarray | None = None
        self._over = self._under = None
        self._degraded = None
        self.events: list[NetworkEvent] = []
        # relay-order search accounting: full recomputes vs per-edge
        # incremental refinements, and 2-opt candidate evaluations on the
        # incremental path (the scaling metric past ~64 pods)
        self.relay_full_searches = 0
        self.relay_incremental_searches = 0
        self.relay_incremental_evals = 0

    # -- planner binding --------------------------------------------------------

    def bind_planner(self, plan_fn: Callable[[np.ndarray], GroupPlan]) -> bool:
        """Install a consumer's plan function, a bound method, over the
        built-in default.

        Returns True when installed.  A non-default planner (explicit
        ``plan_fn`` at construction, or a previous bind) is kept — so on a
        shared plane, the first engine's payload-aware planner wins and
        later consumers just subscribe.  The method is held weakly: the
        plane keeps no consumer alive (a dropped engine frees its device
        store at once), and once the consumer is gone the default plans
        again.
        """
        if not self._default_planner:
            return False
        default, ref = self.replanner.plan_fn, weakref.WeakMethod(plan_fn)
        self.replanner.plan_fn = lambda lat: (ref() or default)(lat)
        self._default_planner = False
        return True

    # -- subscriptions ----------------------------------------------------------

    def subscribe(
        self,
        fn: Callable[[NetworkEvent], None],
        *,
        events: tuple[type, ...] | None = None,
    ) -> Callable[[NetworkEvent], None]:
        """Register ``fn`` for all events (or only the given event types)."""
        self._subs.append((fn, events))
        return fn

    def unsubscribe(self, fn: Callable[[NetworkEvent], None]) -> None:
        self._subs = [(f, ev) for f, ev in self._subs if f is not fn]

    def _emit(self, event: NetworkEvent) -> None:
        self.events.append(event)
        for fn, types in list(self._subs):
            if types is None or isinstance(event, types):
                fn(event)

    # -- state ------------------------------------------------------------------

    @property
    def plan(self) -> GroupPlan | None:
        return self.replanner.plan

    @property
    def relay_order(self) -> tuple[int, ...] | None:
        return self._relay_order

    @property
    def round(self) -> int:
        return self._round

    @property
    def replan_count(self) -> int:
        return self.replanner.replan_count

    @property
    def last_latency(self) -> np.ndarray | None:
        return None if self._last_lat is None else self._last_lat.copy()

    @property
    def probe_bytes(self) -> int:
        return 0 if self.view is None else self.view.probe_bytes

    def event_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events:
            out[type(e).__name__] = out.get(type(e).__name__, 0) + 1
        return out

    # -- link detector ----------------------------------------------------------

    def _detect_links(self, lat: np.ndarray) -> list[NetworkEvent]:
        if self._base is None:
            n = lat.shape[0]
            self._base = lat.copy()
            self._over = np.zeros((n, n), dtype=int)
            self._under = np.zeros((n, n), dtype=int)
            self._degraded = np.zeros((n, n), dtype=bool)
            return []
        base = np.where(self._base > 0, self._base, np.inf)
        over = lat > self.degrade_factor * base
        under = lat <= self.recover_factor * np.where(np.isinf(base), 0.0, base)
        self._over = np.where(over, self._over + 1, 0)
        self._under = np.where(under, self._under + 1, 0)
        newly_deg = ~self._degraded & (self._over >= self.degrade_sustain)
        newly_rec = self._degraded & (self._under >= self.degrade_sustain)
        fired: list[NetworkEvent] = []
        for cls, mask in ((LinkDegraded, newly_deg), (LinkRecovered, newly_rec)):
            for i, j in zip(*np.where(np.triu(mask, k=1))):
                fired.append(cls(
                    round=self._round, i=int(i), j=int(j),
                    baseline_ms=float(self._base[i, j]),
                    observed_ms=float(lat[i, j]),
                ))
        self._degraded |= newly_deg
        self._degraded &= ~newly_rec
        # EWMA baseline tracks only healthy links
        a = self.link_alpha
        track = ~self._degraded
        self._base = np.where(track, (1 - a) * self._base + a * lat, self._base)
        return fired

    # -- the control round ------------------------------------------------------

    def step(self) -> GroupPlan:
        """Pull mode: sample the view once and process the round."""
        if self.view is None:
            raise RuntimeError(
                "ControlPlane has no NetworkView; push matrices via observe()"
            )
        return self.observe(self.view.sample())

    def observe(self, lat: np.ndarray) -> GroupPlan:
        """Push mode: process one measured/estimated latency matrix.

        Runs the damped link detector and Replanner, updates the relay
        order when a sustained signal fired, and emits events *before*
        returning the (possibly updated) plan — so by the time the WAN
        plane schedules its round, the device plane has already seen the
        same events.
        """
        self._round += 1
        lat = np.asarray(lat, dtype=float)
        self._last_lat = lat.copy()
        link_events = self._detect_links(lat)
        prev_plan = self.replanner.plan
        plan = self.replanner.observe(lat)
        plan_changed = plan is not prev_plan
        for ev in link_events:
            self._emit(ev)
        if plan_changed:
            self._emit(PlanChanged(
                round=self._round, plan=plan, previous=prev_plan,
                reason="initial" if prev_plan is None else "sustained-deviation",
            ))
        # relay order follows the same damping: recompute only on a
        # sustained signal (replan or link transition), never on raw jitter.
        # A plan change (or a missing ring) triggers the full search; a
        # link-only signal takes the per-edge incremental path — only 2-opt
        # moves whose ring edges touch the degraded/recovered endpoints are
        # re-evaluated, so the search cost scales with the signal, not n^2.
        if plan_changed or self._relay_order is None:
            self._update_relay_order(lat, reason=(
                "plan-changed" if plan_changed else "link-event"
            ))
        elif link_events:
            self._incremental_relay_update(lat, link_events, reason="link-event")
        return plan

    def _set_relay_order(self, order: tuple[int, ...], *, reason: str) -> None:
        if order != self._relay_order:
            prev = self._relay_order
            self._relay_order = order
            self._emit(RelayOrderChanged(
                round=self._round, order=order, previous=prev, reason=reason,
            ))

    def _update_relay_order(self, lat: np.ndarray, *, reason: str) -> None:
        self.relay_full_searches += 1
        order = relay_ring_order(
            lat, tiv=self.ring_tiv, tiv_margin=self.tiv_margin
        )
        self._set_relay_order(order, reason=reason)

    def _incremental_relay_update(
        self, lat: np.ndarray, link_events: Iterable[NetworkEvent], *,
        reason: str,
    ) -> None:
        """Per-edge incremental 2-opt: refine the current ring against the
        fresh matrix, evaluating only moves whose removed/created ring edges
        touch an endpoint of a degraded or recovered link.  The damping
        contract is unchanged — this still fires only on sustained link
        transitions — but the ring is repaired locally instead of re-planned
        globally."""
        self.relay_incremental_searches += 1
        order = list(self._relay_order)
        if len(order) <= 3:  # every 3-node ring is equivalent; nothing to repair
            return
        touched = {e.i for e in link_events} | {e.j for e in link_events}
        eff = _ring_metric(lat, tiv=self.ring_tiv, tiv_margin=self.tiv_margin)

        def count():
            self.relay_incremental_evals += 1

        order = _two_opt(eff, order, touched=touched, on_eval=count)
        self._set_relay_order(_canonical_ring(order), reason=reason)

    # -- forced transitions -----------------------------------------------------

    def force_replan(self, *, reason: str = "forced") -> GroupPlan | None:
        """Replan *immediately* against the latest observation.

        This is the event-driven path (straggler trips, operator action):
        the plan and relay order update now, and events fire before this
        returns — not at the next ``observe()``.  With no observation yet,
        samples the view once when available, otherwise returns None (there
        is nothing to plan against).
        """
        if self._last_lat is None:
            if self.view is None:
                return None
            self._round += 1
            self._last_lat = self.view.sample()
        prev = self.replanner.plan
        plan = self.replanner.force(self._last_lat)
        self._emit(PlanChanged(
            round=self._round, plan=plan, previous=prev, reason=reason,
        ))
        self._update_relay_order(self._last_lat, reason=reason)
        return plan

    def on_node_failure(self, node: int) -> GroupPlan | None:
        """Failover (Sec 4.4): drop the node from the current plan *now* and
        emit the degraded plan; the full regroup happens at the next
        observation (when a matrix reflecting the failure arrives), per the
        Replanner's documented force contract."""
        prev = self.replanner.plan
        plan = self.replanner.on_node_failure(node)
        if plan is None:
            return None
        self._emit(PlanChanged(
            round=self._round, plan=plan, previous=prev,
            reason=f"node-failure:{node}",
        ))
        return plan
