"""Latency-aware Grouping Strategy Orchestrator (paper Sec 4.2 + Sec 5).

Implements:

* the exact MILP of Algorithm 1 via ``scipy.optimize.milp`` (HiGHS — the
  open-source stand-in for the paper's Gurobi),
* the K-center 2-approximation heuristic used at large scale (Sec 5),
* the baseline strategies the paper compares against in Fig. 12
  (hierarchical agglomerative clustering, KMeans on classical-MDS embeddings,
  random grouping, no grouping),
* the closed-form optimal group count ``k* = (N^2 / 2)^(1/3)`` with the
  guided search band (Sec 4.2, Eq. 4-5), and
* a damped ``Replanner`` that only regroups on sustained latency deviation
  (the "Re-group damping strategy").

All strategies return a :class:`GroupPlan`; the plan's paper-objective cost
``T = max_j(intra_j) + max(inter)`` is computed by :func:`plan_cost`.

This is the port's own copy of ``repro.core.planner``, registered in the
port's registry (``repro_torch.core.strategies``); :func:`best_plan` ranks
by a simulated round makespan through the port's copies of the schedule
builders and the WAN simulator (``repro_torch.core.schedule``,
``.simulator``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Sequence

import numpy as np

from . import strategies as _strategies
from .latency import one_relay_effective, validate_latency_matrix

__all__ = [
    "GroupPlan",
    "plan_cost",
    "milp_grouping",
    "kcenter_grouping",
    "agglomerative_grouping",
    "kmeans_grouping",
    "random_grouping",
    "no_grouping",
    "optimal_k",
    "k_search_band",
    "hierarchical_comm_cost",
    "best_plan",
    "Replanner",
]


# ---------------------------------------------------------------------------
# Plan representation
# ---------------------------------------------------------------------------


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

    def replace_aggregator(self, group_idx: int, new_agg: int) -> "GroupPlan":
        """Failover: swap the aggregator of one group (Sec 4.4)."""
        if new_agg not in self.groups[group_idx]:
            raise ValueError("new aggregator must be a group member")
        aggs = list(self.aggregators)
        aggs[group_idx] = new_agg
        return dataclasses.replace(self, aggregators=tuple(aggs), method=self.method + "+failover")

    def drop_node(self, node: int) -> "GroupPlan":
        """Remove a failed node; if it was an aggregator, promote a member."""
        groups: list[tuple[int, ...]] = []
        aggs: list[int] = []
        for g, a in zip(self.groups, self.aggregators):
            g2 = tuple(i for i in g if i != node)
            if not g2:
                continue
            a2 = a if a != node else g2[0]
            groups.append(g2)
            aggs.append(a2)
        return GroupPlan(tuple(groups), tuple(aggs), method=self.method + "+drop")


def _effective(lat: np.ndarray, tiv: bool, tiv_margin: float) -> np.ndarray:
    if not tiv:
        return lat
    eff, _ = one_relay_effective(lat, margin=tiv_margin)
    return eff


def plan_cost(
    lat: np.ndarray, plan: GroupPlan, *, tiv: bool = False, tiv_margin: float = 0.05
) -> float:
    """3-phase round cost: ``T = 2*max_j(intra_j) + max_{u,v in aggs}(L[u,v])``.

    ``intra_j`` is the worst member<->aggregator latency of group j (star
    topology) — paid twice per round (gather + scatter, Fig. 8); the inter
    term is the worst aggregator pair.  The paper's Eq. 1 uses a single
    intra term; the doubled form matches the executed 3-phase schedule and
    correctly degenerates to the flat round cost for singleton groups.

    TIV relays apply only to the inter-aggregator hop — the schedule never
    relays intra-group transfers (Sec 5 deploys relays on WAN paths).
    """
    intra = 0.0
    for g, a in zip(plan.groups, plan.aggregators):
        for i in g:
            if i != a:
                intra = max(intra, max(lat[i, a], lat[a, i]))
    eff = _effective(lat, tiv, tiv_margin)
    inter = 0.0
    for u, v in itertools.combinations(plan.aggregators, 2):
        inter = max(inter, max(eff[u, v], eff[v, u]))
    return 2.0 * intra + inter


# ---------------------------------------------------------------------------
# Optimal group count (Eq. 4-5)
# ---------------------------------------------------------------------------


def hierarchical_comm_cost(n: int, k: int) -> float:
    """Eq. 4: C_total = 2N(N/k - 1) + 2k(k - 1)."""
    if k <= 0:
        raise ValueError("k must be positive")
    return 2.0 * n * (n / k - 1.0) + 2.0 * k * (k - 1.0)


def optimal_k(n: int) -> float:
    """Eq. 5: k* = (N^2 / 2)^(1/3)."""
    return (n * n / 2.0) ** (1.0 / 3.0)


def k_search_band(n: int, *, tolerance: int = 1) -> list[int]:
    """Guided search band around k* (Sec 4.2, "The Setting of Group Number").

    Returns candidate group counts clipped to [2, n-1] (k=1 or k=n degenerate
    to flat schemes handled separately).
    """
    ks = optimal_k(n)
    lo = max(2, int(np.floor(ks)) - tolerance)
    hi = min(n - 1, int(np.ceil(ks)) + tolerance)
    if hi < lo:
        lo = hi = max(2, min(n - 1, int(round(ks))))
    return list(range(lo, hi + 1))


# ---------------------------------------------------------------------------
# MILP grouping (Algorithm 1)
# ---------------------------------------------------------------------------


def milp_grouping(
    lat: np.ndarray,
    k: int,
    *,
    tiv: bool = False,
    tiv_margin: float = 0.05,
    time_limit_s: float = 5.0,
    mip_rel_gap: float = 1e-4,
) -> GroupPlan:
    """Exact latency-aware grouping via mixed-integer linear programming.

    Decision variables (Algorithm 1): ``x[i,j]`` node-i-in-group-j, ``y[i,j]``
    node-i-aggregates-group-j; continuous ``l_j`` (max intra latency of group
    j), ``M >= l_j`` and ``Linter`` (max inter-aggregator latency).  Objective
    ``min 2*M + Linter`` (the executed 3-phase round pays intra twice).

    Linearization: the bilinear "i in group j AND a aggregates j" terms become
    ``l_j >= L[i,a] * (x[i,j] + y[a,j] - 1)``; the inter-aggregator max uses
    the implied binary ``isagg_u = sum_j y[u,j]`` with
    ``Linter >= L[u,v] * (isagg_u + isagg_v - 1)``.  TIV-effective latencies
    enter only the inter term (relays are deployed on WAN paths, Sec 5).
    """
    from scipy.optimize import LinearConstraint, Bounds, milp
    from scipy.sparse import lil_matrix

    validate_latency_matrix(lat)
    n = lat.shape[0]
    if not (1 <= k <= n):
        raise ValueError(f"k={k} out of range for n={n}")
    effs = np.maximum(lat, lat.T)          # intra: direct paths only
    eff_inter = _effective(lat, tiv, tiv_margin)
    effs_inter = np.maximum(eff_inter, eff_inter.T)

    t0 = time.perf_counter()  # lint: allow[wallclock] plan-search cost
    # variable layout: x (n*k) | y (n*k) | l (k) | M | Linter
    nx = n * k
    nvar = 2 * nx + k + 2
    ix = lambda i, j: i * k + j
    iy = lambda i, j: nx + i * k + j
    il = lambda j: 2 * nx + j
    iM = 2 * nx + k
    iL = 2 * nx + k + 1

    c = np.zeros(nvar)
    c[iM] = 2.0   # intra paid twice (gather + scatter)
    c[iL] = 1.0

    rows: list[tuple[dict[int, float], float, float]] = []  # (coeffs, lb, ub)

    # each node in exactly one group
    for i in range(n):
        rows.append(({ix(i, j): 1.0 for j in range(k)}, 1.0, 1.0))
    # each group exactly one aggregator
    for j in range(k):
        rows.append(({iy(i, j): 1.0 for i in range(n)}, 1.0, 1.0))
    # y <= x
    for i in range(n):
        for j in range(k):
            rows.append(({iy(i, j): 1.0, ix(i, j): -1.0}, -np.inf, 0.0))
    # intra: l_j - L[i,a] x[i,j] - L[i,a] y[a,j] >= -L[i,a]
    for j in range(k):
        for i in range(n):
            for a in range(n):
                if i == a:
                    continue
                w = effs[i, a]
                if w <= 0.0:
                    continue
                rows.append(
                    ({il(j): 1.0, ix(i, j): -w, iy(a, j): -w}, -w, np.inf)
                )
    # M >= l_j
    for j in range(k):
        rows.append(({iM: 1.0, il(j): -1.0}, 0.0, np.inf))
    # inter: Linter - L[u,v](isagg_u + isagg_v) >= -L[u,v]
    if k >= 2:
        for u in range(n):
            for v in range(u + 1, n):
                w = effs_inter[u, v]
                if w <= 0.0:
                    continue
                coeffs: dict[int, float] = {iL: 1.0}
                for j in range(k):
                    coeffs[iy(u, j)] = coeffs.get(iy(u, j), 0.0) - w
                    coeffs[iy(v, j)] = coeffs.get(iy(v, j), 0.0) - w
                rows.append((coeffs, -w, np.inf))
    # symmetry breaking: aggregator of group j has index below aggregator of
    # group j+1 (cuts the k! group-relabeling symmetry)
    for j in range(k - 1):
        coeffs = {}
        for i in range(n):
            coeffs[iy(i, j)] = coeffs.get(iy(i, j), 0.0) + float(i)
            coeffs[iy(i, j + 1)] = coeffs.get(iy(i, j + 1), 0.0) - float(i)
        rows.append((coeffs, -np.inf, -1.0))

    A = lil_matrix((len(rows), nvar))
    lb = np.empty(len(rows))
    ub = np.empty(len(rows))
    for r, (coeffs, l, u) in enumerate(rows):
        for v, w in coeffs.items():
            A[r, v] = w
        lb[r] = l
        ub[r] = u

    integrality = np.zeros(nvar)
    integrality[: 2 * nx] = 1
    bounds = Bounds(
        lb=np.concatenate([np.zeros(2 * nx), np.zeros(k + 2)]),
        ub=np.concatenate([np.ones(2 * nx), np.full(k + 2, np.inf)]),
    )
    res = milp(
        c,
        constraints=LinearConstraint(A.tocsr(), lb, ub),
        integrality=integrality,
        bounds=bounds,
        options={"time_limit": time_limit_s, "mip_rel_gap": mip_rel_gap},
    )
    dt = time.perf_counter() - t0  # lint: allow[wallclock] plan-search cost
    if res.x is None:
        raise RuntimeError(f"MILP grouping infeasible/failed: {res.message}")
    xv = res.x[:nx].reshape(n, k) > 0.5
    yv = res.x[nx : 2 * nx].reshape(n, k) > 0.5
    groups = tuple(tuple(np.flatnonzero(xv[:, j]).tolist()) for j in range(k))
    aggs = tuple(int(np.flatnonzero(yv[:, j])[0]) for j in range(k))
    plan = GroupPlan(groups, aggs, method="milp" + ("+tiv" if tiv else ""),
                     solve_time_s=dt, objective=float(res.fun))
    plan.validate(n)
    return plan


# ---------------------------------------------------------------------------
# K-center heuristic (Sec 5, "K-Center-Based Scalable Planner")
# ---------------------------------------------------------------------------


def _group_center(effs: np.ndarray, members: Sequence[int]) -> int:
    """1-center of a group: member minimizing the max latency to the others."""
    sub = effs[np.ix_(members, members)]
    return int(members[int(sub.max(axis=1).argmin())])


def kcenter_grouping(
    lat: np.ndarray,
    k: int,
    *,
    tiv: bool = False,
    tiv_margin: float = 0.05,
) -> GroupPlan:
    """Gonzalez farthest-point K-center: O(N*k), 2-approx on max intra latency.

    Clusters on direct latencies (intra transfers are never relayed); ``tiv``
    affects only the reported objective via :func:`plan_cost`.
    """
    validate_latency_matrix(lat)
    n = lat.shape[0]
    k = min(k, n)
    effs = np.maximum(lat, lat.T)
    t0 = time.perf_counter()  # lint: allow[wallclock] plan-search cost
    # first center: global 1-center
    centers = [int(effs.max(axis=1).argmin())]
    dist = effs[centers[0]].copy()
    for _ in range(1, k):
        nxt = int(dist.argmax())
        centers.append(nxt)
        dist = np.minimum(dist, effs[nxt])
    assign = effs[:, centers].argmin(axis=1)
    groups = []
    aggs = []
    for j in range(k):
        members = np.flatnonzero(assign == j).tolist()
        if centers[j] not in members:  # ties can strand the center
            members.append(centers[j])
        members = sorted(set(members))
        groups.append(tuple(members))
        aggs.append(_group_center(effs, members))
    dt = time.perf_counter() - t0  # lint: allow[wallclock] plan-search cost
    plan = GroupPlan(tuple(groups), tuple(aggs),
                     method="kcenter" + ("+tiv" if tiv else ""), solve_time_s=dt)
    plan.validate(n)
    return dataclasses.replace(plan, objective=plan_cost(lat, plan, tiv=tiv, tiv_margin=tiv_margin))


# ---------------------------------------------------------------------------
# Baseline strategies (Fig. 12)
# ---------------------------------------------------------------------------


def agglomerative_grouping(lat: np.ndarray, k: int) -> GroupPlan:
    """Complete-linkage hierarchical agglomerative clustering on latencies."""
    validate_latency_matrix(lat)
    n = lat.shape[0]
    t0 = time.perf_counter()  # lint: allow[wallclock] plan-search cost
    effs = np.maximum(lat, lat.T)
    clusters: list[list[int]] = [[i] for i in range(n)]
    # complete-linkage distance between clusters
    d = effs.copy().astype(float)
    np.fill_diagonal(d, np.inf)
    cd = d.copy()
    active = list(range(n))
    while len(active) > k:
        sub = cd[np.ix_(active, active)]
        flat = int(sub.argmin())
        a_i, a_j = divmod(flat, len(active))
        ci, cj = active[a_i], active[a_j]
        if ci > cj:
            ci, cj = cj, ci
        clusters[ci] = clusters[ci] + clusters[cj]
        clusters[cj] = []
        active.remove(cj)
        for other in active:
            if other == ci:
                continue
            cd[ci, other] = cd[other, ci] = max(cd[ci, other], cd[cj, other])
    groups = []
    aggs = []
    for ci in active:
        members = sorted(clusters[ci])
        groups.append(tuple(members))
        aggs.append(_group_center(effs, members))
    dt = time.perf_counter() - t0  # lint: allow[wallclock] plan-search cost
    plan = GroupPlan(tuple(groups), tuple(aggs), method="agglomerative", solve_time_s=dt)
    plan.validate(n)
    return dataclasses.replace(plan, objective=plan_cost(lat, plan))


def _mds_embed(effs: np.ndarray, dim: int = 4) -> np.ndarray:
    """Classical MDS embedding of a latency matrix (for KMeans baselines)."""
    n = effs.shape[0]
    d2 = effs ** 2
    j = np.eye(n) - np.ones((n, n)) / n
    b = -0.5 * j @ d2 @ j
    w, v = np.linalg.eigh(b)
    idx = np.argsort(w)[::-1][:dim]
    w = np.clip(w[idx], 0.0, None)
    return v[:, idx] * np.sqrt(w)[None, :]


def kmeans_grouping(
    lat: np.ndarray, k: int, rng: np.random.Generator | None = None, *, iters: int = 50
) -> GroupPlan:
    """Lloyd's KMeans on a classical-MDS embedding of the latency matrix."""
    validate_latency_matrix(lat)
    rng = rng or np.random.default_rng(0)
    n = lat.shape[0]
    t0 = time.perf_counter()  # lint: allow[wallclock] plan-search cost
    effs = np.maximum(lat, lat.T)
    x = _mds_embed(effs)
    cent = x[rng.choice(n, size=k, replace=False)]
    assign = np.zeros(n, dtype=int)
    for _ in range(iters):
        d = np.linalg.norm(x[:, None, :] - cent[None, :, :], axis=-1)
        new_assign = d.argmin(axis=1)
        # keep clusters non-empty: give empty clusters the farthest point
        for j in range(k):
            if not (new_assign == j).any():
                far = int(d.min(axis=1).argmax())
                new_assign[far] = j
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            cent[j] = x[assign == j].mean(axis=0)
    groups, aggs = [], []
    for j in range(k):
        members = sorted(np.flatnonzero(assign == j).tolist())
        groups.append(tuple(members))
        aggs.append(_group_center(effs, members))
    dt = time.perf_counter() - t0  # lint: allow[wallclock] plan-search cost
    plan = GroupPlan(tuple(groups), tuple(aggs), method=f"kmeans{k}", solve_time_s=dt)
    plan.validate(n)
    return dataclasses.replace(plan, objective=plan_cost(lat, plan))


def random_grouping(lat: np.ndarray, k: int, rng: np.random.Generator | None = None) -> GroupPlan:
    rng = rng or np.random.default_rng(0)
    n = lat.shape[0]
    t0 = time.perf_counter()  # lint: allow[wallclock] plan-search cost
    perm = rng.permutation(n)
    splits = np.array_split(perm, k)
    groups = tuple(tuple(sorted(int(i) for i in s)) for s in splits if len(s))
    aggs = tuple(int(rng.choice(list(g))) for g in groups)
    dt = time.perf_counter() - t0  # lint: allow[wallclock] plan-search cost
    plan = GroupPlan(groups, aggs, method="random", solve_time_s=dt)
    plan.validate(n)
    return dataclasses.replace(plan, objective=plan_cost(lat, plan))


def no_grouping(lat: np.ndarray) -> GroupPlan:
    """Flat all-to-all baseline expressed as k=N singleton groups."""
    n = lat.shape[0]
    groups = tuple((i,) for i in range(n))
    plan = GroupPlan(groups, tuple(range(n)), method="none")
    return dataclasses.replace(plan, objective=plan_cost(lat, plan))


def best_plan(
    lat: np.ndarray,
    *,
    tiv: bool = True,
    tiv_margin: float = 0.05,
    tolerance: int = 1,
    method: str = "milp",
    time_limit_s: float = 5.0,
    payload_bytes: float | None = None,
    bandwidth_mbps: float | np.ndarray | None = None,
    filter_keep: float = 1.0,
    barrier: bool = False,
    streaming: bool = False,
) -> GroupPlan:
    """GeoCoCo's guided planner: search k in the band around k*, keep the best.

    The flat (no-grouping) plan is always a candidate: when intra-group
    latency is not << inter (e.g. uniform-jitter WANs), hierarchy loses and
    GeoCoCo must fall back to direct transmission — the adaptive behavior
    the paper's robustness results (Fig. 17) rely on.

    When ``payload_bytes`` is given, candidates are ranked by the simulated
    round makespan (latency + NIC-contended serialization, with
    ``filter_keep`` modeling the aggregator-side payload reduction) instead
    of the latency-only MILP objective — the "balance latency and resource
    utilization" behavior of the Planner (Sec 4.1).  The makespan is the
    event-driven **transfer-DAG critical path** by default, so grouping
    decisions reward cross-stage overlap (a plan whose fast groups exchange
    while slow groups still gather scores better than the phase-sum would
    suggest); pass ``barrier=True`` to rank by the legacy barrier phase-sum
    instead (what a barrier engine will actually execute).  The MILP itself
    stays Algorithm 1's latency formulation.

    ``streaming=True`` (the streaming replication engine's ranking context)
    scores candidates by the makespan of **two stitched epochs**
    (:func:`~repro_torch.core.schedule.stitch_schedules`) instead of one isolated
    round: a plan whose epoch-``e+1`` gathers pipeline under epoch-``e``
    scatters scores the throughput it will actually sustain, which can
    rank-invert plans that tie on the single-round critical path.

    The guided band is the ~order-of-magnitude planning-cost reduction vs
    exhaustive k in [2, N-1] claimed in Sec 6.4.
    """
    if streaming and barrier:
        raise ValueError(
            "streaming ranking runs the event engine; barrier=True has no "
            "cross-epoch semantics"
        )

    def rank(p: GroupPlan) -> float:
        if payload_bytes is None:
            return plan_cost(lat, p, tiv=tiv, tiv_margin=tiv_margin)
        from .schedule import hierarchical_schedule, stitch_schedules
        from .simulator import WANSimulator

        bw = np.inf if bandwidth_mbps is None else bandwidth_mbps
        sim = WANSimulator(lat, bw, barrier=barrier)
        gp = np.array(
            [sum(payload_bytes for _ in g) * filter_keep for g in p.groups]
        )
        sched = hierarchical_schedule(
            p, payload_bytes, group_payload_bytes=gp, lat=lat,
            tiv=tiv, tiv_margin=tiv_margin,
        )
        if streaming:
            sched = stitch_schedules([sched, sched], n=lat.shape[0])
        return sim.run(sched).makespan_ms

    try:
        plan_fn = _strategies.get("planner", method)
    except KeyError as e:
        raise ValueError(str(e)) from None
    cands = [(rank(no_grouping(lat)), no_grouping(lat))]
    for k in k_search_band(lat.shape[0], tolerance=tolerance):
        p = plan_fn(lat, k, tiv=tiv, tiv_margin=tiv_margin,
                    time_limit_s=time_limit_s)
        cands.append((rank(p), p))
    return min(cands, key=lambda t: t[0])[1]


# ---------------------------------------------------------------------------
# registry wiring: every grouping strategy is addressable by name with the
# uniform planner contract fn(lat, k, *, tiv, tiv_margin, time_limit_s, rng)
# ---------------------------------------------------------------------------


_strategies.register(
    "planner", "milp",
    lambda lat, k, *, tiv=False, tiv_margin=0.05, time_limit_s=5.0, rng=None:
        milp_grouping(lat, k, tiv=tiv, tiv_margin=tiv_margin,
                      time_limit_s=time_limit_s),
)
_strategies.register(
    "planner", "kcenter",
    lambda lat, k, *, tiv=False, tiv_margin=0.05, time_limit_s=5.0, rng=None:
        kcenter_grouping(lat, k, tiv=tiv, tiv_margin=tiv_margin),
)
_strategies.register(
    "planner", "agglomerative",
    lambda lat, k, *, tiv=False, tiv_margin=0.05, time_limit_s=5.0, rng=None:
        agglomerative_grouping(lat, k),
)
_strategies.register(
    "planner", "kmeans",
    lambda lat, k, *, tiv=False, tiv_margin=0.05, time_limit_s=5.0, rng=None:
        kmeans_grouping(lat, k, rng),
)
_strategies.register(
    "planner", "random",
    lambda lat, k, *, tiv=False, tiv_margin=0.05, time_limit_s=5.0, rng=None:
        random_grouping(lat, k, rng),
)
_strategies.register(
    "planner", "none",
    lambda lat, k=0, **_kw: no_grouping(lat),
)

# ---------------------------------------------------------------------------
# Damped replanner (Sec 4.2 "Re-group damping strategy")
# ---------------------------------------------------------------------------


class Replanner:
    """Holds the current plan; regroups only on sustained latency deviation.

    A new plan is computed when the mean relative deviation of the observed
    latency matrix from the matrix used at planning time exceeds
    ``threshold`` (default 20%) for at least ``sustain`` consecutive
    observations — transient RTT noise is suppressed.

    **Force contract**: a forced replan request without a latency matrix
    (:meth:`force` with no argument, or :meth:`on_node_failure`) only sets a
    flag — the replan happens at the *next* :meth:`observe`, because there
    is nothing to plan against until a matrix arrives.  Event-driven callers
    that need the plan to react *immediately* (e.g.
    ``repro_torch.control.ControlPlane.force_replan`` on a sustained-deviation or
    straggler signal) pass the last observed matrix to :meth:`force`, which
    replans before returning.
    """

    def __init__(
        self,
        plan_fn: Callable[[np.ndarray], GroupPlan],
        *,
        threshold: float = 0.20,
        sustain: int = 3,
    ):
        self.plan_fn = plan_fn
        self.threshold = threshold
        self.sustain = sustain
        self._plan: GroupPlan | None = None
        self._plan_lat: np.ndarray | None = None
        self._over = 0
        self._force = False
        self.replan_count = 0

    @property
    def plan(self) -> GroupPlan | None:
        return self._plan

    def deviation(self, lat: np.ndarray) -> float:
        if self._plan_lat is None:
            return float("inf")
        base = self._plan_lat
        mask = base > 0
        return float(np.abs(lat[mask] - base[mask]).mean() / base[mask].mean())

    def observe(self, lat: np.ndarray) -> GroupPlan:
        """Feed a fresh latency matrix; returns the (possibly updated) plan."""
        if self._plan is None or self._force:
            return self._replan(lat)
        if self.deviation(lat) > self.threshold:
            self._over += 1
            if self._over >= self.sustain:
                return self._replan(lat)
        else:
            self._over = 0
        return self._plan

    def _replan(self, lat: np.ndarray) -> GroupPlan:
        self._plan = self.plan_fn(lat)
        self._plan_lat = lat.copy()
        self._over = 0
        self._force = False
        self.replan_count += 1
        return self._plan

    def force(self, lat: np.ndarray | None = None) -> GroupPlan | None:
        """Request a replan.

        With ``lat`` the replan happens **immediately** and the new plan is
        returned; without it only a flag is set and the replan fires at the
        next :meth:`observe` (see the class docstring's force contract).
        """
        if lat is not None:
            return self._replan(lat)
        self._force = True
        return None

    def on_node_failure(self, node: int) -> GroupPlan | None:
        """Aggregator/member failover (Sec 4.4): drop the node immediately;
        the full replan happens at the next observation (the no-matrix arm
        of the force contract)."""
        if self._plan is None:
            return None
        self._plan = self._plan.drop_node(node)
        self.force()  # full regroup at next observe()
        return self._plan
