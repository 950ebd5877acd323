"""Transmission schedules (paper Sec 4.4: Consistency-Guaranteed Transmission);
the port's own copy of ``repro.core.schedule``, host numpy.

A :class:`TransmissionSchedule` is a dependency-tracked *transfer DAG*: each
:class:`Transfer` carries the indices of the transfers it must wait for
(aggregator exchanges depend on the member gathers they consolidate, scatters
depend on the exchanges that deliver the remote group payloads).  The
event-driven :class:`~repro_torch.core.simulator.WANSimulator` starts every transfer
the moment its dependencies have been delivered, so rounds pipeline across
what used to be barrier phases.

``phases`` is retained as a **derived compatibility view**: builders record
the positional phase each transfer would have occupied in the pre-DAG
barrier schedule, and ``WANSimulator(barrier=True)`` executes that view with
the original phase-sum semantics — bit-identical to the pre-refactor
simulator.  Schedules constructed from an explicit list of phases (the
legacy constructor form ``TransmissionSchedule([[t, ...], ...])``) get full
barrier dependency edges, so they behave identically under both engines up
to intra-phase overlap.

Builders:

* :func:`all_to_all_schedule` — the flat baseline: ``n(n-1)`` point-to-point
  transfers, no dependencies (one phase).
* :func:`hierarchical_schedule` — GeoCoCo's 3-stage flow: members->aggregator,
  aggregator<->aggregator (optionally over TIV relay paths), aggregator->
  members, with real dependency edges between the stages.
* :func:`leader_schedule` — single-leader (Raft-ish) dissemination, used by the
  CockroachDB-plane model; each relay hop depends on its inbound append.

Per-node message-count accounting backs the paper's round guarantee
(Eq. 6-7): ``C_geococo <= C_baseline = 2(N-1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from . import strategies as _strategies
from .latency import one_relay_effective
from .planner import GroupPlan

__all__ = [
    "Transfer",
    "TransmissionSchedule",
    "all_to_all_schedule",
    "hierarchical_schedule",
    "leader_schedule",
    "stitch_schedules",
    "StitchState",
    "messages_per_node",
    "max_messages_per_node",
]


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One point-to-point payload movement in the transfer DAG.

    ``via >= 0`` marks an application-layer relay (overlay TIV exploitation):
    the simulator executes two chained hops — the second hop starts only when
    the first hop has been delivered at the relay — charging both hops'
    propagation and (contended) serialization, and the relay node's message
    counters are charged one receive + one send.

    ``deps`` are indices into the owning schedule's ``transfers`` list: this
    transfer may start only after every listed transfer has been *delivered*
    (propagation included).  ``compute_ms`` is a CPU stage paid at the source
    after the dependencies are met and before the wire — the pipelined
    replication engine uses it to model per-group filter/compression time
    that overlaps other groups' in-flight WAN transfers.

    ``src == dst`` marks a **local compute stage** (no wire, no NIC, no
    byte/message accounting): the streaming multi-epoch engine models
    per-node transaction execution and the epoch cadence clock this way.

    ``epoch`` tags the transfer's position in a stitched multi-epoch
    schedule (see :func:`stitch_schedules`); the event simulator resolves
    per-epoch propagation from it when given a latency-matrix stack.
    """

    src: int
    dst: int
    nbytes: float
    via: int = -1
    tag: str = ""
    deps: tuple[int, ...] = ()
    compute_ms: float = 0.0
    epoch: int = 0


@dataclasses.dataclass
class TransmissionSchedule:
    """A DAG of transfers with a derived barrier-phase compatibility view.

    ``transfers`` is topologically ordered (every dependency index points at
    an earlier transfer).  Construction accepts either the canonical flat
    list or the legacy nested list-of-phases form; the legacy form installs
    full barrier edges (every transfer of phase ``p`` depends on all of
    phase ``p-1``), preserving the original semantics for external callers.

    ``phase_of[i]`` records transfer i's positional phase for the barrier
    view.  Builders pass it explicitly so ``phases`` reproduces the pre-DAG
    phase layout exactly; when absent it is derived from ASAP dependency
    levels (``level = 1 + max(level[dep])``).
    """

    transfers: list[Transfer]
    label: str = ""
    phase_of: tuple[int, ...] | None = None

    def __post_init__(self):
        ts = self.transfers
        if ts and isinstance(ts[0], (list, tuple)):
            # legacy phases form: flatten + barrier dependency edges
            flat: list[Transfer] = []
            phase_of: list[int] = []
            prev: tuple[int, ...] = ()
            for p, phase in enumerate(ts):
                cur = []
                for t in phase:
                    if prev and not t.deps:
                        t = dataclasses.replace(t, deps=prev)
                    cur.append(len(flat))
                    flat.append(t)
                    phase_of.append(p)
                if cur:  # empty phases don't break the barrier chain
                    prev = tuple(cur)
            self.transfers = flat
            self.phase_of = tuple(phase_of)
        elif self.phase_of is not None:
            self.phase_of = tuple(self.phase_of)
        for i, t in enumerate(self.transfers):
            for d in t.deps:
                if not (0 <= d < i):
                    raise ValueError(
                        f"transfer {i} depends on {d}: dependencies must "
                        "reference earlier transfers (topological order)"
                    )
        if self.phase_of is not None and len(self.phase_of) != len(self.transfers):
            raise ValueError("phase_of must have one entry per transfer")

    # -- DAG accessors -------------------------------------------------------

    def verify(self, *, n_nodes: int | None = None):
        """The reference's static DAG verifier
        (``analysis/schedule_check.py``), not ported yet: raises."""
        raise NotImplementedError(
            "schedule verification is not ported yet (ROADMAP §1, W7: "
            "analysis/schedule_check.py)"
        )

    @property
    def n_transfers(self) -> int:
        return len(self.transfers)

    @property
    def total_bytes(self) -> float:
        # relayed transfers traverse two WAN hops
        return float(
            sum(t.nbytes * (2.0 if t.via >= 0 else 1.0) for t in self.transfers)
        )

    def all_transfers(self) -> Iterable[Transfer]:
        yield from self.transfers

    def dep_levels(self) -> list[int]:
        """ASAP topological level of each transfer (0 = no dependencies)."""
        levels: list[int] = []
        for t in self.transfers:
            levels.append(1 + max((levels[d] for d in t.deps), default=-1))
        return levels

    # -- derived barrier-phase compatibility view ----------------------------

    def phase_indices(self) -> list[list[int]]:
        """Transfer indices per barrier phase (the ``phases`` view, but by
        position — aliased Transfer objects stay distinguishable)."""
        ranks = list(self.phase_of) if self.phase_of is not None \
            else self.dep_levels()
        n_phases = max(ranks, default=-1) + 1
        out: list[list[int]] = [[] for _ in range(n_phases)]
        for i, r in enumerate(ranks):
            out[r].append(i)
        return out

    @property
    def phases(self) -> list[list[Transfer]]:
        """Barrier-phase view: builder-recorded positional phases when
        available, ASAP dependency levels otherwise.  This is what
        ``WANSimulator(barrier=True)`` executes — for builder-emitted
        schedules it is exactly the pre-DAG phase layout."""
        return [[self.transfers[i] for i in p] for p in self.phase_indices()]


def all_to_all_schedule(
    n: int, payload_bytes: np.ndarray | float, *, label: str = "all_to_all"
) -> TransmissionSchedule:
    """Flat baseline: every node sends its update batch to every other node.

    ``payload_bytes`` is a scalar or per-source vector (node i's batch size).
    No dependencies — the flat round is one fully-concurrent wave.
    """
    pay = np.broadcast_to(np.asarray(payload_bytes, dtype=float), (n,))
    transfers = [
        Transfer(i, j, float(pay[i]), tag="a2a")
        for i in range(n)
        for j in range(n)
        if i != j
    ]
    return TransmissionSchedule(
        transfers, label=label, phase_of=(0,) * len(transfers)
    )


def hierarchical_schedule(
    plan: GroupPlan,
    payload_bytes: np.ndarray | float,
    *,
    group_payload_bytes: np.ndarray | None = None,
    group_compute_ms: np.ndarray | None = None,
    lat: np.ndarray | None = None,
    tiv: bool = False,
    tiv_margin: float = 0.05,
    label: str = "geococo",
) -> TransmissionSchedule:
    """GeoCoCo's hierarchical round (Fig. 8) as a dependency DAG.

    Stage 1 (intra, gather):   each simple node -> its aggregator.  No deps.
    Stage 2 (inter, exchange): each aggregator -> every other aggregator, with
        the *consolidated group payload* (post filtering/aggregation).  Each
        exchange depends on the gathers into its own source aggregator — a
        group whose members arrive early exchanges early, overlapping slower
        groups' gathers.  When ``tiv`` and ``lat`` are given, pairs with a
        profitable one-relay path are routed ``via`` that relay (Sec 5
        overlay implementation).
    Stage 3 (intra, scatter):  each aggregator -> its simple nodes with the
        merged global result.  Each scatter depends on every exchange *into*
        its aggregator plus the aggregator's own gathers (the merged state
        needs the local contributions too).

    ``group_payload_bytes[j]``, if given, is group j's post-filter consolidated
    payload; by default it is the sum of member payloads (no filtering, no
    dedup).  ``group_compute_ms[j]``, if given, is group j's aggregator-side
    CPU time (filter/compress) charged on that group's exchange transfers
    before they hit the wire — the pipelined engine's overlap model.  The
    stage-3 broadcast payload is the merged global state delta: the sum of
    all group payloads (every member must receive every surviving remote
    update, matching full replication).
    """
    # node ids need not be contiguous (e.g. after a drop_node failover)
    n = max(i for g in plan.groups for i in g) + 1
    pay = np.broadcast_to(np.asarray(payload_bytes, dtype=float), (n,))
    if group_payload_bytes is None:
        gp = np.array([sum(pay[i] for i in g) for g in plan.groups])
    else:
        gp = np.asarray(group_payload_bytes, dtype=float)
        if gp.shape != (plan.k,):
            raise ValueError(f"group_payload_bytes must have shape ({plan.k},)")
    gc = np.zeros(plan.k)
    if group_compute_ms is not None:
        gc = np.asarray(group_compute_ms, dtype=float)
        if gc.shape != (plan.k,):
            raise ValueError(f"group_compute_ms must have shape ({plan.k},)")

    relay = None
    if tiv and lat is not None:
        _, relay = one_relay_effective(lat, margin=tiv_margin)

    transfers: list[Transfer] = []
    ranks: list[int] = []
    gathers_into: dict[int, list[int]] = {}  # aggregator -> gather indices
    for g, a in zip(plan.groups, plan.aggregators):
        for i in g:
            if i != a:
                gathers_into.setdefault(a, []).append(len(transfers))
                transfers.append(Transfer(i, a, float(pay[i]), tag="gather"))
                ranks.append(0)
    has_gathers = bool(gathers_into)

    exchanges_into: dict[int, list[int]] = {}  # aggregator -> exchange indices
    for j1, a1 in enumerate(plan.aggregators):
        deps = tuple(gathers_into.get(a1, ()))
        for j2, a2 in enumerate(plan.aggregators):
            if j1 == j2:
                continue
            via = -1
            if relay is not None:
                via = int(relay[a1, a2])
            exchanges_into.setdefault(a2, []).append(len(transfers))
            transfers.append(Transfer(
                a1, a2, float(gp[j1]), via=via, tag="exchange",
                deps=deps, compute_ms=float(gc[j1]),
            ))
            ranks.append(1 if has_gathers else 0)
    has_exchanges = plan.k > 1

    total = float(gp.sum())
    for g, a in zip(plan.groups, plan.aggregators):
        deps = tuple(exchanges_into.get(a, ())) + tuple(gathers_into.get(a, ()))
        # members receive the merged result minus what they already hold
        # locally (their own contribution stayed local): charge total - pay[i].
        for i in g:
            if i != a:
                transfers.append(Transfer(
                    a, i, max(total - float(pay[i]), 0.0), tag="scatter",
                    deps=deps,
                ))
                ranks.append((1 if has_gathers else 0) + (1 if has_exchanges else 0))
    return TransmissionSchedule(transfers, label=label, phase_of=tuple(ranks))


def leader_schedule(
    n: int,
    leader: int,
    payload_bytes: float,
    plan: GroupPlan | None = None,
    *,
    label: str = "leader",
) -> TransmissionSchedule:
    """Single-leader replication (CRDB/Raft plane).

    Without a plan: leader -> each follower directly (flat AppendEntries
    fan-out).  With a plan: leader -> each group aggregator -> group members
    (GeoCoCo hooked into RaftTransport, Sec 5 "Extensions"); each second-hop
    relay depends only on its own inbound append — a nearby aggregator starts
    relaying while a distant one is still receiving.
    """
    if plan is None:
        transfers = [
            Transfer(leader, i, payload_bytes, tag="append")
            for i in range(n)
            if i != leader
        ]
        return TransmissionSchedule(
            transfers, label=label, phase_of=(0,) * len(transfers)
        )
    transfers: list[Transfer] = []
    ranks: list[int] = []
    relays: list[tuple[int, int, tuple[int, ...]]] = []
    for g, a in zip(plan.groups, plan.aggregators):
        tgt = a if leader not in g else leader
        deps: tuple[int, ...] = ()
        if tgt != leader:
            deps = (len(transfers),)
            transfers.append(Transfer(leader, tgt, payload_bytes, tag="append"))
            ranks.append(0)
        for i in g:
            if i != tgt and i != leader:
                relays.append((tgt, i, deps))
    has_appends = bool(transfers)
    for tgt, i, deps in relays:
        transfers.append(Transfer(tgt, i, payload_bytes, tag="relay", deps=deps))
        ranks.append(1 if has_appends else 0)
    return TransmissionSchedule(
        transfers, label=label + "+geococo", phase_of=tuple(ranks)
    )


# ---------------------------------------------------------------------------
# Cross-epoch streaming (GeoGauss-style pipelining of consecutive rounds)
# ---------------------------------------------------------------------------


def stitch_schedules(
    rounds: Sequence[TransmissionSchedule],
    *,
    node_exec_ms: Sequence[Sequence[float]] | None = None,
    epoch_ms: float = 0.0,
    n: int | None = None,
    label: str = "stream",
) -> TransmissionSchedule:
    """Stitch consecutive epochs' DAGs into one streaming schedule.

    The key property (the GeoGauss streaming model, paper Sec 2.1): epoch
    ``e+1``'s transfers out of node ``s`` depend only on **node s's epoch-e
    commit** — the delivery of every epoch-e transfer *into s* — never on a
    global epoch sink.  A node whose scatter arrived early executes and
    gathers epoch ``e+1`` while other nodes' epoch-e scatters are still in
    flight, so consecutive WAN rounds pipeline.

    Per epoch ``k`` the stitched DAG gains two kinds of local compute stages
    (``src == dst`` transfers — no wire, no accounting):

    * a ``clock`` chain (when ``epoch_ms > 0``): epoch ``k``'s execution
      cannot start before ``k * epoch_ms`` — transactions arrive at the
      epoch cadence, not earlier;
    * one ``exec`` stage per node: ``compute_ms = node_exec_ms[k][i]`` —
      node i's local transaction execution for epoch ``k``, after its
      epoch-``k-1`` commit and its own epoch-``k-1`` exec stage (a node
      executes epochs serially).  Every epoch-``k`` wire transfer with
      source ``i`` depends on it.

    Admission ranks (``phase_of``) are offset per epoch, so the event
    engine's bandwidth admission keeps epoch ``e+1`` exchanges from starving
    epoch-e scatters on a shared NIC while leaving the gather/scatter
    overlap intact (gathers ride member->aggregator NIC directions that
    scatters never touch).  A corollary of admission: an earlier epoch's
    measured times are final the moment that epoch is stitched — later
    epochs' flows can never slow them — which is what lets the
    staleness-feedback OCC loop re-simulate the stitched *prefix* as epochs
    append and trust the per-node commit times it already consumed
    (:func:`~repro_torch.core.simulator.node_commit_ms` extracts exactly the
    per-node commit dependency set this builder gates sends on).

    Beyond the replication engine, ``RaftCluster.pipelined_commit_ms``
    stitches ``batches_in_flight`` copies of a ``leader_schedule``
    (``epoch_ms=0``: no cadence clock) so in-flight Raft batches serialize
    on the leader's NIC instead of replicating for free.
    """
    if n is None:
        n = 0
        for sk in rounds:
            for t in sk.transfers:
                n = max(n, t.src + 1, t.dst + 1, t.via + 1)
        if node_exec_ms is not None:
            for row in node_exec_ms:
                n = max(n, len(row))
    if n <= 0:
        raise ValueError("cannot infer node count from empty schedules")

    st = StitchState(n, epoch_ms=epoch_ms)
    flat: list[Transfer] = []
    ranks: list[int] = []
    for k, sk in enumerate(rounds):
        row = node_exec_ms[k] if node_exec_ms is not None else None
        seg, seg_ranks = st.append(sk, row)
        flat.extend(seg)
        ranks.extend(seg_ranks)
    return TransmissionSchedule(flat, label=label, phase_of=tuple(ranks))


class StitchState:
    """The per-epoch step of :func:`stitch_schedules`, factored out so the
    incremental timeline (:class:`repro_torch.core.stream.StreamingTimeline`) and
    the one-shot stitcher build *the same* stream structure by construction.

    Owns the cross-epoch frontier: per-node inbound commit indices
    (``prev_commit``), per-node exec-stage indices (``prev_exec``), the
    cadence clock-chain tail (``prev_clock``) and the running admission
    rank offset (``rank_base``).  Every :meth:`append` emits one epoch's
    stitched segment — transfers whose dependency indices are **global**
    (into the concatenated stream) and their admission ranks — and advances
    the frontier.  Concatenating the segments of ``k`` appends is exactly
    ``stitch_schedules(rounds[:k])``.
    """

    def __init__(self, n: int, *, epoch_ms: float = 0.0):
        if n <= 0:
            raise ValueError("node count must be positive")
        self.n = n
        self.epoch_ms = float(epoch_ms)
        self.epoch = 0                      # next epoch to be appended
        self.size = 0                       # transfers emitted so far
        self.rank_base = 0
        self.prev_commit: dict[int, list[int]] = {i: [] for i in range(n)}
        self.prev_exec: dict[int, int] = {}
        self.prev_clock: int | None = None

    def frontier(self) -> list[int]:
        """Global indices a future epoch's dependencies may reference: the
        last epoch's per-node commit transfers, exec stages and clock tail.
        Everything earlier is unreachable from appended epochs — the
        timeline evicts its finish-time state down to this set."""
        out: list[int] = []
        if self.prev_clock is not None:
            out.append(self.prev_clock)
        out.extend(self.prev_exec.values())
        for lst in self.prev_commit.values():
            out.extend(lst)
        return out

    def append(
        self, sk: TransmissionSchedule,
        node_exec_row: Sequence[float] | None = None,
    ) -> tuple[list[Transfer], list[int]]:
        k = self.epoch
        base = self.size
        seg: list[Transfer] = []
        ranks: list[int] = []
        if self.epoch_ms > 0.0 and k >= 1:
            clock_deps = () if self.prev_clock is None else (self.prev_clock,)
            self.prev_clock = base + len(seg)
            seg.append(Transfer(0, 0, 0.0, tag="clock", deps=clock_deps,
                                compute_ms=self.epoch_ms, epoch=k))
            ranks.append(self.rank_base)
        exec_idx: dict[int, int] = {}
        for i in range(self.n):
            deps: list[int] = []
            if self.prev_clock is not None:
                deps.append(self.prev_clock)
            if i in self.prev_exec:
                deps.append(self.prev_exec[i])
            deps.extend(self.prev_commit[i])
            cms = 0.0
            if node_exec_row is not None and i < len(node_exec_row):
                cms = float(node_exec_row[i])
            exec_idx[i] = base + len(seg)
            seg.append(Transfer(i, i, 0.0, tag="exec", deps=tuple(deps),
                                compute_ms=cms, epoch=k))
            ranks.append(self.rank_base + 1)
        off = base + len(seg)
        rk = list(sk.phase_of) if sk.phase_of is not None else sk.dep_levels()
        commit: dict[int, list[int]] = {i: [] for i in range(self.n)}
        for j, t in enumerate(sk.transfers):
            deps_t = tuple(d + off for d in t.deps) + (exec_idx[t.src],)
            if t.src != t.dst:
                commit[t.dst].append(base + len(seg))
            seg.append(dataclasses.replace(t, deps=deps_t, epoch=k))
            ranks.append(self.rank_base + 2 + rk[j])
        self.prev_commit = commit
        self.prev_exec = exec_idx
        self.rank_base += 2 + (max(rk) + 1 if rk else 0)
        self.size += len(seg)
        self.epoch += 1
        return seg, ranks


# registry wiring: transmission-schedule builders are addressable by name so
# the engine (and future planes: Raft, multi-cloud) resolve them uniformly
_strategies.register("schedule", "all_to_all", all_to_all_schedule)
_strategies.register("schedule", "hierarchical", hierarchical_schedule)
_strategies.register("schedule", "leader", leader_schedule)


# ---------------------------------------------------------------------------
# Round-count accounting (Eq. 6-7)
# ---------------------------------------------------------------------------


def messages_per_node(schedule: TransmissionSchedule, n: int) -> np.ndarray:
    """Total messages (sends + receives, relays counted) per node.  Local
    compute stages (``src == dst``) put nothing on the wire."""
    cnt = np.zeros(n, dtype=int)
    for t in schedule.all_transfers():
        if t.src == t.dst:
            continue
        cnt[t.src] += 1
        cnt[t.dst] += 1
        if t.via >= 0:
            cnt[t.via] += 2  # relay receives and forwards
    return cnt


def max_messages_per_node(schedule: TransmissionSchedule, n: int) -> int:
    return int(messages_per_node(schedule, n).max())
