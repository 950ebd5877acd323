"""Trace-driven WAN simulator (paper Sec 6.1, "Trace-driven Simulation"); the
port's own copy of ``repro.core.simulator``, host numpy.

Executes a :class:`~repro_torch.core.schedule.TransmissionSchedule` against latency
and bandwidth matrices (optionally with packet loss and retransmission
timeouts), producing the round *makespan*, per-node/per-link byte counters
and per-pair message-frequency matrices — the raw measurements behind the
paper's Figs. 9, 10, 13, 14, 16 and 17.

Two execution engines over the same wire model:

* **event-driven** (default): a fluid-flow event-queue simulation of the
  transfer DAG.  Each transfer starts the moment its dependencies have been
  delivered (plus its ``compute_ms`` CPU stage); NIC contention is computed
  from the set of flows *actually moving bytes concurrently in time* — a
  node's access link is shared equally among its live flows, and rates are
  re-solved at every flow start/finish.  Relayed transfers (``via >= 0``)
  run as two chained hops (store-and-forward: the second hop starts at the
  first hop's delivery).  The makespan is the DAG critical path, which the
  :class:`RoundResult` exposes via per-transfer start/finish times and a
  backtracked critical-path trace.

  The engine is *lazy per flow*: a flow's byte integration is materialized
  only at events on its own two directed NICs (its src out-NIC and dst
  in-NIC), and finishes are projected drain events invalidated by a token
  when the NIC population changes.  Events elsewhere in the DAG never touch
  the flow's floating-point state, so a flow's measured times are a pure
  function of its NIC-local event history.  That locality is what makes
  **incremental simulation exact**: under bandwidth admission a later
  epoch's flows never share a NIC in time with an earlier epoch's, so
  :meth:`WANSimulator.simulate_segment` can replay one appended epoch
  against carried :class:`NicState` floors and reproduce the full
  re-simulation's times byte-for-byte
  (:class:`repro_torch.core.stream.StreamingTimeline` builds on this).

  **Bandwidth admission** (``admission=True``, the default): a ready hop is
  *deferred* while either of its NICs still carries undrained flows of a
  strictly earlier phase rank — a later-phase exchange/scatter can never
  steal NIC bandwidth from an earlier phase's still-running gathers.  With
  admission, at any instant the byte-moving flows on a directed NIC all
  share one phase rank and never outnumber that phase's static degree, so
  every flow runs at least as fast as its barrier-static estimate and
  ``event <= barrier`` is a *theorem* for any schedule whose dependencies
  point at strictly earlier phases (all builders; property-tested in
  ``tests/test_property_dag.py``).  ``admission=False`` restores the
  greedy ASAP start, which on adversarial matrices (severely
  bandwidth-starved links) can exceed the barrier phase-sum.

Transfers with ``src == dst`` are **local compute stages** (the streaming
multi-epoch engine's per-node execution stages): they occupy no NIC, move
no bytes, take ``compute_ms`` after their dependencies, and are excluded
from byte/message accounting in both engines.

For stitched multi-epoch schedules (:func:`~repro_torch.core.schedule.stitch_schedules`)
the event engine accepts ``run(schedule, lats=[lat_0, lat_1, ...])``: each
transfer's propagation is taken from its epoch's latency matrix (the trace
the replication engine iterates), while bandwidth/loss stay constructor-
fixed.  The barrier engine rejects latency stacks — cross-epoch streaming
has no barrier-phase semantics.

* **barrier** (``barrier=True``): the pre-DAG semantics, kept for regression
  comparison.  Phases (the schedule's derived compatibility view) are
  barrier-synchronized; within a phase each flow is charged the phase-static
  contention factor ``max(out_degree(src), in_degree(dst))``, and the round
  makespan is the *sum of the phase maxima* (the paper's Eq. 1 objective
  generalized to include transmission time).  This reproduces the
  pre-refactor phase-sum numbers exactly.

Transfer-time model (one hop of ``B`` bytes over link (s, d)):

    t = propagation(s, d) + B * 8 * c / bandwidth(s, d)        [ms]

where ``c`` is the access-link contention factor (phase-static degrees under
``barrier``; the time-varying live-flow count under the event engine).  This
is what makes the flat all-to-all expensive in practice (every node carries
n-1 concurrent flows) and aggregation cheap (degree <= group size) — the
economics behind the paper's Fig. 3 and Sec 2.2.

Propagation is inflated by expected retransmissions under loss ``p``
(geometric retries, each costing timeout ``tau``):

    t += (p / (1 - p)) * tau
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from .schedule import Transfer, TransmissionSchedule

__all__ = [
    "EpochLatencyCycle",
    "NicState",
    "RoundResult",
    "WANSimulator",
    "epoch_commit_row",
    "node_commit_ms",
]


class EpochLatencyCycle:
    """Per-epoch latency matrices as a cyclic view over a trace.

    The replication engine's epoch ``e`` always uses ``trace[e % len(trace)]``,
    so a run's per-epoch latency "stack" is fully determined by the trace
    plus the horizon — materializing ``[trace[e % p] for e in range(E)]``
    (E full matrices) is pure duplication.  This sequence indexes the trace
    lazily instead; ``len()`` is the horizon, ``[k]`` the epoch's matrix.
    Consumers that index with ``lats[min(e, len(lats) - 1)]`` (the event
    engine, the serve plane) see exactly the matrices the materialized
    list held.
    """

    def __init__(self, trace: Sequence[np.ndarray], n_epochs: int):
        self._stack = [np.asarray(l, dtype=float) for l in trace]
        if not self._stack:
            raise ValueError("EpochLatencyCycle requires a non-empty trace")
        self._n = int(n_epochs)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, k: int) -> np.ndarray:
        k = int(k)
        if k < 0 or k >= self._n:
            raise IndexError(f"epoch {k} out of range [0, {self._n})")
        return self._stack[k % len(self._stack)]


@dataclasses.dataclass
class NicState:
    """Per-directed-NIC admission floors carried across appended segments.

    ``clear_out[i]`` / ``clear_in[i]`` is the last drain time of any
    byte-moving hop on node ``i``'s out-/in-NIC so far.  Under bandwidth
    admission every hop of a later segment has a strictly higher rank than
    everything already streamed, so it may not occupy either of its NICs
    before these floors — exactly when the full re-simulation's ``min_out``
    / ``min_in`` would have advanced past the earlier epochs' ranks.
    """

    clear_out: np.ndarray
    clear_in: np.ndarray

    @classmethod
    def zeros(cls, n: int) -> "NicState":
        return cls(np.zeros(n), np.zeros(n))


@dataclasses.dataclass
class RoundResult:
    makespan_ms: float
    phase_ms: list[float]
    bytes_out: np.ndarray          # per node, WAN egress (matches NIC counters, Sec 6.1)
    bytes_in: np.ndarray
    msg_matrix: np.ndarray         # (n, n) message counts, src -> dst
    link_bytes: np.ndarray         # (n, n) bytes moved per directed link
    n_transfers: int
    start_ms: np.ndarray | None = None    # per transfer: wire start (post-compute)
    finish_ms: np.ndarray | None = None   # per transfer: delivery at dst
    critical_path: list[int] = dataclasses.field(default_factory=list)

    @property
    def total_bytes(self) -> float:
        return float(self.link_bytes.sum())

    @property
    def critical_path_ms(self) -> float:
        """Alias for the makespan — under the event engine this is the DAG
        critical path, under ``barrier`` the phase-sum."""
        return self.makespan_ms


def epoch_commit_row(
    transfers: Sequence[Transfer],
    finish_ms: np.ndarray,
    n: int,
) -> np.ndarray:
    """One epoch's *raw* per-node commit row: per node, the max delivery
    over the transfers it owns (``src`` for local compute stages, ``dst``
    for wire hops; cadence ``clock`` stages are unowned).  ``-inf`` marks a
    node silent in the epoch — callers fold rows with a cumulative max and
    map residual ``-inf`` to 0 (see :func:`node_commit_ms`).
    """
    row = np.full(n, -np.inf)
    for i, t in enumerate(transfers):
        if t.tag == "clock":
            continue  # cadence stage: not owned by a real node
        node = t.src if t.src == t.dst else t.dst
        f = float(finish_ms[i])
        if f > row[node]:
            row[node] = f
    return row


def node_commit_ms(
    schedule: TransmissionSchedule,
    result: RoundResult,
    n: int,
    n_epochs: int | None = None,
    *,
    start_epoch: int = 0,
    base_row: np.ndarray | None = None,
) -> np.ndarray:
    """Per-node, per-epoch commit times of a simulated (stitched) schedule.

    ``out[k, i]`` is the time node ``i`` commits epoch ``k``: the delivery of
    every epoch-``k`` transfer *into* ``i`` (the same dependency set
    :func:`~repro_torch.core.schedule.stitch_schedules` gates node ``i``'s
    epoch-``k+1`` sends on) joined with ``i``'s own epoch-``k`` local
    execution stage.  Nodes that neither receive nor execute in an epoch
    inherit their previous epoch's commit time (their view had nothing new
    to wait for).  This is the measured staleness signal the
    ``staleness_feedback`` OCC loop consumes: node ``i``'s snapshot view
    may advance to epoch ``k`` only at ``out[k, i]``.

    The windowed form computes only rows ``[start_epoch, n_epochs)``:
    ``base_row`` must then be the cumulative commit row of epoch
    ``start_epoch - 1`` (it seeds the running max, so the window is exactly
    the corresponding slice of the full matrix).  Omitting ``base_row``
    with ``start_epoch > 0`` drops the earlier epochs' history and is only
    meaningful when no node was silent across the whole window.
    """
    if n_epochs is None:
        n_epochs = max((t.epoch for t in schedule.transfers), default=-1) + 1
    rows = max(n_epochs - start_epoch, 0)
    out = np.full((rows, n), -np.inf)
    for idx, t in enumerate(schedule.transfers):
        if t.tag == "clock" or t.epoch < start_epoch or t.epoch >= n_epochs:
            continue  # cadence stage / outside the requested window
        node = t.src if t.src == t.dst else t.dst
        f = float(result.finish_ms[idx])
        if f > out[t.epoch - start_epoch, node]:
            out[t.epoch - start_epoch, node] = f
    if base_row is not None and rows:
        np.maximum(out[0], np.asarray(base_row, dtype=float), out=out[0])
    # a node silent in epoch k committed it the moment it committed k-1
    out = np.maximum.accumulate(out, axis=0)
    out[~np.isfinite(out)] = 0.0
    return out


class WANSimulator:
    """Simulates schedule execution over a given network state.

    ``barrier=True`` selects the legacy phase-sum engine (exact pre-DAG
    numbers); the default runs the event-driven DAG engine.  Byte, message
    and link accounting are identical across both engines — only timing
    differs — so consistency checks (digests, WAN-byte counters) are
    engine-independent.  ``admission=False`` disables the event engine's
    bandwidth-admission heuristic (greedy ASAP starts, the pre-fix
    behavior — kept for the adversarial regression tests and ablation).
    ``verify=True`` statically verifies every schedule before executing it
    (:func:`repro_torch.analysis.schedule_check.verify_schedule` — acyclicity,
    phase monotonicity along deps, clock-chain linearity, ...).
    """

    def __init__(
        self,
        latency_ms: np.ndarray,
        bandwidth_mbps: np.ndarray | float = np.inf,
        *,
        loss: np.ndarray | float = 0.0,
        retx_timeout_ms: float = 200.0,
        rng: np.random.Generator | None = None,
        stochastic_loss: bool = False,
        barrier: bool = False,
        admission: bool = True,
        verify: bool = False,
    ):
        self.lat = np.asarray(latency_ms, dtype=float)
        n = self.lat.shape[0]
        self.n = n
        bw = np.asarray(bandwidth_mbps, dtype=float)
        self.bw = np.broadcast_to(bw, (n, n)).copy() if bw.ndim < 2 else bw.copy()
        self.loss = np.broadcast_to(np.asarray(loss, dtype=float), (n, n))
        self.retx_timeout_ms = retx_timeout_ms
        self.rng = rng or np.random.default_rng(0)
        self.stochastic_loss = stochastic_loss
        self.barrier = barrier
        self.admission = admission
        self.verify = verify

    # -- single-hop cost -----------------------------------------------------

    def _prop_ms(self, s: int, d: int, lat: np.ndarray | None = None) -> float:
        prop = (self.lat if lat is None else lat)[s, d]
        p = float(self.loss[s, d])
        if p > 0.0:
            if self.stochastic_loss:
                retries = self.rng.geometric(1.0 - p) - 1
                prop += retries * self.retx_timeout_ms
            else:
                prop += (p / (1.0 - p)) * self.retx_timeout_ms
        return float(prop)

    def _hop_time(self, s: int, d: int, nbytes: float,
                  contention: float = 1.0) -> float:
        prop = self._prop_ms(s, d)
        bw = self.bw[s, d]
        tx = (
            0.0
            if not np.isfinite(bw)
            else nbytes * 8.0 * contention / (bw * 1e6) * 1e3
        )
        return prop + tx

    def transfer_time_ms(self, t: Transfer, out_deg=None, in_deg=None) -> float:
        def c(s, d):
            if out_deg is None:
                return 1.0
            return float(max(out_deg[s], in_deg[d], 1))

        if t.src == t.dst:
            return 0.0  # local compute stage: no wire (barrier ignores CPU)
        if t.via < 0:
            return self._hop_time(t.src, t.dst, t.nbytes, c(t.src, t.dst))
        return self._hop_time(
            t.src, t.via, t.nbytes, c(t.src, t.via)
        ) + self._hop_time(t.via, t.dst, t.nbytes, c(t.via, t.dst))

    # -- byte / message accounting (engine-independent) ------------------------

    def _account(self, schedule: TransmissionSchedule):
        n = self.n
        bytes_out = np.zeros(n)
        bytes_in = np.zeros(n)
        msg = np.zeros((n, n), dtype=int)
        link = np.zeros((n, n))
        for t in schedule.all_transfers():
            if t.src == t.dst:
                continue  # local compute stage: nothing on the wire
            if t.via < 0:
                bytes_out[t.src] += t.nbytes
                bytes_in[t.dst] += t.nbytes
                msg[t.src, t.dst] += 1
                link[t.src, t.dst] += t.nbytes
            else:
                bytes_out[t.src] += t.nbytes
                bytes_in[t.via] += t.nbytes
                bytes_out[t.via] += t.nbytes
                bytes_in[t.dst] += t.nbytes
                msg[t.src, t.via] += 1
                msg[t.via, t.dst] += 1
                link[t.src, t.via] += t.nbytes
                link[t.via, t.dst] += t.nbytes
        return bytes_out, bytes_in, msg, link

    # -- full round ----------------------------------------------------------

    def run(self, schedule: TransmissionSchedule,
            barrier: bool | None = None,
            lats: Sequence[np.ndarray] | None = None) -> RoundResult:
        """Execute the schedule.  ``lats`` (a per-epoch latency-matrix list
        for stitched multi-epoch schedules; each transfer's propagation is
        taken from ``lats[transfer.epoch]``) is event-engine only.

        With ``verify=True`` (the ``EngineConfig(verify_schedules=True)``
        debug hook) every schedule is statically verified first — an
        O(V+E) pass over the invariants both engines assume — and a
        :class:`~repro_torch.analysis.schedule_check.ScheduleVerificationError`
        (a ``ValueError``) is raised on any violation."""
        if self.verify:
            from ..analysis.schedule_check import (
                ScheduleVerificationError,
                verify_schedule,
            )

            violations = verify_schedule(schedule, n_nodes=self.n)
            if violations:
                raise ScheduleVerificationError(violations, schedule.label)
        if barrier if barrier is not None else self.barrier:
            if lats is not None:
                raise ValueError(
                    "per-epoch latency stacks require the event engine: "
                    "cross-epoch streaming has no barrier-phase semantics"
                )
            return self._run_barrier(schedule)
        return self._run_event(schedule, lats=lats)

    # -- barrier engine (pre-DAG phase-sum semantics) --------------------------

    def _phase_degrees(self, phase):
        """NIC contention degrees of one barrier phase: concurrent flows
        within the phase share each node's access link (phase-static)."""
        out_deg = np.zeros(self.n, dtype=int)
        in_deg = np.zeros(self.n, dtype=int)
        for t in phase:
            if t.src == t.dst:
                continue  # local compute stage: no NIC
            if t.via < 0:
                out_deg[t.src] += 1
                in_deg[t.dst] += 1
            else:
                out_deg[t.src] += 1
                in_deg[t.via] += 1
                out_deg[t.via] += 1
                in_deg[t.dst] += 1
        return out_deg, in_deg

    def barrier_makespan_ms(self, schedule: TransmissionSchedule) -> float:
        """Phase-sum makespan alone — no byte accounting, no per-transfer
        timeline.  The cheap serialized reference the pipelined replication
        engine reports its overlap split against every epoch."""
        total = 0.0
        for phase in schedule.phases:
            if not phase:
                continue
            out_deg, in_deg = self._phase_degrees(phase)
            total += max(
                self.transfer_time_ms(t, out_deg, in_deg) for t in phase
            )
        return total

    def _run_barrier(self, schedule: TransmissionSchedule) -> RoundResult:
        m = schedule.n_transfers
        start = np.zeros(m)
        finish = np.zeros(m)
        phase_ms: list[float] = []
        crit: list[int] = []
        t_base = 0.0
        for phase_idx in schedule.phase_indices():
            if not phase_idx:
                phase_ms.append(0.0)
                continue
            phase = [schedule.transfers[i] for i in phase_idx]
            out_deg, in_deg = self._phase_degrees(phase)
            tmax = 0.0
            tmax_idx = -1
            for i, t in zip(phase_idx, phase):
                tt = self.transfer_time_ms(t, out_deg, in_deg)
                start[i] = t_base
                finish[i] = t_base + tt
                if tt > tmax:
                    tmax, tmax_idx = tt, i
            phase_ms.append(tmax)
            if tmax_idx >= 0:
                crit.append(tmax_idx)
            t_base += tmax
        bytes_out, bytes_in, msg, link = self._account(schedule)
        return RoundResult(
            makespan_ms=float(sum(phase_ms)),
            phase_ms=phase_ms,
            bytes_out=bytes_out,
            bytes_in=bytes_in,
            msg_matrix=msg,
            link_bytes=link,
            n_transfers=m,
            start_ms=start,
            finish_ms=finish,
            critical_path=crit,
        )

    # -- event-driven engine (fluid-flow DAG simulation) -----------------------

    def _admission_ranks(self, schedule: TransmissionSchedule) -> np.ndarray:
        """Per-transfer admission rank: the builder-recorded positional phase,
        repaired to be strictly increasing along dependency edges (so a hop
        never waits on a rank that could wait back — admission cannot
        deadlock).  Falls back to ASAP dependency levels without phases."""
        base = schedule.phase_of
        rank = np.zeros(schedule.n_transfers, dtype=int)
        for i, t in enumerate(schedule.transfers):
            r = 0
            for d in t.deps:
                if rank[d] + 1 > r:
                    r = rank[d] + 1
            if base is not None and base[i] > r:
                r = int(base[i])
            rank[i] = r
        return rank

    def _simulate_dag(
        self,
        transfers: Sequence[Transfer],
        prop_fn,
        rank: np.ndarray | None,
        *,
        deps: Sequence[tuple[int, ...]] | None = None,
        ext_ready: Sequence[float] | None = None,
        nic: NicState | None = None,
        tid_base: int = 0,
    ):
        """Lazy per-flow event simulation of one transfer list.

        ``deps`` (default: each transfer's own ``deps``) must be local
        indices into ``transfers``; dependencies on transfers simulated
        earlier (a previous segment) are folded into ``ext_ready[i]`` — the
        earliest time transfer ``i``'s external dependencies allow it to
        become ready (its ``compute_ms`` is added on top, exactly as a live
        dependency's delivery would be).  ``nic`` carries the per-directed-
        NIC clear floors across segments and is updated in place.
        ``tid_base`` offsets the event keys so a segment's events tie-break
        identically to the same transfers inside a full stitched run —
        equal-time event order is part of the byte-identity contract.

        A flow's floating-point state (remaining bytes, current rate,
        last-materialization time) is touched only by events on its own two
        directed NICs; finishes are projected drain events invalidated by a
        per-flow token.  Returns ``(start, finish, pred)``.
        """
        m = len(transfers)
        if deps is None:
            deps = [t.deps for t in transfers]
        hops = [  # per transfer: the 1 or 2 (src, dst) wire hops
            [(t.src, t.dst)] if t.via < 0 else [(t.src, t.via), (t.via, t.dst)]
            for t in transfers
        ]
        indeg = [len(ds) for ds in deps]
        children: list[list[int]] = [[] for _ in range(m)]
        for i, ds in enumerate(deps):
            for d in ds:
                children[d].append(i)

        # bandwidth admission: register every byte-moving hop on its NICs up
        # front, bucketed by admission rank.  A ready hop starts only when no
        # *undrained* lower-rank hop shares its src out-NIC or dst in-NIC —
        # arrival order is irrelevant, so per NIC the live flows always share
        # one rank and never exceed that phase's static degree (the invariant
        # behind the event <= barrier theorem).  Ranks are rebased by the
        # segment minimum so an appended epoch's pend table stays O(segment).
        rankb: list[int] | None = None
        if rank is not None:
            rmin = int(rank.min()) if m else 0
            n_ranks = (int(rank.max()) - rmin + 1) if m else 1
            rankb = [int(r) - rmin for r in rank]
            pend_out = np.zeros((self.n, n_ranks), dtype=int)
            pend_in = np.zeros((self.n, n_ranks), dtype=int)
            for i, t in enumerate(transfers):
                if t.src == t.dst or t.nbytes <= 0.0:
                    continue
                for s, d in hops[i]:
                    if np.isfinite(self.bw[s, d]):
                        pend_out[s, rankb[i]] += 1
                        pend_in[d, rankb[i]] += 1
            # cached min pending rank per directed NIC (only ever advances:
            # all hops are registered up front and only drains decrement)
            min_out = np.zeros(self.n, dtype=int)
            min_in = np.zeros(self.n, dtype=int)

            def _advance(pend, mins, node):
                while mins[node] < n_ranks and pend[node, mins[node]] == 0:
                    mins[node] += 1

            for node in range(self.n):
                _advance(pend_out, min_out, node)
                _advance(pend_in, min_in, node)

        parked: list[tuple[int, int]] = []  # hops deferred by admission

        start = np.full(m, np.nan)      # wire start (after deps + compute)
        finish = np.full(m, np.nan)     # delivery of the final hop at dst
        pred = np.full(m, -1, dtype=int)  # latest-finishing dependency

        # lazy per-flow fluid state
        active = [False] * m
        rem = [0.0] * m                 # remaining bytes, current hop
        rate = [0.0] * m                # bytes/ms under current contention
        seg_t = [0.0] * m               # time rem was last materialized
        token = [0] * m                 # invalidates stale drain projections
        cur = [(0, 0, 0)] * m           # current hop (s, d, hop)
        out_cnt = np.zeros(self.n, dtype=int)
        in_cnt = np.zeros(self.n, dtype=int)
        # insertion-ordered id sets of live flows per directed NIC (order is
        # never observable — each flow's update is independent — but dicts
        # keep iteration reproducible for free)
        out_flows: list[dict[int, None]] = [{} for _ in range(self.n)]
        in_flows: list[dict[int, None]] = [{} for _ in range(self.n)]

        READY, DELIVER, DRAIN = 0, 1, 2
        # event keys order by (time, kind, global tid, aux): canonical across
        # full and segment runs — `serial` only breaks exact duplicates
        events: list[tuple[float, int, int, int, int, int]] = []
        serial = 0

        def push(time: float, kind: int, tid: int, aux: int):
            nonlocal serial
            heapq.heappush(events, (time, kind, tid_base + tid, aux, serial,
                                    tid))
            serial += 1

        def retune(s: int, d: int, now: float):
            """Re-solve every flow sharing the two touched NICs: integrate
            its bytes up to ``now`` at the old rate, then re-rate under the
            new population and re-project its drain."""
            touched = dict(out_flows[s])
            touched.update(in_flows[d])
            for j in touched:
                if now > seg_t[j]:
                    rem[j] -= rate[j] * (now - seg_t[j])
                    seg_t[j] = now
                js, jd, _ = cur[j]
                c = max(int(out_cnt[js]), int(in_cnt[jd]), 1)
                rate[j] = float(self.bw[js, jd]) * 1e6 / 8.0 / 1e3 / c
                token[j] += 1
                left = rem[j] / rate[j] if rem[j] > 0.0 else 0.0
                push(seg_t[j] + left, DRAIN, j, token[j])

        def begin_hop(now: float, tid: int, hop: int):
            s, d = hops[tid][hop]
            t = transfers[tid]
            if s == d or t.nbytes <= 0.0 or not np.isfinite(self.bw[s, d]):
                # nothing to serialize: deliver after propagation only
                if hop == 0:
                    start[tid] = now
                push(now + prop_fn(tid, s, d), DELIVER, tid, hop)
                return
            if nic is not None:
                floor = max(float(nic.clear_out[s]), float(nic.clear_in[d]))
                if now < floor:
                    # an earlier segment still occupies a NIC: retry exactly
                    # when the full run's admission would have cleared it
                    push(floor, READY, tid, hop)
                    return
            if rankb is not None and (
                min_out[s] < rankb[tid] or min_in[d] < rankb[tid]
            ):
                parked.append((tid, hop))  # dst/src NIC busy with earlier phase
                return
            if hop == 0:
                start[tid] = now
            active[tid] = True
            rem[tid] = float(t.nbytes)
            seg_t[tid] = now
            cur[tid] = (s, d, hop)
            out_cnt[s] += 1
            in_cnt[d] += 1
            out_flows[s][tid] = None
            in_flows[d][tid] = None
            retune(s, d, now)

        for i in range(m):
            if indeg[i] == 0:
                rt = 0.0 if ext_ready is None else float(ext_ready[i])
                push(rt + transfers[i].compute_ms, READY, i, 0)

        while events:
            now, kind, _gid, aux, _serial, tid = heapq.heappop(events)
            if kind == READY:
                begin_hop(now, tid, aux)
            elif kind == DRAIN:
                if not active[tid] or aux != token[tid]:
                    continue  # stale projection: the NIC population changed
                active[tid] = False
                rem[tid] = 0.0
                s, d, hop = cur[tid]
                out_cnt[s] -= 1
                in_cnt[d] -= 1
                del out_flows[s][tid]
                del in_flows[d][tid]
                if nic is not None:
                    nic.clear_out[s] = now
                    nic.clear_in[d] = now
                push(now + prop_fn(tid, s, d), DELIVER, tid, hop)
                if rankb is not None:
                    r = rankb[tid]
                    pend_out[s, r] -= 1
                    pend_in[d, r] -= 1
                    _advance(pend_out, min_out, s)
                    _advance(pend_in, min_in, d)
                    if parked:
                        # the drain may have unblocked deferred hops; ready
                        # ones start now, the rest re-park inside begin_hop
                        pk, parked[:] = list(parked), []
                        for tid2, hop2 in pk:
                            begin_hop(now, tid2, hop2)
                retune(s, d, now)
            else:  # DELIVER
                if aux + 1 < len(hops[tid]):
                    begin_hop(now, tid, aux + 1)  # store-and-forward relay
                    continue
                finish[tid] = now
                for c in children[tid]:
                    if pred[c] < 0 or finish[pred[c]] <= now:
                        pred[c] = tid
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        rt = now if ext_ready is None else max(
                            now, float(ext_ready[c])
                        )
                        push(rt + transfers[c].compute_ms, READY, c, 0)

        if parked:  # unreachable: ranks strictly increase along deps
            raise RuntimeError(
                f"admission deadlock: {len(parked)} hops still parked"
            )
        return start, finish, pred

    def simulate_segment(
        self,
        transfers: Sequence[Transfer],
        *,
        rank: np.ndarray,
        deps: Sequence[tuple[int, ...]],
        ext_ready: Sequence[float],
        nic: NicState,
        lat: np.ndarray | None = None,
        tid_base: int = 0,
    ):
        """Simulate one appended segment of a stitched stream against the
        carried cross-segment state (:class:`NicState` floors, folded
        external-dependency ready times) — the incremental half of the
        byte-identity contract (see :class:`repro_torch.core.stream.
        StreamingTimeline`).  ``lat`` is this segment's latency matrix
        (each appended epoch sees its own trace step, like ``run(...,
        lats=[...])``).  Returns ``(start, finish, pred)`` and updates
        ``nic`` in place."""
        if self.barrier:
            raise ValueError(
                "segment simulation requires the event engine: barrier "
                "phases have no cross-segment semantics"
            )
        if not self.admission:
            raise ValueError(
                "segment simulation is only sound under bandwidth admission "
                "(admission=False lets later segments slow earlier flows)"
            )
        if self.stochastic_loss:
            raise ValueError(
                "segment simulation rejects stochastic_loss=True: the "
                "retransmission draws happen in event order, which differs "
                "between incremental and full runs"
            )
        lat_m = self.lat if lat is None else np.asarray(lat, dtype=float)

        def prop_fn(tid: int, s: int, d: int) -> float:
            if s == d:
                return 0.0  # local compute stage
            return self._prop_ms(s, d, lat=lat_m)

        return self._simulate_dag(
            transfers, prop_fn, rank, deps=deps, ext_ready=ext_ready,
            nic=nic, tid_base=tid_base,
        )

    def _run_event(self, schedule: TransmissionSchedule,
                   lats: Sequence[np.ndarray] | None = None) -> RoundResult:
        transfers = schedule.transfers
        m = len(transfers)
        bytes_out, bytes_in, msg, link = self._account(schedule)
        if m == 0:
            return RoundResult(
                makespan_ms=0.0, phase_ms=[], bytes_out=bytes_out,
                bytes_in=bytes_in, msg_matrix=msg, link_bytes=link,
                n_transfers=0, start_ms=np.zeros(0), finish_ms=np.zeros(0),
            )

        stack: Sequence[np.ndarray] | None = None
        if lats is not None:
            # an EpochLatencyCycle already indexes lazily — wrapping it in a
            # list would materialize the E duplicated matrices it exists to
            # avoid
            if isinstance(lats, EpochLatencyCycle):
                stack = lats
            else:
                stack = [np.asarray(l, dtype=float) for l in lats]

        def prop_ms(tid: int, s: int, d: int) -> float:
            if s == d:
                return 0.0  # local compute stage
            if stack is None:
                return self._prop_ms(s, d)
            return self._prop_ms(
                s, d, lat=stack[min(transfers[tid].epoch, len(stack) - 1)]
            )

        rank = self._admission_ranks(schedule) if self.admission else None
        start, finish, pred = self._simulate_dag(transfers, prop_ms, rank)
        makespan = float(np.nanmax(finish)) if m else 0.0
        # critical path: backtrack from the makespan-defining transfer through
        # each transfer's latest-finishing dependency
        crit: list[int] = []
        cur = int(np.nanargmax(finish))
        while cur >= 0:
            crit.append(cur)
            cur = int(pred[cur])
        crit.reverse()
        return RoundResult(
            makespan_ms=makespan,
            phase_ms=[],
            bytes_out=bytes_out,
            bytes_in=bytes_in,
            msg_matrix=msg,
            link_bytes=link,
            n_transfers=m,
            start_ms=start,
            finish_ms=finish,
            critical_path=crit,
        )

    # -- bounds ----------------------------------------------------------------

    def lower_bound_ms(self, payload_bytes: float = 0.0) -> float:
        """Theoretical optimum for one all-to-all round (Fig 9 "Low Bound").

        Every pair must exchange its payload; no schedule beats the all-pairs
        shortest-path latency of the slowest pair plus its serialization time.
        """
        from .latency import all_pairs_shortest

        sp = all_pairs_shortest(self.lat)
        n = self.n
        mask = ~np.eye(n, dtype=bool)
        prop = sp[mask].max()
        if payload_bytes > 0.0 and np.isfinite(self.bw).any():
            tx = payload_bytes * 8.0 / (self.bw[mask].max() * 1e6) * 1e3
        else:
            tx = 0.0
        return float(prop + tx)
