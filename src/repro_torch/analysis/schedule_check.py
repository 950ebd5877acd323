"""Static invariant verifier for transfer DAGs; the port's own copy of
``repro.analysis.schedule_check``, host code over the port's
``core/schedule.py`` (``Transfer``, ``TransmissionSchedule``).

:func:`verify_schedule` checks, in one O(V + E) pass over any
:class:`~repro_torch.core.schedule.TransmissionSchedule`, every structural
invariant the engines assume but until now only enforced dynamically
(by sampling: hypothesis properties, benchmark gates):

=================  ==========================================================
rule               invariant
=================  ==========================================================
``dep-bounds``     every dependency index is a valid transfer index
``topo-order``     dependencies reference strictly earlier transfers (the
                   topological-order contract ``dep_levels`` indexes by)
``cycle``          the dependency graph is acyclic (Kahn's algorithm over
                   the in-bounds edges, so it still terminates — and still
                   reports — on schedules with forward references)
``phase-monotone`` builder-recorded phases strictly increase along every
                   dependency edge — the *precondition of the bandwidth-
                   admission theorem* (``event <= barrier`` holds for any
                   schedule whose deps point at strictly earlier phases)
``phase-shape``    ``phase_of`` has one non-negative entry per transfer
``negative-payload``  ``nbytes`` and ``compute_ms`` are finite and >= 0
``node-bounds``    ``src``/``dst``/``via`` lie inside the latency matrix,
                   and a relay is never one of its own endpoints (either
                   would double-count its NIC)
``local-stage``    ``src == dst`` stages (exec/clock) carry no bytes and no
                   relay — the simulator skips their accounting entirely,
                   so a payload here would silently vanish from the wire
``epoch-monotone`` a transfer never depends on a *later* epoch
``epoch-contiguity``  stitched epoch tags cover ``0..max`` with no gaps
                   (``node_commit_ms`` allocates one row per epoch)
``clock-chain``    the cadence ``clock`` stages form one linear chain: at
                   most one per epoch, strictly increasing epochs, each
                   chained to exactly the previous clock
=================  ==========================================================

The verifier is pure — it never mutates the schedule and needs no network
state — so it runs identically on builder outputs, stitched streams and
hand-built test schedules.  ``WANSimulator(verify=True)`` (wired through
``EngineConfig(verify_schedules=True)``) calls it on every schedule before
simulating and raises :class:`ScheduleVerificationError` on any finding;
``tests/test_torch_analysis.py`` holds it against the reference's verifier
over all builders x trace topologies x stitched streaming schedules.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any

from .violations import Violation, format_violations

__all__ = [
    "verify_schedule",
    "StreamScheduleVerifier",
    "ScheduleVerificationError",
    "verified_schedule_count",
    "reset_verified_schedule_count",
]

# module-level provenance counter: how many schedules this process has
# verified (a benchmark records it so its results show which numbers came
# from verified DAGs)
_VERIFIED_SCHEDULES = 0


def verified_schedule_count() -> int:
    """Schedules verified (with zero violations) since process start /
    the last reset — the benchmark harness's provenance signal."""
    return _VERIFIED_SCHEDULES


def reset_verified_schedule_count() -> None:
    global _VERIFIED_SCHEDULES
    _VERIFIED_SCHEDULES = 0


class ScheduleVerificationError(ValueError):
    """A schedule failed static verification (``verify_schedules=True``)."""

    def __init__(self, violations: list[Violation], label: str = ""):
        self.violations = violations
        head = f"schedule {label!r} " if label else "schedule "
        super().__init__(
            head + f"failed static verification ({len(violations)} "
            "violation(s)):\n" + format_violations(violations)
        )


def _check_transfer_fields(
    transfers, n_nodes: int | None, out: list[Violation]
) -> None:
    for i, t in enumerate(transfers):
        if not math.isfinite(t.nbytes) or t.nbytes < 0.0:
            out.append(Violation(
                "negative-payload",
                f"nbytes = {t.nbytes!r} must be finite and >= 0", index=i,
            ))
        if not math.isfinite(t.compute_ms) or t.compute_ms < 0.0:
            out.append(Violation(
                "negative-payload",
                f"compute_ms = {t.compute_ms!r} must be finite and >= 0",
                index=i,
            ))
        if n_nodes is not None:
            for field in ("src", "dst"):
                v = getattr(t, field)
                if not 0 <= v < n_nodes:
                    out.append(Violation(
                        "node-bounds",
                        f"{field} = {v} outside [0, {n_nodes})", index=i,
                    ))
            if t.via >= n_nodes:
                out.append(Violation(
                    "node-bounds",
                    f"via = {t.via} outside [0, {n_nodes})", index=i,
                ))
        if t.via >= 0 and t.via in (t.src, t.dst):
            out.append(Violation(
                "node-bounds",
                f"relay via = {t.via} is one of its own endpoints "
                f"({t.src} -> {t.dst}): the relay hop would double-count "
                "that node's NIC", index=i,
            ))
        if t.src == t.dst:
            # local compute stage: the simulator moves no bytes and skips
            # all accounting for it, so payload/relay here silently vanish
            if t.nbytes != 0.0:
                out.append(Violation(
                    "local-stage",
                    f"local stage (src == dst == {t.src}) carries "
                    f"nbytes = {t.nbytes!r}: these bytes would never reach "
                    "the wire or the byte counters", index=i,
                ))
            if t.via >= 0:
                out.append(Violation(
                    "local-stage",
                    f"local stage (src == dst == {t.src}) routes via "
                    f"{t.via}: local stages take no relay", index=i,
                ))


def _check_deps(transfers, out: list[Violation]) -> None:
    """dep-bounds + topo-order (the cycle check runs separately, on the
    in-bounds edge subset, so it still works with dangling references)."""
    m = len(transfers)
    for i, t in enumerate(transfers):
        for d in t.deps:
            if not 0 <= d < m:
                out.append(Violation(
                    "dep-bounds",
                    f"dependency {d} outside [0, {m})", index=i,
                ))
            elif d >= i:
                out.append(Violation(
                    "topo-order",
                    f"dependency {d} does not precede its dependent "
                    "(transfers must be topologically ordered)", index=i,
                ))


def _check_acyclic(transfers, out: list[Violation]) -> None:
    """Kahn's algorithm over the in-bounds dependency edges.  Topological
    order already implies acyclicity, but a mutated/hand-built schedule with
    forward references may still be a DAG — or a genuine cycle; this check
    tells the two apart."""
    m = len(transfers)
    indeg = [0] * m
    children: list[list[int]] = [[] for _ in range(m)]
    for i, t in enumerate(transfers):
        for d in t.deps:
            if 0 <= d < m:
                indeg[i] += 1
                children[d].append(i)
    queue = deque(i for i in range(m) if indeg[i] == 0)
    seen = 0
    while queue:
        i = queue.popleft()
        seen += 1
        for c in children[i]:
            indeg[c] -= 1
            if indeg[c] == 0:
                queue.append(c)
    if seen != m:
        stuck = [i for i in range(m) if indeg[i] > 0]
        out.append(Violation(
            "cycle",
            f"dependency cycle: {m - seen} transfer(s) can never become "
            f"ready (e.g. indices {stuck[:5]})", index=stuck[0],
        ))


def _check_phases(schedule, out: list[Violation]) -> None:
    phase_of = schedule.phase_of
    transfers = schedule.transfers
    if phase_of is None:
        return  # ASAP levels are strictly monotone by construction
    m = len(transfers)
    if len(phase_of) != m:
        out.append(Violation(
            "phase-shape",
            f"phase_of has {len(phase_of)} entries for {m} transfers",
        ))
        return
    for i, p in enumerate(phase_of):
        if p < 0:
            out.append(Violation(
                "phase-shape", f"phase {p} is negative", index=i,
            ))
    for i, t in enumerate(transfers):
        for d in t.deps:
            if 0 <= d < m and phase_of[d] >= phase_of[i]:
                out.append(Violation(
                    "phase-monotone",
                    f"phase {phase_of[i]} depends on transfer {d} of phase "
                    f"{phase_of[d]}: phases must strictly increase along "
                    "dependency edges (the bandwidth-admission theorem's "
                    "precondition)", index=i,
                ))


def _check_epochs(transfers, out: list[Violation]) -> None:
    m = len(transfers)
    seen: set[int] = set()
    for i, t in enumerate(transfers):
        if t.epoch < 0:
            out.append(Violation(
                "epoch-contiguity", f"epoch {t.epoch} is negative", index=i,
            ))
            continue
        seen.add(t.epoch)
        for d in t.deps:
            if 0 <= d < m and transfers[d].epoch > t.epoch:
                out.append(Violation(
                    "epoch-monotone",
                    f"epoch {t.epoch} depends on transfer {d} of later "
                    f"epoch {transfers[d].epoch}", index=i,
                ))
    if seen:
        missing = sorted(set(range(max(seen) + 1)) - seen)
        if missing:
            out.append(Violation(
                "epoch-contiguity",
                f"epoch tags are not contiguous: {missing[:5]} absent "
                f"below max epoch {max(seen)} (node_commit_ms allocates "
                "one row per epoch)",
            ))


def _check_clock_chain(transfers, out: list[Violation]) -> None:
    """Cadence ``clock`` stages must form one linear chain (stitched
    schedules): strictly increasing epochs, at most one per epoch, each
    clock chained to exactly the previous one through its deps."""
    m = len(transfers)
    clocks = [i for i, t in enumerate(transfers) if t.tag == "clock"]
    clock_set = set(clocks)
    prev = -1
    for pos, i in enumerate(clocks):
        t = transfers[i]
        if pos > 0:
            if t.epoch <= transfers[prev].epoch:
                out.append(Violation(
                    "clock-chain",
                    f"clock epochs must strictly increase: epoch {t.epoch} "
                    f"follows clock {prev} of epoch {transfers[prev].epoch}",
                    index=i,
                ))
            clock_deps = [d for d in t.deps if 0 <= d < m and d in clock_set]
            if clock_deps != [prev]:
                out.append(Violation(
                    "clock-chain",
                    f"clock must chain to exactly the previous clock "
                    f"({prev}); found clock deps {clock_deps}", index=i,
                ))
        prev = i


class StreamScheduleVerifier:
    """Incremental (per-epoch) mode of :func:`verify_schedule` for
    appendable stitched streams.

    The one-shot verifier is O(V + E) over the *whole* stream, so calling
    it per appended epoch would reintroduce the O(E²) cost the incremental
    timeline exists to remove.  This verifier carries the cross-epoch
    state instead (epoch counter, clock-chain tail, the previous epoch's
    dependency frontier with its phase ranks) and checks each appended
    segment in O(segment):

    * all one-shot per-transfer rules (payload/compute sanity, node
      bounds, local-stage purity) via the same ``_check_transfer_fields``;
    * ``dep-bounds`` / ``topo-order`` against *global* stream indices
      (which also implies acyclicity — every dependency is strictly
      earlier);
    * ``phase-monotone`` along every edge, external edges resolved through
      the retained frontier ranks;
    * ``stream-frontier`` (incremental-only rule): an external dependency
      must land in the previous epoch's frontier (per-node commit
      transfers, exec stages, clock tail) — anything older has been
      evicted and would make the fold-in of external finish times unsound;
    * ``epoch-contiguity`` (every segment transfer carries the current
      epoch tag — appending is what makes tags contiguous) and
      ``clock-chain`` (at most one clock per segment, chained to exactly
      the retained tail).

    Each clean segment counts toward :func:`verified_schedule_count`, the
    same provenance signal the one-shot verifier feeds.
    """

    def __init__(self, n_nodes: int | None = None):
        self.n_nodes = n_nodes
        self.epoch = 0
        self.size = 0                        # transfers verified so far
        self._prev_clock: int | None = None  # global index of the chain tail
        self._frontier_ranks: dict[int, int] = {}

    def check_epoch(
        self,
        transfers: Any,
        ranks: Any,
        *,
        frontier: Any,
    ) -> list[Violation]:
        """Verify one appended segment (global dep indices, admission
        ranks) and advance the carried state.  ``frontier`` is the global
        index set the *next* epoch may depend on (``StitchState.
        frontier()`` after this append).  Returns all violations found."""
        global _VERIFIED_SCHEDULES
        out: list[Violation] = []
        transfers = list(transfers)
        ranks = list(ranks)
        base = self.size
        hi = base + len(transfers)
        _check_transfer_fields(transfers, self.n_nodes, out)
        if len(ranks) != len(transfers):
            out.append(Violation(
                "phase-shape",
                f"segment has {len(ranks)} ranks for {len(transfers)} "
                "transfers",
            ))
            ranks = ranks + [0] * (len(transfers) - len(ranks))
        known = self._frontier_ranks
        clocks: list[int] = []
        for i, t in enumerate(transfers):
            gi = base + i
            if t.epoch != self.epoch:
                out.append(Violation(
                    "epoch-contiguity",
                    f"segment transfer carries epoch {t.epoch}, appending "
                    f"epoch {self.epoch} (tags are contiguous by "
                    "construction)", index=gi,
                ))
            if t.tag == "clock":
                clocks.append(gi)
            for d in t.deps:
                if not 0 <= d < hi:
                    out.append(Violation(
                        "dep-bounds",
                        f"dependency {d} outside [0, {hi})", index=gi,
                    ))
                    continue
                if d >= gi:
                    out.append(Violation(
                        "topo-order",
                        f"dependency {d} does not precede its dependent "
                        "(stream indices are topologically ordered)",
                        index=gi,
                    ))
                    continue
                if d >= base:
                    dep_rank = ranks[d - base]
                elif d in known:
                    dep_rank = known[d]
                else:
                    out.append(Violation(
                        "stream-frontier",
                        f"external dependency {d} is not in the previous "
                        "epoch's frontier (commit/exec/clock indices): its "
                        "finish time has been evicted", index=gi,
                    ))
                    continue
                if dep_rank >= ranks[i]:
                    out.append(Violation(
                        "phase-monotone",
                        f"phase {ranks[i]} depends on transfer {d} of "
                        f"phase {dep_rank}: phases must strictly increase "
                        "along dependency edges (the bandwidth-admission "
                        "theorem's precondition)", index=gi,
                    ))
        if len(clocks) > 1:
            out.append(Violation(
                "clock-chain",
                f"segment has {len(clocks)} clock stages; stitching emits "
                "at most one per epoch", index=clocks[1],
            ))
        for gi in clocks:
            t = transfers[gi - base]
            want = () if self._prev_clock is None else (self._prev_clock,)
            if tuple(t.deps) != want:
                out.append(Violation(
                    "clock-chain",
                    f"clock must chain to exactly the previous clock "
                    f"(deps {want}); found deps {tuple(t.deps)}", index=gi,
                ))
        if clocks:
            self._prev_clock = clocks[-1]
        # the frontier is always inside the segment just appended (the
        # stitcher rebuilds prev_commit/prev_exec/prev_clock every epoch)
        self._frontier_ranks = {
            g: ranks[g - base] for g in frontier if base <= g < hi
        }
        self.size = hi
        self.epoch += 1
        if not out:
            _VERIFIED_SCHEDULES += 1
        return out


def verify_schedule(
    schedule: Any, *, n_nodes: int | None = None
) -> list[Violation]:
    """Statically verify one transfer DAG.  Returns all violations found
    (empty list = the schedule satisfies every engine invariant).

    ``n_nodes`` (the latency-matrix dimension) enables the src/dst/via
    bounds checks; without it only matrix-independent invariants run.
    Pure and O(V + E): cheap enough to run on every simulated schedule
    behind ``EngineConfig(verify_schedules=True)``.
    """
    global _VERIFIED_SCHEDULES
    out: list[Violation] = []
    transfers = schedule.transfers
    _check_transfer_fields(transfers, n_nodes, out)
    _check_deps(transfers, out)
    _check_acyclic(transfers, out)
    _check_phases(schedule, out)
    _check_epochs(transfers, out)
    _check_clock_chain(transfers, out)
    if not out:
        _VERIFIED_SCHEDULES += 1
    return out
