"""Appendable streaming timeline: O(E) long-horizon event simulation (the
port's own copy of ``repro.core.stream``, host numpy).

The staleness-feedback loop (``EngineConfig(staleness_feedback=True)``)
needs each epoch's measured per-node commit times *before* it can execute
the next epoch's transactions.  The original implementation re-simulated
the stitched prefix every epoch (``GeoCluster._stream_prefix``) — exact,
but O(E²) in simulated transfers, capping runs at tens of epochs.

:class:`StreamingTimeline` owns the running event-engine state instead —
the stitch frontier (:class:`~repro_torch.core.schedule.StitchState`: per-node
commit indices, exec stages, the cadence clock-chain tail, the admission
rank offset), the previous epoch's delivered finish times, and the
per-directed-NIC clear floors (:class:`~repro_torch.core.simulator.NicState`) —
and :meth:`append_epoch` simulates **only the appended epoch's events**.

Why the incremental times are byte-identical to the full re-simulation
(the PR-4 bandwidth-admission theorem doing double duty):

* every wire hop of epoch ``k+1`` has a strictly higher admission rank
  than everything already streamed (``rank_base`` grows monotonically),
  so admission keeps it off both of its NICs until every earlier flow
  there has drained — epoch ``k+1``'s flows never share a NIC *in time*
  with epoch ``<= k``'s, and (conversely) later flows never re-rate
  earlier ones, making the earlier epochs' times final;
* the event engine is lazy per flow (a flow's float arithmetic is touched
  only by events on its own two directed NICs — see
  :meth:`~repro_torch.core.simulator.WANSimulator.simulate_segment`), so a
  flow's measured times are a pure function of its NIC-local history;
* every influence of the already-simulated prefix on the new epoch
  reduces to finitely many stored floats: the frontier dependencies'
  finish times (folded into per-transfer external ready floors) and each
  directed NIC's last drain time (the admission floor).  Replaying the
  segment against those floats performs the *same* float operations in
  the *same* canonical event order as the full run.

``tests/test_torch_streaming.py`` pins the identity, and the port's
timings against the reference's (exact ``==`` on finish times and commit
matrices, no tolerances).  The O(E²) oracle stays available behind
``EngineConfig(stream_mode="resim")``.

What incremental mode cannot support: ``stochastic_loss=True`` (the
retransmission RNG draws happen in event order, which differs between
incremental and full runs — rejected at construction), ``admission=False``
(later flows could then slow earlier ones and no prefix would ever be
final) and the barrier engine (no cross-epoch semantics).  ``verify=True``
(the reference's per-epoch schedule verifier) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .schedule import StitchState, Transfer, TransmissionSchedule
from .simulator import NicState, WANSimulator, epoch_commit_row

__all__ = ["StreamingTimeline", "EpochTimings"]


@dataclasses.dataclass
class EpochTimings:
    """Measured times of one appended epoch.

    ``commit_ms`` is the epoch's row of the cumulative per-node commit
    matrix (identical to ``node_commit_ms(...)[epoch]`` of the full
    re-simulation); ``finish_max_ms`` the segment's last delivery (what the
    streaming stats report as the epoch's absolute commit);
    ``start_ms`` / ``finish_ms`` index the segment ``transfers`` (global
    dependency indices, first at stream index ``offset``).
    """

    epoch: int
    commit_ms: np.ndarray
    finish_max_ms: float
    start_ms: np.ndarray
    finish_ms: np.ndarray
    transfers: list[Transfer]
    offset: int


class StreamingTimeline:
    """Appendable cross-epoch event simulation (see module docstring).

    ``append_epoch(schedule, lat, node_exec_ms)`` stitches the epoch onto
    the stream frontier and simulates only its events; delivered-transfer
    state is evicted down to the dependency frontier after every append.
    The cumulative commit matrix and per-epoch finish marks live in a
    sliding-window buffer: callers that only need recent rows (the
    staleness-feedback loop needs nothing below the slowest view's merge
    frontier, ``view_next.min()``) release older ones with
    :meth:`evict_commit_rows`, keeping memory O(segment + live window · n)
    instead of O(E·n).  With no eviction the full matrix is retained and
    :attr:`commit_ms` / :attr:`finish_max_ms` are exactly the historical
    surfaces.
    """

    def __init__(
        self,
        n: int,
        *,
        bandwidth_mbps: np.ndarray | float = np.inf,
        loss: np.ndarray | float = 0.0,
        retx_timeout_ms: float = 200.0,
        epoch_ms: float = 0.0,
        verify: bool = False,
    ):
        if verify:
            raise NotImplementedError(
                "StreamingTimeline(verify=True) is not ported yet (ROADMAP §1, W7: "
                "analysis/schedule_check.py)"
            )
        self.n = n
        # the simulator carries the wire model (bandwidth/loss are
        # constructor-fixed, as in stitched runs); propagation comes from
        # each append's own latency matrix
        self._sim = WANSimulator(
            np.zeros((n, n)), bandwidth_mbps, loss=loss,
            retx_timeout_ms=retx_timeout_ms,
        )
        if self._sim.stochastic_loss:  # pragma: no cover - default False
            raise ValueError("incremental timelines reject stochastic_loss")
        self._stitch = StitchState(n, epoch_ms=epoch_ms)
        self._nic = NicState.zeros(n)
        # frontier state: finish times / repaired admission ranks / builder
        # phase ranks of exactly the indices the next epoch may depend on
        self._finish: dict[int, float] = {}
        self._rank: dict[int, int] = {}
        self._phase: dict[int, int] = {}
        # cumulative per-node commit matrix + per-epoch finish marks, stored
        # as a sliding window: physical row 0 is absolute epoch _phys_base,
        # rows below the _evicted frontier are dead and reclaimed by
        # _ensure_capacity (compact-or-grow), so retained capacity is
        # O(live window) rather than O(E)
        self._commit = np.zeros((8, n))
        self._fmax = np.zeros(8)
        self._acc = np.full(n, -np.inf)
        self._phys_base = 0   # absolute epoch of physical row 0
        self._evicted = 0     # retention frontier: rows < _evicted are gone

    # -- read surface --------------------------------------------------------

    @property
    def n_epochs(self) -> int:
        return self._stitch.epoch

    @property
    def evicted_epochs(self) -> int:
        """Epochs whose commit rows have been released; reads below this
        frontier raise.  0 until :meth:`evict_commit_rows` is first used."""
        return self._evicted

    @property
    def commit_ms(self) -> np.ndarray:
        """The retained ``(n_epochs - evicted_epochs, n)`` cumulative
        per-node commit window — with no eviction, the same full matrix
        ``node_commit_ms(stitched, full_run, n)`` yields; row 0 is absolute
        epoch :attr:`evicted_epochs`."""
        lo = self._evicted - self._phys_base
        return self._commit[lo: self._stitch.epoch - self._phys_base]

    @property
    def finish_max_ms(self) -> list[float]:
        """Per retained epoch: the last delivery among that epoch's
        transfers (the absolute stream commit the stats loop consumes)."""
        lo = self._evicted - self._phys_base
        return self._fmax[lo: self._stitch.epoch - self._phys_base].tolist()

    def commit_at(self, epoch: int, node: int) -> float:
        """``commit_ms[epoch, node]`` by absolute epoch index (the feedback
        loop's point read — window-relocation-proof)."""
        if epoch < self._evicted:
            raise IndexError(
                f"commit row for epoch {epoch} was evicted "
                f"(frontier at {self._evicted})"
            )
        if epoch >= self._stitch.epoch:
            raise IndexError(
                f"epoch {epoch} not yet appended ({self._stitch.epoch} so far)"
            )
        return float(self._commit[epoch - self._phys_base, node])

    def commit_row(self, epoch: int) -> np.ndarray:
        """A copy of the cumulative commit row of an absolute epoch."""
        if epoch < self._evicted or epoch >= self._stitch.epoch:
            raise IndexError(
                f"epoch {epoch} outside retained window "
                f"[{self._evicted}, {self._stitch.epoch})"
            )
        return self._commit[epoch - self._phys_base].copy()

    # -- retention -----------------------------------------------------------

    def evict_commit_rows(self, before: int) -> None:
        """Release commit rows of epochs ``< before`` (monotone; clamped to
        the appended horizon).  Sound for the feedback loop once every
        node's view has merged past them: ``_advance_views`` only ever
        reads rows ``>= view_next.min()``, and an epoch's row is final the
        moment it is appended (the admission theorem), so nothing will
        update or reread a released row.  The memory is reclaimed lazily by
        the next capacity request (compact-or-grow)."""
        before = min(int(before), self._stitch.epoch)
        if before > self._evicted:
            self._evicted = before

    def _ensure_capacity(self, epoch: int) -> None:
        """Make physical room for an absolute epoch's row: slide the live
        window down over dead (evicted) rows when at least half the buffer
        is dead, else double.  Amortized O(1) per append; capacity stays
        O(max live window)."""
        cap = self._commit.shape[0]
        if epoch - self._phys_base < cap:
            return
        # rows physically written so far (the requested epoch's row isn't)
        filled = min(self._stitch.epoch - self._phys_base, cap)
        dead = self._evicted - self._phys_base
        if dead >= cap // 2:
            live = filled - dead
            self._commit[:live] = self._commit[dead:filled]
            self._fmax[:live] = self._fmax[dead:filled]
            self._phys_base = self._evicted
            filled = live
        if epoch - self._phys_base >= cap:
            new_cap = max(2 * cap, epoch - self._phys_base + 1)
            grown = np.zeros((new_cap, self.n))
            grown_f = np.zeros(new_cap)
            grown[:filled] = self._commit[:filled]
            grown_f[:filled] = self._fmax[:filled]
            self._commit = grown
            self._fmax = grown_f

    # -- append --------------------------------------------------------------

    def append_epoch(
        self,
        schedule: TransmissionSchedule,
        lat: np.ndarray,
        node_exec_ms: Sequence[float] | None = None,
    ) -> EpochTimings:
        """Stitch one epoch onto the stream and simulate only its events.

        Returns the epoch's :class:`EpochTimings`; times are byte-identical
        to re-simulating the whole stitched prefix.
        """
        k = self._stitch.epoch
        seg, phase_ranks = self._stitch.append(schedule, node_exec_ms)
        offset = self._stitch.size - len(seg)

        # localize dependencies: internal edges stay, external edges fold
        # into (a) the transfer's ready floor — the max of the stored
        # frontier finish times, exactly the float the full run's last
        # dependency delivery would supply — and (b) the admission-rank
        # repair (_admission_ranks resolved over the whole stream).
        deps_local: list[tuple[int, ...]] = []
        ext_ready = [0.0] * len(seg)
        rep_rank: list[int] = []
        for i, t in enumerate(seg):
            ds: list[int] = []
            r = 0
            ext = 0.0
            for d in t.deps:
                if d >= offset:
                    li = d - offset
                    ds.append(li)
                    if rep_rank[li] + 1 > r:
                        r = rep_rank[li] + 1
                else:
                    f = self._finish[d]
                    if f > ext:
                        ext = f
                    if self._rank[d] + 1 > r:
                        r = self._rank[d] + 1
            if phase_ranks[i] > r:
                r = phase_ranks[i]
            rep_rank.append(r)
            ext_ready[i] = ext
            deps_local.append(tuple(ds))

        start, finish, _pred = self._sim.simulate_segment(
            seg,
            rank=np.asarray(rep_rank, dtype=int),
            deps=deps_local,
            ext_ready=ext_ready,
            nic=self._nic,
            lat=lat,
            tid_base=offset,
        )

        # evict delivered-transfer state down to the new frontier
        new_finish: dict[int, float] = {}
        new_rank: dict[int, int] = {}
        new_phase: dict[int, int] = {}
        for g in self._stitch.frontier():
            li = g - offset
            new_finish[g] = float(finish[li])
            new_rank[g] = rep_rank[li]
            new_phase[g] = phase_ranks[li]
        self._finish, self._rank, self._phase = new_finish, new_rank, new_phase

        # this epoch's commit row (node_commit_ms semantics: per-node max
        # delivery over owned transfers, cumulative over epochs, -inf -> 0)
        row = epoch_commit_row(seg, finish, self.n)
        np.maximum(self._acc, row, out=self._acc)
        self._ensure_capacity(k)
        p = k - self._phys_base
        self._commit[p] = np.where(np.isfinite(self._acc), self._acc, 0.0)
        fmax = float(finish.max()) if len(seg) else 0.0
        self._fmax[p] = fmax

        return EpochTimings(
            epoch=k,
            commit_ms=self._commit[p].copy(),
            finish_max_ms=fmax,
            start_ms=start,
            finish_ms=finish,
            transfers=seg,
            offset=offset,
        )
