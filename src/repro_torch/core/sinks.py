"""Epoch-sink pipeline (the port's own copy of ``repro.core.sinks``).

The engine pushes each epoch's ``EpochStats`` to its sinks the moment the
epoch's numbers are final, with an :class:`EpochContext` on the streaming
engine (the epoch's cumulative per-node commit row and its latency
matrix): under bandwidth admission a later epoch's flows never share a NIC
in time with an earlier one's, so the moment
``StreamingTimeline.append_epoch`` returns, the epoch's measured times are
what the full re-simulation would report, and nothing about the epoch
needs to be retained afterwards.

:class:`RunAggregator` keeps running totals and moments
(:class:`RunSummary`) plus the retained epochs, all of them
(``EngineConfig(keep_epochs=True)``, the default) or a bounded trailing
window (``keep_epochs=False, stats_window=...``).  The serving plane's
``ServingSink`` (``repro_torch.serve.plane``) is the other sink.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import TYPE_CHECKING, Protocol

import numpy as np

from .whitedata import FilterStats

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from .replication import EpochStats

__all__ = ["EpochContext", "EpochSink", "RunAggregator", "RunSummary"]


@dataclasses.dataclass(frozen=True)
class EpochContext:
    """Streaming-only side channel handed to sinks beside the stats.

    ``commit_row`` is the epoch's cumulative per-node commit row
    (``node_commit_ms`` semantics — final by the admission theorem) and
    ``lat`` the epoch's trace latency matrix (``trace[e % len(trace)]``;
    a reference, never a copy).  Non-streaming engines pass ``None``.
    """

    epoch: int
    commit_row: np.ndarray | None = None
    lat: np.ndarray | None = None


class EpochSink(Protocol):
    """A push-based consumer of finalized per-epoch stats.

    ``on_epoch`` is called exactly once per epoch, in epoch order, the
    moment the epoch's numbers are final; implementations must not retain
    unbounded per-epoch state (that is the point).
    """

    def on_epoch(
        self, stats: "EpochStats", ctx: EpochContext | None = None
    ) -> None: ...


@dataclasses.dataclass
class RunSummary:
    """Online run-level totals — what ``RunStats``' summing properties used
    to recompute from the full ``epochs`` list on every access.

    Accumulated strictly in epoch order with the same left-fold the old
    ``sum(e.x for e in epochs)`` properties performed, so every total is
    **byte-identical** to the retained computation (float addition is
    order-sensitive; the order is part of the contract).  ``sync_ms_sum``
    / ``sync_ms_sumsq`` / ``sync_ms_max`` are running moments for bounded
    runs where the full per-epoch array is gone.
    """

    n_epochs: int = 0
    n_txns: int = 0
    committed: int = 0
    aborted: int = 0
    read_aborts: int = 0
    ww_aborts: int = 0
    wall_ms: float = 0.0
    wan_bytes: float = 0.0
    sync_overlap_ms: float = 0.0
    pipeline_overlap_ms: float = 0.0
    filter_cpu_ms: float = 0.0
    filter_stats: FilterStats = dataclasses.field(default_factory=FilterStats)
    # running moments of the per-epoch DAG critical path (sync_ms) and the
    # measured wall gap — the bounded-memory stand-ins for the full arrays
    sync_ms_sum: float = 0.0
    sync_ms_sumsq: float = 0.0
    sync_ms_max: float = 0.0
    wall_ms_max: float = 0.0
    view_lag_mean_sum: float = 0.0
    view_lag_max: int = 0

    @property
    def abort_rate(self) -> float:
        return self.aborted / self.n_txns if self.n_txns else 0.0

    @property
    def read_abort_rate(self) -> float:
        return self.read_aborts / self.n_txns if self.n_txns else 0.0

    @property
    def sync_ms_mean(self) -> float:
        return self.sync_ms_sum / self.n_epochs if self.n_epochs else 0.0

    @property
    def sync_ms_std(self) -> float:
        """Population std from the running moments (clamped at 0: the
        two-pass identity loses precision when mean >> std)."""
        if not self.n_epochs:
            return 0.0
        m = self.sync_ms_mean
        return math.sqrt(max(self.sync_ms_sumsq / self.n_epochs - m * m, 0.0))

    @property
    def view_lag_mean(self) -> float:
        return self.view_lag_mean_sum / self.n_epochs if self.n_epochs else 0.0


class RunAggregator:
    """The engine's stats sink: running :class:`RunSummary` + a bounded
    trailing ``EpochStats`` window.

    ``keep_epochs=True`` (the engine default) retains the full list — the
    historical ``RunStats.epochs`` surface, memory O(E).  With
    ``keep_epochs=False`` only the trailing ``window`` epochs survive
    (``RunStats.epochs`` becomes that window; totals keep coming from the
    summary, byte-identical to the retained run).
    """

    def __init__(self, *, keep_epochs: bool = True, window: int = 64):
        self.summary = RunSummary()
        self.keep_epochs = keep_epochs
        self.window = int(window)
        self._epochs: "list[EpochStats] | collections.deque[EpochStats]"
        if keep_epochs:
            self._epochs = []
        else:
            self._epochs = collections.deque(maxlen=max(self.window, 0))

    def on_epoch(
        self, stats: "EpochStats", ctx: EpochContext | None = None
    ) -> None:
        s = self.summary
        s.n_epochs += 1
        s.n_txns += stats.n_txns
        s.committed += stats.committed
        s.aborted += stats.aborted
        s.read_aborts += stats.read_aborts
        s.ww_aborts += stats.ww_aborts
        s.wall_ms += stats.wall_ms
        s.wan_bytes += stats.wan_bytes
        s.sync_overlap_ms += stats.sync_overlap_ms
        s.pipeline_overlap_ms += stats.pipeline_overlap_ms
        s.filter_cpu_ms += stats.filter_cpu_ms
        if stats.filter_stats is not None:
            s.filter_stats = s.filter_stats.merge(stats.filter_stats)
        sync = stats.sync_ms
        s.sync_ms_sum += sync
        s.sync_ms_sumsq += sync * sync
        if sync > s.sync_ms_max:
            s.sync_ms_max = sync
        if stats.wall_ms > s.wall_ms_max:
            s.wall_ms_max = stats.wall_ms
        s.view_lag_mean_sum += stats.view_lag_mean
        if stats.view_lag_max > s.view_lag_max:
            s.view_lag_max = stats.view_lag_max
        self._epochs.append(stats)

    @property
    def epochs(self) -> "list[EpochStats]":
        """The retained epochs: everything (``keep_epochs=True``) or the
        trailing window."""
        return list(self._epochs)
