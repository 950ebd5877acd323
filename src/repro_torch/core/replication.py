"""Multi-master epoch replication engine (GeoGauss-like); the port's
counterpart of ``repro.core.replication``.

Per epoch (default cadence 10 ms, the GeoGauss setting):

1. every replica executes its transaction batch locally (OCC, Sec 4.3),
2. write sets are synchronized — flat all-to-all (baseline) or GeoCoCo's
   hierarchical schedule with aggregator-side white-data filtering,
3. deterministic global validation commits the epoch and all replicas merge
   the committed deltas (CRDT join), producing identical state everywhere.

The replicated store is a device table (``core.crdt.CRDTTable``), the epoch
a struct of arrays on it; validation, the filter and the commit are tensor
work there, and the commit joins the table through the CUDA merge kernel.
The planner, the schedules and the WAN simulator stay host numpy: they
model the network, not the database's state.

Throughput model, two regimes (the reference's):

* **formula pipelining** (``streaming=False``): an epoch's wall clock is
  ``max(epoch_ms, execution, synchronization)``.  The synchronization round
  runs as an event-driven transfer DAG by default, or as the pre-DAG
  barrier phases with ``barrier=True``; both commit the same bytes.
* **streaming simulation** (``streaming=True``): consecutive epochs' DAGs
  are stitched (``schedule.stitch_schedules``; epoch e+1's gathers out of
  node s wait only for s's epoch-e commit) and timed on the host by one
  event-driven simulation, appended epoch by epoch onto a
  ``stream.StreamingTimeline`` (``stream_mode="incremental"``) or re-run
  over the whole prefix (``"resim"``, the O(E²) oracle; equal times).
  ``EpochStats.wall_ms`` is the measured inter-commit gap and
  ``pipeline_overlap_ms`` what the formula would have charged on top.  The
  commits are the formula engine's, so the digests are too.

  ``staleness_feedback=True`` feeds the measured timing back into OCC:
  each node keeps its own snapshot view, a ``CRDTTable`` on the card made
  by ``store.snapshot()`` when ``run()`` starts, advanced by joining whole
  committed epochs (:func:`advance_views`, one ``crdt_join_rows`` launch a
  view and epoch) once the stitched simulation has delivered that node's
  inbound transfers.  Each node's reads and rewrites come from its view,
  each aggregator filters against its own view, and validation still runs
  against the global store: read aborts become a function of the WAN.

``serve=ServeConfig(...)`` (streaming only) attaches the read serving
plane (``repro_torch.serve``): region-affine clients read each node's view
at the measured commit times; it only observes, so digests, WAN bytes and
times are the same with it on or off, and its report is ``RunStats.serve``.

``compression=True`` (``geococo-zlib``) sizes each WAN payload as the
reference does, zlib at level 6 over ``b"".join(key + value)`` of the
updates in their order plus 24 bytes an update.  An epoch's records are
built into one stream on the store's device (``CRDTTable.record_bytes``),
copied to the host once, and each payload is cut from it and compressed
there: no device codec gives zlib's exact sizes.

:class:`RaftCluster` models the CockroachDB integration (Sec 5
"Extensions"): leader-based AppendEntries fan-out, commit at majority
quorum, with GeoCoCo optionally relaying through group aggregators; host
numpy, timing quorums only.

``verify_schedules=True`` statically verifies every schedule the engine
simulates (``repro_torch.analysis.schedule_check``): each epoch's round,
the stitched stream (``stream_mode="resim"``) and each segment appended to
the incremental timeline.  It only observes: a verified run reports what an
unverified one does, or raises ``ScheduleVerificationError``.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import time
import zlib

import numpy as np
import torch

from . import strategies as _strategies
from .crdt import CRDTTable
from .latency import one_relay_effective
from .occ import EpochBatch, validate_epoch_detailed
from .planner import GroupPlan, best_plan
from .schedule import TransmissionSchedule, leader_schedule, stitch_schedules
from .simulator import EpochLatencyCycle, WANSimulator, node_commit_ms
from .sinks import EpochContext, EpochSink, RunAggregator, RunSummary
from .stream import StreamingTimeline
from .whitedata import FilterStats
from ..analysis.config_check import validate_config
from ..device import resolve_device, synchronize
# the serving plane lives above this engine (it reads measured commit
# times, never feeds back into them); its config is an EngineConfig field.
# Its plane is imported where a run serves: it imports repro_torch.core,
# whose package imports this module
from ..serve.config import ServeConfig
from ..serve.stats import ServeStats

__all__ = ["EngineConfig", "EpochStats", "RunStats", "GeoCluster", "RaftCluster",
           "advance_views"]


# an epoch's compression split (GeoCluster.epoch_times under compression)
_ZLIB_PARTS = ("stream_s", "stream_copy_s", "zlib_s")
_ZLIB_BYTES = ("stream_bytes", "zlib_in_bytes", "zlib_out_bytes")
# the reference's defaults, the only values its callers use: zlib's level,
# and the modeled compression CPU in ns a byte of compressor input
_ZLIB_LEVEL = 6
_COMPRESS_NS_PER_BYTE = 15.0


@dataclasses.dataclass
class EngineConfig:
    """Engine configuration with a named-strategy surface.

    ``sync_strategy`` names a registered ``wan_sync`` preset (``flat`` /
    ``hier`` / ``geococo`` / ``geococo-zlib`` — the same names the device
    plane's exchange uses); when given it drives the per-stage booleans.
    The booleans stay writable for ablations without an exact preset.  ``schedule_name`` and
    ``filter_name`` select registered implementations for the grouping
    transmission and the aggregator filter.  Flag compatibility is checked
    by the rule table (``repro_torch.analysis.config_check``), with the
    reference's messages.
    """

    n_nodes: int
    epoch_ms: float = 10.0
    txn_exec_us: float = 40.0
    barrier: bool = False              # True = pre-DAG barrier-phase engine
    streaming: bool = False            # True = cross-epoch stitched simulation
    # per-node snapshot views advanced by the measured stream (streaming
    # only): reads and rewrites versioned against the executing node's view
    staleness_feedback: bool = False
    # the read serving plane (streaming only): clients read the per-node
    # views at the measured commit times; RunStats.serve holds its report
    serve: ServeConfig | None = None
    # modeled bytes-proportional filter/compress CPU instead of the measured
    # wall clock (on the card: after a synchronise), so a run is
    # deterministic; ns a byte of filter input (compression: _COMPRESS_NS_PER_BYTE)
    modeled_cpu: bool = False
    filter_cpu_ns_per_byte: float = 2.0
    # how the streaming engine times the stream: "incremental" appends each
    # epoch onto a StreamingTimeline (O(E)); "resim" re-stitches and re-runs
    # the whole prefix (the O(E²) oracle), with equal times
    stream_mode: str = "incremental"
    # keep_epochs=False keeps only the trailing `stats_window` EpochStats;
    # run totals come from the online RunSummary either way
    keep_epochs: bool = True
    stats_window: int = 64
    # debug hook: statically verify every schedule the engine simulates
    # (repro_torch.analysis.schedule_check.verify_schedule — acyclicity, phase
    # monotonicity along deps, clock-chain linearity, payload/node sanity)
    # before it runs.  O(V+E) per round; raises ScheduleVerificationError
    # on the first unsound DAG instead of silently mistiming it.
    verify_schedules: bool = False
    sync_strategy: str | None = None   # named wan_sync preset (overrides booleans)
    grouping: bool = True              # GeoCoCo hierarchical transmission
    filtering: bool = True             # white-data filter at aggregators
    tiv: bool = True                   # overlay relay exploitation
    tiv_margin: float = 0.05
    compression: bool = False          # zlib on WAN payloads (Fig 16)
    schedule_name: str | None = None   # registered "schedule" builder
    filter_name: str | None = None     # registered "filter" implementation
    planner: str = "milp"              # registered "planner" strategy
    replan_threshold: float = 0.20
    replan_sustain: int = 3
    planner_time_limit_s: float = 10.0

    def __post_init__(self):
        validate_config(self)
        if self.sync_strategy is not None:
            spec = _strategies.get("wan_sync", self.sync_strategy)
            self.grouping = spec.grouping
            self.filtering = spec.filtering
            self.tiv = spec.tiv
            self.compression = spec.compression
        _strategies.get("planner", self.planner)      # fail fast on typos
        if self.schedule_name is not None:
            _strategies.get("schedule", self.schedule_name)
        if self.filter_name is not None:
            _strategies.get("filter", self.filter_name)

    @property
    def resolved_sync_strategy(self) -> str:
        if self.sync_strategy is not None:
            return self.sync_strategy
        return _strategies.wan_strategy_name(
            grouping=self.grouping, filtering=self.filtering,
            tiv=self.tiv, compression=self.compression,
        )

    @property
    def resolved_schedule_name(self) -> str:
        if self.schedule_name is not None:
            return self.schedule_name
        if self.sync_strategy is not None:
            return _strategies.get("wan_sync", self.sync_strategy).schedule
        return "hierarchical" if self.grouping else "all_to_all"

    @property
    def resolved_filter_name(self) -> str:
        if not self.filtering:
            return "none"
        if self.filter_name is not None:
            return self.filter_name
        if self.sync_strategy is not None:
            return _strategies.get("wan_sync", self.sync_strategy).filter
        return "whitedata"


@dataclasses.dataclass
class EpochStats:
    """One epoch's report; the reference's fields.  ``sync_ms`` is the
    DAG critical path (the barrier engine: the phase-sum makespan);
    ``sync_serial_ms`` what a fully serialized round would cost and
    ``sync_overlap_ms = sync_serial_ms - sync_ms`` the work the DAG hid,
    split into filter CPU off the critical path (``sync_cpu_hidden_ms``)
    and cross-stage WAN overlap (``sync_wan_overlap_ms``).  On the
    streaming engine ``wall_ms`` is the measured inter-commit gap,
    ``stream_commit_ms`` the epoch's absolute commit in the stitched
    stream and ``pipeline_overlap_ms = max(epoch_ms, exec_ms, sync_ms) -
    wall_ms`` (negative for an epoch paying off a backlog); under
    ``staleness_feedback`` ``view_lag_mean`` / ``view_lag_max`` are how many
    epochs the nodes' views lagged when the epoch executed, over nodes.
    ``read_aborts`` (stale read versions, only under feedback) and
    ``ww_aborts`` may overlap."""

    epoch: int
    n_txns: int
    committed: int
    aborted: int
    sync_ms: float
    exec_ms: float
    wall_ms: float
    wan_bytes: float
    filter_stats: FilterStats | None
    filter_cpu_ms: float
    plan_method: str
    sync_serial_ms: float = 0.0
    sync_overlap_ms: float = 0.0
    sync_cpu_hidden_ms: float = 0.0
    sync_wan_overlap_ms: float = 0.0
    pipeline_overlap_ms: float = 0.0
    stream_commit_ms: float = 0.0
    read_aborts: int = 0
    ww_aborts: int = 0
    view_lag_mean: float = 0.0
    view_lag_max: int = 0


@dataclasses.dataclass
class RunStats:
    """A run's report.  ``epochs`` is the retained per-epoch list (the
    trailing ``stats_window`` under ``keep_epochs=False``); the run totals
    read ``summary`` when present and fold ``epochs`` otherwise."""

    epochs: list[EpochStats]
    msg_matrix: np.ndarray
    plan_time_s: float
    state_digest: str
    value_digest: str
    serve: ServeStats | None = None
    summary: RunSummary | None = None

    def _total(self, name: str, attr: str):
        if self.summary is not None:
            return getattr(self.summary, name)
        return sum(getattr(e, attr) for e in self.epochs)

    @property
    def committed(self) -> int:
        return self._total("committed", "committed")

    @property
    def total_txns(self) -> int:
        return self._total("n_txns", "n_txns")

    @property
    def aborted(self) -> int:
        return self._total("aborted", "aborted")

    @property
    def read_aborts(self) -> int:
        return self._total("read_aborts", "read_aborts")

    @property
    def ww_aborts(self) -> int:
        return self._total("ww_aborts", "ww_aborts")

    @property
    def abort_rate(self) -> float:
        t = self.total_txns
        return self.aborted / t if t else 0.0

    @property
    def read_abort_rate(self) -> float:
        t = self.total_txns
        return self.read_aborts / t if t else 0.0

    @property
    def wall_s(self) -> float:
        return self._total("wall_ms", "wall_ms") / 1e3

    @property
    def throughput_tps(self) -> float:
        w = self.wall_s
        return self.committed / w if w > 0 else 0.0

    @property
    def wan_bytes(self) -> float:
        return self._total("wan_bytes", "wan_bytes")

    @property
    def makespans_ms(self) -> np.ndarray:
        """Per-epoch DAG critical paths of the retained epochs."""
        return np.array([e.sync_ms for e in self.epochs], dtype=float)

    @property
    def white_stats(self) -> FilterStats:
        if self.summary is not None:
            return self.summary.filter_stats
        out = FilterStats()
        for e in self.epochs:
            if e.filter_stats is not None:
                out = out.merge(e.filter_stats)
        return out

    @property
    def p99_sync_ms(self) -> float:
        ms = self.makespans_ms
        if ms.size == 0:
            return 0.0
        return float(np.percentile(ms, 99))

    @property
    def overlap_ms(self) -> float:
        """Total CPU/WAN work hidden by the pipelined transmission DAG."""
        return self._total("sync_overlap_ms", "sync_overlap_ms")

    @property
    def pipeline_overlap_ms(self) -> float:
        """Total wall clock the streaming pipeline saved against the
        ``max(epoch, exec, sync)`` formula (0.0 off the streaming engine)."""
        return self._total("pipeline_overlap_ms", "pipeline_overlap_ms")


@dataclasses.dataclass
class _EpochRound:
    """The timing-independent product of one epoch: the schedule to time,
    the commit outcome, and the planning/filtering context the stats need;
    ``delta`` the committed writes on the card when views must merge them."""

    epoch: int
    schedule: TransmissionSchedule
    n_txns: int
    committed: int
    aborted: int
    read_aborts: int
    ww_aborts: int
    exec_ms: float
    node_exec_ms: np.ndarray
    filter_cpu_ms: float
    fstats: FilterStats | None
    plan_method: str
    modeled_cpu_ms: float
    delta: tuple[torch.Tensor, ...] | None = None


def advance_views(
    n_nodes: int,
    views: list[CRDTTable],
    view_next: np.ndarray,
    pending: dict[int, tuple[torch.Tensor, ...]],
    commit_at,
    n_done: int,
    now_ms: float,
) -> None:
    """Join every epoch the stitched simulation has delivered to each node
    by ``now_ms`` into that node's view.  Views advance a contiguous epoch
    prefix (a node merges epoch k only once its k-th inbound transfers have
    all delivered — the same per-node commit dependency ``stitch_schedules``
    gates sends on), a whole epoch's committed rows at a time through
    ``CRDTTable.join_rows`` (one ``crdt_join_rows`` launch, no sync).

    ``commit_at(k, i)`` reads the measured commit time of epoch ``k`` at
    node ``i`` for ``k < n_done``; ``pending`` maps epoch -> its committed
    rows on the card, reduced to distinct rows once at the commit
    (``CRDTTable.top_rows``: rows, values, versions, lengths), and is the
    retention frontier: entries every view has merged past
    (``< view_next.min()``) are released here, because no view will ever
    ask for them again.  The reference's ``advance_views``, with
    device tables for its dict stores."""
    for i in range(n_nodes):
        nxt = int(view_next[i])
        while nxt < n_done and commit_at(nxt, i) <= now_ms + 1e-9:
            views[i].join_rows(*pending[nxt])
            nxt += 1
        view_next[i] = nxt
    floor = int(view_next.min()) if len(view_next) else 0
    for k in [k for k in pending if k < floor]:
        del pending[k]


class GeoCluster:
    """Full-replica multi-master cluster over a simulated WAN, its store on
    ``device`` (``cuda`` unless the caller names another).

    ``wan_mask`` (bool n x n): which links are WAN; when given, per-epoch
    ``wan_bytes`` counts only those links (the paper's NIC-level
    inter-region egress, Sec 6.1).  ``control`` is a
    ``repro_torch.control.ControlPlane``; the engine pushes each epoch's
    latency matrix through it and takes the damped plan back, so every
    other subscriber observes the same ``PlanChanged`` events.  When
    omitted, the engine builds its own from the config's replan parameters.

    ``store`` is made on the first :meth:`run` from its generator's key
    space (``generator.table``), unless set before: a store loaded before
    epoch 0 (``generator.load``) is state carried in, as the reference's
    ``GeoCluster.store`` set before ``run()`` is.  ``epoch_times`` holds
    each epoch's wall split (of the epochs whose ``EpochStats`` the run
    keeps): host draws, the batch's copy to the device
    with its gathers, device work (validation, filters, commit, each ending
    in a synchronise) and host work (planning, schedules, the simulator);
    on the streaming engine also ``views_s``, the views' advances between
    two synchronises (0 without ``staleness_feedback``); under
    ``compression`` also the WAN payloads' compression, apart from the
    rest: ``stream_s`` (the records' streams built on the device, between
    synchronises), ``stream_copy_s`` (their copies to the host) and
    ``zlib_s`` (the payloads' cuts and zlib on the host), with the bytes
    ``stream_bytes`` (the stream), ``zlib_in_bytes`` and ``zlib_out_bytes``.

    Under ``staleness_feedback`` each node's view starts as a copy of the
    store as it stands when ``run()`` begins (the reference starts its views
    empty even on a store set before ``run()``: fault 15, not copied), and
    ``view_merges`` counts the run's view advances that launched the join.
    """

    def __init__(
        self,
        cfg: EngineConfig,
        *,
        control=None,
        bandwidth_mbps: np.ndarray | float = np.inf,
        loss: np.ndarray | float = 0.0,
        wan_mask: np.ndarray | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bandwidth = bandwidth_mbps
        self.loss = loss
        self.wan_mask = wan_mask
        self.store: CRDTTable | None = None
        self.rng = np.random.default_rng(seed)
        self._schedule_fn = _strategies.get("schedule", cfg.resolved_schedule_name)
        self._flat_schedule_fn = _strategies.get("schedule", "all_to_all")
        self._filter_fn = _strategies.get("filter", cfg.resolved_filter_name)
        validate_config(cfg, stage="cluster")
        self._schedule_takes_compute = False
        if cfg.grouping:
            # builders that accept group_compute_ms get the per-group filter
            # CPU charged on their exchange edges
            params = inspect.signature(self._schedule_fn).parameters
            self._schedule_takes_compute = "group_compute_ms" in params
        self.plan_time_s = 0.0
        self._payload_ewma = 0.0   # observed per-node epoch payload (bytes)
        self._keep_ewma = 1.0      # observed post-filter keep ratio
        self.control = self._wire_control(control)
        self.msg_matrix = np.zeros((cfg.n_nodes, cfg.n_nodes), dtype=int)
        # as many epochs as the run keeps EpochStats of
        self.epoch_times: collections.deque[dict[str, float]] = collections.deque(
            maxlen=None if cfg.keep_epochs else cfg.stats_window)
        self._device_s = 0.0
        self._zlib = dict.fromkeys(_ZLIB_PARTS + _ZLIB_BYTES, 0)
        self.view_merges = 0

    def _wire_control(self, control):
        """Attach to (or build) the network control plane and bind the
        engine's bandwidth/payload-aware plan ranking, unless a
        better-informed planner is already bound."""
        from ..control.plane import ControlPlane

        cfg = self.cfg
        if control is None:
            control = ControlPlane(
                replan_threshold=cfg.replan_threshold,
                replan_sustain=cfg.replan_sustain,
                tiv=cfg.tiv,
                tiv_margin=cfg.tiv_margin,
            )
        control.bind_planner(self._plan_fn)
        return control

    def _plan_fn(self, lat: np.ndarray) -> GroupPlan:
        """Bandwidth/payload-aware plan ranking (Sec 4.1), fed by per-epoch
        payload observations."""
        cfg = self.cfg
        t0 = time.perf_counter()  # lint: allow[wallclock] plan-search cost
        plan = best_plan(
            lat,
            tiv=cfg.tiv,
            tiv_margin=cfg.tiv_margin,
            method=cfg.planner,
            time_limit_s=cfg.planner_time_limit_s,
            payload_bytes=self._payload_ewma or None,
            bandwidth_mbps=self.bandwidth,
            filter_keep=self._keep_ewma if cfg.filtering else 1.0,
            barrier=cfg.barrier,
            streaming=cfg.streaming,
        )
        self.plan_time_s += time.perf_counter() - t0  # lint: allow[wallclock] plan-search cost
        return plan

    def _synced(self, fn, *args, **kw):
        """``fn(*args, **kw)`` between two synchronises; returns its result
        and its wall time."""
        synchronize(self.device)
        t0 = time.perf_counter()  # lint: allow[wallclock] measured device work
        out = fn(*args, **kw)
        synchronize(self.device)
        return out, time.perf_counter() - t0  # lint: allow[wallclock] measured device work

    def _on_device(self, fn, *args, **kw):
        """:meth:`_synced`, its wall time added to the epoch's device work."""
        out, dt = self._synced(fn, *args, **kw)
        self._device_s += dt
        return out, dt

    # -- one epoch -------------------------------------------------------------

    def _node_bytes(self, batch: EpochBatch) -> np.ndarray:
        """Each node's update bytes this epoch, as the reference's float
        array of integer sums."""
        n = self.cfg.n_nodes
        sums = torch.zeros(n, dtype=torch.int64, device=self.device)
        sums.index_add_(0, batch.node[batch.write_txn], batch.write_nbytes())
        out = np.zeros(n)
        out[:] = sums.tolist()
        return out

    def _compressed_payloads(self, batch: EpochBatch, groups: list[list[int]],
                             kept: list[torch.Tensor],
                             ) -> tuple[np.ndarray, list[int], list[int], list[float]]:
        """The epoch's payloads sized as the reference's ``_compressed_size``
        does: each node's (all of its transactions' updates, those that will
        abort too, in batch order) and each group's kept updates (``kept[j]``
        a mask over the writes of ``groups[j]``'s transactions, member by
        member, each member's in batch order).  One stream of the epoch's
        records, node by node, is built on the device
        (``CRDTTable.record_bytes``) and copied to the host with the masks
        once; each payload is cut from it and compressed there.  Returns the
        node sizes, each group's size and its kept updates' ``nbytes``
        (stream bytes + 24 a record), and each group's seconds: its own cut
        and zlib, and the build's and copy's share of its kept bytes.  The
        build, the copy, zlib, the stream's bytes and zlib's bytes in and
        out are added to the epoch's record."""
        n = self.cfg.n_nodes
        synchronize(self.device)
        t0 = time.perf_counter()  # lint: allow[wallclock] measured compression
        wnode = batch.node[batch.write_txn]
        order = torch.sort(wnode, stable=True).indices
        stream, reclen = self.store.record_bytes(batch.write_row[order], batch.write_val[order],
                                                 batch.write_len[order])
        counts = torch.bincount(wnode, minlength=n)
        masks = torch.cat(kept) if kept else torch.zeros(0, dtype=torch.bool, device=self.device)
        synchronize(self.device)
        t1 = time.perf_counter()  # lint: allow[wallclock] measured compression
        host, lens = stream.cpu().numpy(), reclen.cpu().numpy()
        counts, masks = counts.cpu().numpy(), masks.cpu().numpy()
        t2 = time.perf_counter()  # lint: allow[wallclock] measured compression
        ends = np.concatenate([[0], np.cumsum(lens)])      # each record's first byte
        first = np.concatenate([[0], np.cumsum(counts)])   # each node's first record
        zin = zout = 0

        def size(blob: np.ndarray, records: int) -> int:
            nonlocal zin, zout
            if not blob.size:
                return 0
            out = len(zlib.compress(blob, _ZLIB_LEVEL))
            zin, zout = zin + blob.size, zout + out
            return out + 24 * records

        node = np.array([size(host[ends[first[i]]:ends[first[i + 1]]], int(counts[i]))
                         for i in range(n)], dtype=float)
        shared_s = (t2 - t0) / max(host.size, 1)   # build and copy, a byte
        sizes, nbytes, secs, at = [], [], [], 0
        for group in groups:
            ta = time.perf_counter()  # lint: allow[wallclock] measured compression
            recs = np.concatenate([np.arange(first[i], first[i + 1]) for i in group] or
                                  [np.zeros(0, dtype=np.int64)])
            sel = recs[masks[at:at + recs.size]]
            at += recs.size
            # the kept records in order, each run of adjacent ones one slice
            blob = host[:0]
            if sel.size:
                brk = np.flatnonzero(np.diff(sel) != 1) + 1
                runs = zip(sel[np.r_[0, brk]], sel[np.r_[brk - 1, sel.size - 1]] + 1)
                blob = np.concatenate([host[ends[a]:ends[b]] for a, b in runs])
            sizes.append(size(blob, sel.size))
            nbytes.append(blob.size + 24 * sel.size)
            tb = time.perf_counter()  # lint: allow[wallclock] measured compression
            secs.append(tb - ta + blob.size * shared_s)
        t4 = time.perf_counter()  # lint: allow[wallclock] measured compression
        for key, v in zip(_ZLIB_PARTS + _ZLIB_BYTES,
                          (t1 - t0, t2 - t1, t4 - t2, host.size, zin, zout)):
            self._zlib[key] += v
        return node, sizes, nbytes, secs

    def _prepare_epoch(self, epoch: int, batch: EpochBatch, lat: np.ndarray,
                       views: list[CRDTTable] | None = None) -> _EpochRound:
        """Everything timing-independent about one epoch: planning, filtering,
        schedule construction, deterministic validation and the CRDT commit.
        The simulator never touches the store, so the commit is the same
        whichever engine (barrier / event / streaming) later times the round.

        ``views`` (``staleness_feedback`` only) are the per-node snapshot
        views: each group's aggregator filters against its own view instead
        of the global store (a stale view holds smaller versions, so the
        stale and null rules fire less; they stay sound), and the round
        keeps its committed rows for the views to merge.  Validation always
        runs against the global store: every replica holds the whole
        epoch's metadata by commit time."""
        cfg = self.cfg
        n = cfg.n_nodes
        snapshot = self.store  # epoch-start replicated snapshot

        n_txns = batch.n_txns
        counts = torch.bincount(batch.node, minlength=n).tolist()
        node_exec_ms = np.array([counts[i] * cfg.txn_exec_us / 1e3 for i in range(n)],
                                dtype=float)
        exec_ms = float(node_exec_ms.max()) if n else 0.0

        filter_cpu_ms = 0.0
        fstats: FilterStats | None = None
        node_payload, _ = self._on_device(self._node_bytes, batch)

        if cfg.grouping:
            # the bandwidth-aware planner needs the payload estimate before
            # the (damped) plan request
            mean_payload = float(np.mean(node_payload)) if n else 0.0
            self._payload_ewma = (
                0.7 * self._payload_ewma + 0.3 * mean_payload
                if self._payload_ewma
                else mean_payload
            )
            plan = self.control.observe(lat)
            # validation metadata flows globally; filtering strips white-data
            # payloads only, so the commit is the baseline's
            group_payload = np.zeros(plan.k)
            group_cpu_ms = np.zeros(plan.k)
            fstats = FilterStats()
            kept = []   # each group's kept writes (compression)
            for j, (group, agg) in enumerate(zip(plan.groups, plan.aggregators)):
                gbatch = batch.select(batch.node_txns(group))
                # the aggregator filters against the state it holds: its own
                # view under staleness_feedback, the global store otherwise
                fsnap = snapshot if views is None else views[agg]
                fr, dt = self._on_device(self._filter_fn, gbatch, fsnap)
                if cfg.filtering:
                    # the no_filter passthrough's byte accounting is not a
                    # filtering cost: the baseline's filter CPU stays 0
                    if cfg.modeled_cpu:
                        dt_ms = fr.stats.total_bytes * cfg.filter_cpu_ns_per_byte / 1e6
                    else:
                        dt_ms = dt * 1e3
                    filter_cpu_ms += dt_ms
                    group_cpu_ms[j] += dt_ms
                fstats = fstats.merge(fr.stats)
                if cfg.compression:
                    # the kept updates in full (a null one's payload too),
                    # a validation tombstone for each dropped one
                    kept.append(fr.kept)
                    group_payload[j] = 24 * (fr.stats.total_updates - fr.stats.kept_updates)
                else:
                    group_payload[j] = fr.stats.wire_bytes
            if cfg.compression:
                node_payload, sizes, nbytes, secs = self._compressed_payloads(
                    batch, plan.groups, kept)
                group_payload += sizes
                if cfg.modeled_cpu:
                    group_cpu_ms += np.array(nbytes) * _COMPRESS_NS_PER_BYTE / 1e6
                else:
                    group_cpu_ms += np.array(secs) * 1e3
            sched_kw = {}
            modeled_cpu_ms = 0.0
            if self._schedule_takes_compute and not cfg.barrier:
                sched_kw["group_compute_ms"] = group_cpu_ms
                modeled_cpu_ms = float(group_cpu_ms.sum())
            schedule = self._schedule_fn(
                plan,
                node_payload,
                group_payload_bytes=group_payload,
                lat=lat,
                tiv=cfg.tiv,
                tiv_margin=cfg.tiv_margin,
                **sched_kw,
            )
            plan_method = plan.method
        else:
            if cfg.compression:
                node_payload = self._compressed_payloads(batch, [], [])[0]
            schedule = self._flat_schedule_fn(n, node_payload)
            plan_method = "none"
            modeled_cpu_ms = 0.0

        # feed filter observations to the bandwidth-aware planner
        if cfg.grouping and cfg.filtering and fstats is not None and fstats.total_bytes:
            keep = fstats.wire_bytes / fstats.total_bytes
            self._keep_ewma = 0.7 * self._keep_ewma + 0.3 * keep

        # deterministic global validation against the epoch-start snapshot,
        # then the CRDT join of the committed writes
        (committed, read_aborts, ww_aborts, delta), _ = self._on_device(self._commit, batch)
        return _EpochRound(
            epoch=epoch,
            schedule=schedule,
            n_txns=n_txns,
            committed=committed,
            aborted=n_txns - committed,
            read_aborts=read_aborts,
            ww_aborts=ww_aborts,
            exec_ms=exec_ms,
            node_exec_ms=node_exec_ms,
            filter_cpu_ms=filter_cpu_ms,
            fstats=fstats,
            plan_method=plan_method,
            modeled_cpu_ms=modeled_cpu_ms,
            delta=delta if views is not None else None,
        )

    def _commit(self, batch: EpochBatch) -> tuple[int, int, int, tuple[torch.Tensor, ...]]:
        """Validate the epoch and join its committed writes into the store;
        returns (committed, read-aborted, write-write-aborted) counts (the
        generator's transaction ids are unique) and the committed rows,
        reduced to distinct rows (what the views join)."""
        vres = validate_epoch_detailed(batch, self.store)
        ok = vres.committed_mask
        w = ok[batch.write_txn]
        t = batch.write_txn[w]
        vers = torch.stack([batch.epoch[t], batch.seq[t], batch.node[t]], 1)
        delta = self.store.top_rows(batch.write_row[w], batch.write_val[w], vers,
                                    batch.write_len[w])
        self.store.join_rows(*delta)
        committed, ra, wa = torch.stack([ok.sum(), vres.read_mask.sum(),
                                         vres.ww_mask.sum()]).tolist()
        return committed, ra, wa, delta

    def _epoch_stats(self, rnd: _EpochRound, sim: WANSimulator, res, *,
                     wall_ms: float | None = None, pipeline_overlap_ms: float = 0.0,
                     stream_commit_ms: float = 0.0, view_lag_mean: float = 0.0,
                     view_lag_max: int = 0) -> EpochStats:
        """Assemble one epoch's stats from its (isolated) round simulation;
        the streaming engine passes the measured stream's figures."""
        cfg = self.cfg
        schedule = rnd.schedule
        if cfg.barrier:
            # the barrier engine does not model CPU inside the round, so
            # serial == sync and nothing is hidden
            sync_serial_ms = res.makespan_ms
            sync_overlap_ms = 0.0
            cpu_hidden_ms = 0.0
            wan_overlap_ms = 0.0
        else:
            # serialized reference: barrier phase-sum + back-to-back CPU;
            # with bandwidth admission serial == sync + overlap exactly
            sync_serial_ms = sim.barrier_makespan_ms(schedule) + rnd.modeled_cpu_ms
            sync_overlap_ms = sync_serial_ms - res.makespan_ms
            # CPU "on the path" gated a critical-path transfer's wire start;
            # the rest was hidden behind other groups' transfers
            cpu_on_path_ms = 0.0
            for i in res.critical_path:
                t = schedule.transfers[i]
                if t.compute_ms <= 0.0:
                    continue
                ready = max((float(res.finish_ms[d]) for d in t.deps), default=0.0)
                gap = max(float(res.start_ms[i]) - ready, 0.0)
                cpu_on_path_ms += min(t.compute_ms, gap)
            cpu_hidden_ms = max(rnd.modeled_cpu_ms - cpu_on_path_ms, 0.0)
            wan_overlap_ms = sync_overlap_ms - cpu_hidden_ms
        if self.wan_mask is not None:
            wan_bytes = float((res.link_bytes * self.wan_mask).sum())
        else:
            wan_bytes = res.total_bytes
        if wall_ms is None:
            wall_ms = max(cfg.epoch_ms, rnd.exec_ms, res.makespan_ms)
        return EpochStats(
            epoch=rnd.epoch,
            n_txns=rnd.n_txns,
            committed=rnd.committed,
            aborted=rnd.aborted,
            sync_ms=res.makespan_ms,
            exec_ms=rnd.exec_ms,
            wall_ms=wall_ms,
            wan_bytes=wan_bytes,
            filter_stats=rnd.fstats,
            filter_cpu_ms=rnd.filter_cpu_ms,
            plan_method=rnd.plan_method,
            sync_serial_ms=sync_serial_ms,
            sync_overlap_ms=sync_overlap_ms,
            sync_cpu_hidden_ms=cpu_hidden_ms,
            sync_wan_overlap_ms=wan_overlap_ms,
            pipeline_overlap_ms=pipeline_overlap_ms,
            stream_commit_ms=stream_commit_ms,
            read_aborts=rnd.read_aborts,
            ww_aborts=rnd.ww_aborts,
            view_lag_mean=view_lag_mean,
            view_lag_max=view_lag_max,
        )

    def _round(self, epoch: int, batch: EpochBatch, lat: np.ndarray,
               views: list[CRDTTable] | None = None):
        """One epoch prepared and its round simulated in isolation; returns
        the round, its simulator and its result."""
        rnd = self._prepare_epoch(epoch, batch, lat, views=views)
        sim = WANSimulator(lat, self.bandwidth, loss=self.loss, rng=self.rng,
                           barrier=self.cfg.barrier, verify=self.cfg.verify_schedules)
        res = sim.run(rnd.schedule)
        self.msg_matrix += res.msg_matrix
        return rnd, sim, res

    def run_epoch(self, epoch: int, batch: EpochBatch, lat: np.ndarray) -> EpochStats:
        return self._epoch_stats(*self._round(epoch, batch, lat))

    def _draw_batch(self, generator, epoch: int, txns_per_node: int, snapshot):
        """The epoch's host draws and its batch on the device (``snapshot``
        the store, or one view a node); returns the batch and the epoch's
        wall split so far.  The epoch's device work is counted from here."""
        t0 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
        draws = generator.draw(epoch, txns_per_node)
        t1 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
        batch = generator.to_batch(draws, snapshot)
        synchronize(self.device)
        t2 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
        self._device_s = 0.0
        self._zlib = dict.fromkeys(_ZLIB_PARTS + _ZLIB_BYTES, 0)
        return batch, {"draw_s": t1 - t0, "copy_s": t2 - t1, "t2": t2}

    def _close_times(self, times: dict, views_s: float | None = None) -> None:
        """Keep the epoch's wall split: the draws, the copy, device work,
        compression's parts under ``compression``, the rest as host work
        (and on the streaming engine the views')."""
        t3 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
        parts = _ZLIB_PARTS if self.cfg.compression else ()
        zlib_s = sum(self._zlib[k] for k in parts)
        out = {"draw_s": times["draw_s"], "copy_s": times["copy_s"],
               "device_s": self._device_s, "host_s": t3 - times["t2"] - self._device_s - zlib_s,
               **{k: self._zlib[k] for k in parts + (_ZLIB_BYTES if parts else ())}}
        if views_s is not None:
            out["views_s"] = views_s
        self.epoch_times.append(out)

    # -- full run ----------------------------------------------------------------

    def run(self, generator, trace, *, txns_per_node: int = 20,
            n_epochs: int | None = None) -> RunStats:
        """``n_epochs`` epochs (default ``len(trace)``) of ``generator``'s
        transactions, epoch ``e`` on ``trace[e % len(trace)]``.  A generator
        (``YCSBGenerator``, ``TPCCGenerator``, a ``DiurnalLoad`` around
        either) gives ``table(device)``, each epoch's host ``draw(epoch,
        txns_per_node)`` and its ``to_batch(draws, snapshot)`` on the store's
        device (``snapshot`` the store, or under ``staleness_feedback`` one
        view a node).  The run ends in both digests, from one pass over the
        store."""
        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else len(trace)
        if self.store is None:
            self.store = generator.table(self.device)
        agg = RunAggregator(keep_epochs=cfg.keep_epochs, window=cfg.stats_window)
        serve_stats = None
        if cfg.streaming:
            serve_stats = self._run_streaming(generator, trace, txns_per_node, n_epochs, agg)
        else:
            for e in range(n_epochs):
                batch, times = self._draw_batch(generator, e, txns_per_node, self.store)
                agg.on_epoch(self.run_epoch(e, batch, trace[e % len(trace)]))
                self._close_times(times)
        state_digest, value_digest = self.store.digests()
        return RunStats(
            epochs=agg.epochs,
            msg_matrix=self.msg_matrix.copy(),
            plan_time_s=self.plan_time_s,
            state_digest=state_digest,
            value_digest=value_digest,
            serve=serve_stats,
            summary=agg.summary,
        )

    # -- the streaming engine ----------------------------------------------------

    def _stream_prefix(self, rounds: list[_EpochRound], lats):
        """Stitch the epochs prepared so far and run the streaming event
        simulation over them (``lats`` an ``EpochLatencyCycle``).  Returns
        (per-node commit-time matrix, stream RoundResult, stitched schedule).
        The O(E²) oracle (``stream_mode="resim"``): with feedback it
        re-simulates the whole prefix every epoch."""
        cfg = self.cfg
        stitched = stitch_schedules(
            [r.schedule for r in rounds],
            node_exec_ms=[r.node_exec_ms for r in rounds],
            epoch_ms=cfg.epoch_ms,
            n=cfg.n_nodes,
        )
        stream_sim = WANSimulator(lats[0], self.bandwidth, loss=self.loss, rng=self.rng,
                                  verify=cfg.verify_schedules)
        stream = stream_sim.run(stitched, lats=lats)
        commits = node_commit_ms(stitched, stream, cfg.n_nodes, len(rounds))
        return commits, stream, stitched

    def _start_views(self):
        """Under ``staleness_feedback``: one view a node, each a copy of the
        store as it stands, and each node's next epoch to merge; else
        ``(None, None)``."""
        self.view_merges = 0
        if not self.cfg.staleness_feedback:
            return None, None
        return ([self.store.snapshot() for _ in range(self.cfg.n_nodes)],
                np.zeros(self.cfg.n_nodes, dtype=int))

    def _advance(self, views, view_next, pending, commit_at, n_done: int, e: int):
        """Advance the views to epoch ``e``'s arrival, between two
        synchronises; returns the lag (mean, max) over nodes and the time."""
        if views is None:
            return 0.0, 0, 0.0
        _, dt = self._synced(advance_views, self.cfg.n_nodes, views, view_next, pending,
                             commit_at, n_done, e * self.cfg.epoch_ms)
        self.view_merges = sum(v.merges for v in views)
        lag = e - view_next
        return (float(lag.mean()) if lag.size else 0.0,
                int(lag.max()) if lag.size else 0, dt)

    def _run_streaming(self, generator, trace, txns_per_node: int, n_epochs: int,
                       agg: RunAggregator) -> ServeStats | None:
        """Cross-epoch streaming: stitch every epoch's DAG and measure real
        per-epoch commit times from one event-driven simulation.

        Each epoch still runs its round in isolation: that simulation is the
        reference the stats are split against (sync_ms, the serial/overlap
        split, byte accounting) and what ``pipeline_overlap_ms`` compares
        the measured wall clock with.  The commits are the formula engine's,
        so with ``staleness_feedback=False`` the digests are too.

        With ``staleness_feedback=True`` epoch ``e`` executes when it
        arrives (``e * epoch_ms``) against each node's view, which has
        joined exactly the epochs whose inbound transfers the stream has
        delivered to that node by then; the read rule then aborts the
        transactions whose reads the backlog made stale.  Each epoch's
        committed rows stay on the card until every view has merged past
        them.

        ``stream_mode="incremental"`` appends each epoch onto a
        ``StreamingTimeline`` that simulates only its events (under
        bandwidth admission an earlier epoch's times are final the moment it
        is appended), pushes each epoch's stats at once and keeps the
        commit rows only down to the slowest view's frontier;
        ``stream_mode="resim"`` re-simulates the whole stitched prefix (the
        O(E²) oracle, equal times) and assembles the stats at the end.

        Under ``serve`` the serving plane reads each epoch's commit row and
        latency matrix: a ``ServingSink`` beside the aggregator on the
        incremental path, ``simulate_serving`` over the whole commit matrix
        on the resim one (equal reports).  Returns its report, or ``None``."""
        if self.cfg.stream_mode == "incremental":
            return self._run_streaming_incremental(generator, trace, txns_per_node, n_epochs,
                                                   agg)
        return self._run_streaming_resim(generator, trace, txns_per_node, n_epochs, agg)

    def _run_streaming_incremental(self, generator, trace, txns_per_node: int,
                                   n_epochs: int, agg: RunAggregator) -> ServeStats | None:
        cfg = self.cfg
        lat_cycle = EpochLatencyCycle(trace, max(n_epochs, 1))
        timeline = StreamingTimeline(cfg.n_nodes, bandwidth_mbps=self.bandwidth,
                                     loss=self.loss, epoch_ms=cfg.epoch_ms,
                                     verify=cfg.verify_schedules)
        serve_sink = None
        sinks: list[EpochSink] = [agg]
        if cfg.serve is not None:
            from ..serve.plane import ServingSink

            serve_sink = ServingSink(cfg.serve, cfg.n_nodes, cfg.epoch_ms)
            sinks.append(serve_sink)
        views, view_next = self._start_views()
        # each epoch's committed rows on the card until every view has them
        pending: dict[int, tuple[torch.Tensor, ...]] = {}
        prev_commit = 0.0
        for e in range(n_epochs):
            lat = lat_cycle[e]
            lag_mean, lag_max, views_s = self._advance(views, view_next, pending,
                                                       timeline.commit_at,
                                                       timeline.n_epochs, e)
            batch, times = self._draw_batch(generator, e, txns_per_node,
                                            self.store if views is None else views)
            rnd, sim, res = self._round(e, batch, lat, views)
            # O(this epoch's events); its times are final once appended
            et = timeline.append_epoch(rnd.schedule, lat, node_exec_ms=rnd.node_exec_ms)
            commit = et.finish_max_ms
            wall = commit - prev_commit
            prev_commit = commit
            formula = max(cfg.epoch_ms, rnd.exec_ms, res.makespan_ms)
            stats = self._epoch_stats(rnd, sim, res, wall_ms=wall,
                                      pipeline_overlap_ms=formula - wall,
                                      stream_commit_ms=commit, view_lag_mean=lag_mean,
                                      view_lag_max=lag_max)
            ctx = EpochContext(epoch=e, commit_row=et.commit_ms, lat=lat)
            for sink in sinks:
                sink.on_epoch(stats, ctx)
            if views is not None:
                pending[e] = rnd.delta
                # commit rows below the slowest view's frontier are never
                # read again
                timeline.evict_commit_rows(int(view_next.min()))
            else:
                timeline.evict_commit_rows(timeline.n_epochs)
            self._close_times(times, views_s)
        if serve_sink is None or n_epochs == 0:
            return None
        # the clients' window is the whole run even where the last commit
        # lands inside it
        return serve_sink.finish(wall_ms=max(prev_commit, n_epochs * cfg.epoch_ms))

    def _run_streaming_resim(self, generator, trace, txns_per_node: int,
                             n_epochs: int, agg: RunAggregator) -> ServeStats | None:
        cfg = self.cfg
        lat_cycle = EpochLatencyCycle(trace, max(n_epochs, 1))
        rounds: list[_EpochRound] = []
        sims: list[WANSimulator] = []
        results = []
        lags: list[tuple[float, int]] = []
        views, view_next = self._start_views()
        pending: dict[int, tuple[torch.Tensor, ...]] = {}
        commit_ms = np.zeros((0, cfg.n_nodes))
        stream = stitched = None
        for e in range(n_epochs):
            lat = lat_cycle[e]
            lag_mean, lag_max, views_s = self._advance(
                views, view_next, pending, lambda k, i, _c=commit_ms: float(_c[k, i]),
                commit_ms.shape[0], e)
            lags.append((lag_mean, lag_max))
            batch, times = self._draw_batch(generator, e, txns_per_node,
                                            self.store if views is None else views)
            rnd, sim, res = self._round(e, batch, lat, views)
            rounds.append(rnd)
            sims.append(sim)
            results.append(res)
            if views is not None:
                pending[e], rnd.delta = rnd.delta, None
                # measured staleness for the next epoch's views; the last
                # prefix is the whole stream the stats read
                commit_ms, stream, stitched = self._stream_prefix(rounds, lat_cycle)
            self._close_times(times, views_s)
        if not rounds:
            return None
        if stream is None:
            commit_ms, stream, stitched = self._stream_prefix(rounds, lat_cycle)
        # each epoch's absolute commit mark in one grouped pass
        epoch_of = np.array([t.epoch for t in stitched.transfers])
        commit_marks = np.full(len(rounds), -np.inf)
        np.maximum.at(commit_marks, epoch_of, stream.finish_ms)
        prev_commit = 0.0
        for k, (rnd, sim, res) in enumerate(zip(rounds, sims, results)):
            commit = float(commit_marks[k])
            wall = commit - prev_commit
            prev_commit = commit
            formula = max(cfg.epoch_ms, rnd.exec_ms, res.makespan_ms)
            agg.on_epoch(self._epoch_stats(rnd, sim, res, wall_ms=wall,
                                           pipeline_overlap_ms=formula - wall,
                                           stream_commit_ms=commit, view_lag_mean=lags[k][0],
                                           view_lag_max=lags[k][1]),
                         EpochContext(epoch=k, commit_row=commit_ms[k], lat=lat_cycle[k]))
        if cfg.serve is None:
            return None
        from ..serve.plane import simulate_serving

        return simulate_serving(cfg.serve, commit_ms, lat_cycle, cfg.epoch_ms,
                                wall_ms=max(prev_commit, n_epochs * cfg.epoch_ms))


# ---------------------------------------------------------------------------
# Raft / CockroachDB plane (Sec 5 "Extensions", Fig 11b)
# ---------------------------------------------------------------------------


class RaftCluster:
    """Leader-based replication with optional GeoCoCo relay of AppendEntries
    (the reference's ``RaftCluster``, host numpy: it holds no state and
    times quorums only).

    Ranges are hashed to leaders; a write batch commits once a majority of
    replicas ack.  GeoCoCo hooks RaftTransport: the leader sends one copy per
    group to the aggregator, which relays to members; acks travel back the
    same path.  Quorum semantics are unchanged (the paper's non-intrusive
    integration).

    Commit latency runs the replication fan-out through the **event-driven
    simulator** (``leader_schedule`` -> per-follower delivery times + ack
    propagation back): with constrained bandwidth the leader's NIC
    serializes its appends, so the quorum time reflects contention — the
    closed-form hop sums (kept as a private reference) charge every hop an
    uncontended wire and agree with the event engine exactly on
    contention-free (infinite-bandwidth) matrices.  Results are memoized
    per ``(latency matrix, leader, payload)`` — one epoch's batches all see
    the same network, so per-txn recomputation was pure waste (the plan
    search is also cached per matrix).
    """

    def __init__(
        self,
        n_nodes: int,
        *,
        grouping: bool = True,
        tiv: bool = True,
        planner: str = "kcenter",
        bandwidth_mbps: np.ndarray | float = np.inf,
        loss: np.ndarray | float = 0.0,
        seed: int = 0,
    ):
        self.n = n_nodes
        self.grouping = grouping
        self.tiv = tiv
        self.planner = planner
        self.bandwidth = bandwidth_mbps
        self.loss = loss
        self.rng = np.random.default_rng(seed)
        self._commit_cache: dict[tuple, float] = {}
        self._plan_cache: dict[bytes, "GroupPlan"] = {}
        self.commit_cache_hits = 0

    # -- quorum helpers --------------------------------------------------------

    def _ack_ms(self, lat: np.ndarray) -> np.ndarray:
        """Per-node ack-return latency to the leader's column: TIV-effective
        on the grouped (overlay) path, direct otherwise — matching the
        deployment (Sec 5 deploys relays on the grouped WAN paths)."""
        if self.grouping and self.tiv:
            eff, _ = one_relay_effective(lat, margin=0.05)
            return eff
        return lat

    def _plan(self, lat: np.ndarray, key: bytes) -> "GroupPlan":
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = best_plan(lat, tiv=self.tiv, method=self.planner)
            self._plan_cache[key] = plan
        return plan

    def _quorum_ms(self, res, transfers, leader: int, ack: np.ndarray,
                   epoch: int | None = None) -> float:
        """Majority-quorum commit time from an event-engine result: each
        follower's delivery plus its ack back to the leader, quorum-th
        smallest (leader + quorum followers = majority).  ``epoch``
        restricts to one batch of a stitched multi-batch stream."""
        times = [
            float(res.finish_ms[i]) + float(ack[t.dst, leader])
            for i, t in enumerate(transfers)
            if t.dst != leader and t.src != t.dst
            and (epoch is None or t.epoch == epoch)
        ]
        times.sort()
        quorum = self.n // 2
        return float(times[quorum - 1]) if quorum >= 1 else 0.0

    def commit_latency_ms(
        self, lat: np.ndarray, leader: int, payload_bytes: float
    ) -> float:
        """Latency for one replicated batch to reach majority quorum,
        measured by the event engine (memoized per matrix/leader/payload)."""
        lat = np.asarray(lat, dtype=float)
        mat_key = lat.tobytes()
        key = (mat_key, int(leader), float(payload_bytes))
        hit = self._commit_cache.get(key)
        if hit is not None:
            self.commit_cache_hits += 1
            return hit
        sim = WANSimulator(lat, self.bandwidth, loss=self.loss, rng=self.rng)
        plan = self._plan(lat, mat_key) if self.grouping else None
        sched = leader_schedule(self.n, leader, payload_bytes, plan)
        res = sim.run(sched)
        val = self._quorum_ms(res, sched.transfers, leader, self._ack_ms(lat))
        self._commit_cache[key] = val
        return val

    def _closed_form_commit_latency_ms(
        self, lat: np.ndarray, leader: int, payload_bytes: float
    ) -> float:
        """The pre-event-engine hop-sum model, kept as the contention-free
        reference: every hop pays propagation + an *uncontended* wire, so it
        matches the event engine exactly when bandwidth is infinite (and
        undercounts the leader's NIC serialization otherwise).  Mirrors
        ``leader_schedule``'s paths: the leader relays directly to its own
        group's members."""
        n = self.n
        sim = WANSimulator(lat, self.bandwidth, loss=self.loss, rng=self.rng)
        ack = self._ack_ms(lat)
        times = []
        if not self.grouping:
            for f in range(n):
                if f != leader:
                    times.append(
                        sim._hop_time(leader, f, payload_bytes)
                        + ack[f, leader]
                    )
        else:
            plan = self._plan(np.asarray(lat, dtype=float),
                              np.asarray(lat, dtype=float).tobytes())
            for g, a in zip(plan.groups, plan.aggregators):
                tgt = a if leader not in g else leader
                first = (
                    sim._hop_time(leader, tgt, payload_bytes)
                    if tgt != leader else 0.0
                )
                for f in g:
                    if f == leader:
                        continue
                    hop = 0.0 if f == tgt else sim._hop_time(tgt, f, payload_bytes)
                    times.append(first + hop + ack[f, leader])
        times.sort()
        quorum = n // 2
        return float(times[quorum - 1]) if quorum >= 1 else 0.0

    def pipelined_commit_ms(
        self, lat: np.ndarray, leader: int, payload_bytes: float,
        batches: int,
    ) -> float:
        """Commit time of the *last* of ``batches`` replication batches
        pipelined through one stitched leader-schedule stream.

        The batches share one event simulation
        (:func:`~repro_torch.core.schedule.stitch_schedules` chains the per-batch
        leader DAGs; bandwidth admission serializes same-NIC appends in
        batch order), so in-flight batches contend for the leader's NIC
        instead of replicating for free.  On contention-free
        (infinite-bandwidth) matrices every batch streams at propagation
        speed and the last batch commits exactly when a single batch would
        — recovering the historical independent-batch model.  Memoized per
        ``(matrix, leader, payload, batches)``.
        """
        if batches <= 1:
            return self.commit_latency_ms(lat, leader, payload_bytes)
        lat = np.asarray(lat, dtype=float)
        mat_key = lat.tobytes()
        key = (mat_key, int(leader), float(payload_bytes), int(batches))
        hit = self._commit_cache.get(key)
        if hit is not None:
            self.commit_cache_hits += 1
            return hit
        plan = self._plan(lat, mat_key) if self.grouping else None
        one = leader_schedule(self.n, leader, payload_bytes, plan)
        # incremental timeline: only the last batch's segment matters for
        # the quorum, and appending is O(batch) instead of re-simulating
        # the whole stitched stream (byte-identical — see repro_torch.core.stream;
        # _pipelined_commit_ms_resim is the tested oracle)
        timeline = StreamingTimeline(self.n, bandwidth_mbps=self.bandwidth,
                                     loss=self.loss)
        for _ in range(batches):
            et = timeline.append_epoch(one, lat)
        val = self._quorum_ms(et, et.transfers, leader,
                              self._ack_ms(lat), epoch=batches - 1)
        self._commit_cache[key] = val
        return val

    def _pipelined_commit_ms_resim(
        self, lat: np.ndarray, leader: int, payload_bytes: float,
        batches: int,
    ) -> float:
        """O(batches²) reference oracle for :meth:`pipelined_commit_ms`:
        stitch every batch and re-run the full event simulation.  Kept
        uncached for the incremental-identity regression tests."""
        lat = np.asarray(lat, dtype=float)
        sim = WANSimulator(lat, self.bandwidth, loss=self.loss, rng=self.rng)
        plan = self._plan(lat, lat.tobytes()) if self.grouping else None
        one = leader_schedule(self.n, leader, payload_bytes, plan)
        stitched = stitch_schedules([one] * batches, n=self.n)
        res = sim.run(stitched)
        return self._quorum_ms(res, stitched.transfers, leader,
                               self._ack_ms(lat), epoch=batches - 1)

    def throughput(
        self,
        trace,
        *,
        payload_bytes: float = 64_000.0,
        batches_in_flight: int = 8,
        ops_per_batch: int = 100,
    ) -> float:
        """Modeled ops/s: ``batches_in_flight`` batches pipelined through
        one stitched leader-schedule stream per trace step.

        The window closes when the last in-flight batch reaches quorum, so
        ops/s = ops * batches / mean(last-batch commit).  The historical
        model multiplied a *single* batch's mean commit latency by
        ``batches_in_flight`` — linear scaling that ignored the leader's
        NIC: on finite-bandwidth matrices it overstated throughput by up to
        the full pipelining factor.  The stitched stream reduces to it
        exactly at ``batches_in_flight=1`` and on infinite-bandwidth
        matrices (no contention to model).
        """
        last = []
        for lat in trace:
            leader = int(self.rng.integers(0, self.n))
            last.append(self.pipelined_commit_ms(
                lat, leader, payload_bytes, batches_in_flight))
        if not last:
            return 0.0
        mean_last = float(np.mean(last))
        if mean_last <= 0.0:
            return 0.0
        return ops_per_batch * batches_in_flight / (mean_last / 1e3)
