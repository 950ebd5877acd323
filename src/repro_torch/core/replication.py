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

Throughput is the reference's formula model (``streaming=False``): an
epoch's wall clock is ``max(epoch_ms, execution, synchronization)``.  The
synchronization round runs as an event-driven transfer DAG by default, or
as the pre-DAG barrier phases with ``barrier=True``; both commit the same
bytes.  The cross-epoch streaming engine, per-node views, the serving
plane, compression, schedule verification and the Raft plane are refused
with ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import time

import numpy as np
import torch

from . import strategies as _strategies
from .crdt import CRDTTable
from .occ import EpochBatch, validate_epoch_detailed
from .planner import GroupPlan
from .schedule import TransmissionSchedule
from .simulator import WANSimulator
from .sinks import RunAggregator, RunSummary
from .whitedata import FilterStats
from ..analysis.config_check import validate_config
from ..device import resolve_device, synchronize

__all__ = ["EngineConfig", "EpochStats", "RunStats", "GeoCluster", "RaftCluster"]


def _refused(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP §1, {item})")


@dataclasses.dataclass
class EngineConfig:
    """Engine configuration with a named-strategy surface.

    ``sync_strategy`` names a registered ``wan_sync`` preset (``flat`` /
    ``hier`` / ``geococo`` — the same names the device plane's exchange
    uses); when given it drives the per-stage booleans.  The booleans stay
    writable for ablations without an exact preset.  ``schedule_name`` and
    ``filter_name`` select registered implementations for the grouping
    transmission and the aggregator filter.  Flag compatibility is checked
    by the rule table (``repro_torch.analysis.config_check``), with the
    reference's messages; the flags of the planes not ported yet then raise
    ``NotImplementedError``.
    """

    n_nodes: int
    epoch_ms: float = 10.0
    txn_exec_us: float = 40.0
    barrier: bool = False              # True = pre-DAG barrier-phase engine
    streaming: bool = False            # refused (ROADMAP §1, W1)
    staleness_feedback: bool = False   # refused (W2)
    serve: object | None = None        # refused (W3)
    # modeled bytes-proportional filter CPU instead of the measured wall
    # clock (on the card: after a synchronise), so a run is deterministic
    modeled_cpu: bool = False
    filter_cpu_ns_per_byte: float = 2.0
    # keep_epochs=False keeps only the trailing `stats_window` EpochStats;
    # run totals come from the online RunSummary either way
    keep_epochs: bool = True
    stats_window: int = 64
    verify_schedules: bool = False     # refused (W7)
    sync_strategy: str | None = None   # named wan_sync preset (overrides booleans)
    grouping: bool = True              # GeoCoCo hierarchical transmission
    filtering: bool = True             # white-data filter at aggregators
    tiv: bool = True                   # overlay relay exploitation
    tiv_margin: float = 0.05
    compression: bool = False          # refused (W4)
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
        if self.staleness_feedback:
            raise _refused("staleness_feedback=True (per-node snapshot views)",
                           "W2: per-node views")
        if self.serve is not None:
            raise _refused("serve= (the serving plane)", "W3: serve/")
        if self.streaming:
            raise _refused("streaming=True (the cross-epoch stitched engine)",
                           "W1: core/stream.py")
        if self.compression:
            raise _refused(f"compression ({self.resolved_sync_strategy})",
                           "W4: compression")
        if self.verify_schedules:
            raise _refused("verify_schedules=True", "W7: analysis/schedule_check.py")

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
    and cross-stage WAN overlap (``sync_wan_overlap_ms``).  The streaming
    and per-node-view fields stay 0 here."""

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
    serve: object | None = None
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


@dataclasses.dataclass
class _EpochRound:
    """The timing-independent product of one epoch: the schedule to time,
    the commit outcome, and the planning/filtering context the stats need."""

    epoch: int
    schedule: TransmissionSchedule
    n_txns: int
    committed: int
    aborted: int
    read_aborts: int
    ww_aborts: int
    exec_ms: float
    filter_cpu_ms: float
    fstats: FilterStats | None
    plan_method: str
    modeled_cpu_ms: float


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
    space (``generator.table``), unless set before.  ``epoch_times`` holds
    each epoch's wall split (of the epochs whose ``EpochStats`` the run
    keeps): host draws, the batch's copy to the device
    with its gathers, device work (validation, filters, commit, each ending
    in a synchronise) and host work (planning, schedules, the simulator).
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
        from .planner import best_plan

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
        )
        self.plan_time_s += time.perf_counter() - t0  # lint: allow[wallclock] plan-search cost
        return plan

    def _on_device(self, fn, *args, **kw):
        """``fn(*args, **kw)`` between two synchronises, its wall time added
        to the epoch's device work; returns its result and that time."""
        synchronize(self.device)
        t0 = time.perf_counter()  # lint: allow[wallclock] measured device work
        out = fn(*args, **kw)
        synchronize(self.device)
        dt = time.perf_counter() - t0  # lint: allow[wallclock] measured device work
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

    def _prepare_epoch(self, epoch: int, batch: EpochBatch, lat: np.ndarray) -> _EpochRound:
        """Everything timing-independent about one epoch: planning, filtering,
        schedule construction, deterministic validation and the CRDT commit.
        The simulator never touches the store, so the commit is the same
        whichever engine (barrier / event) later times the round."""
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
            for j, group in enumerate(plan.groups):
                gbatch = batch.select(batch.node_txns(group))
                fr, dt = self._on_device(self._filter_fn, gbatch, snapshot)
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
                group_payload[j] = fr.stats.wire_bytes
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
            schedule = self._flat_schedule_fn(n, node_payload)
            plan_method = "none"
            modeled_cpu_ms = 0.0

        # feed filter observations to the bandwidth-aware planner
        if cfg.grouping and cfg.filtering and fstats is not None and fstats.total_bytes:
            keep = fstats.wire_bytes / fstats.total_bytes
            self._keep_ewma = 0.7 * self._keep_ewma + 0.3 * keep

        # deterministic global validation against the epoch-start snapshot,
        # then the CRDT join of the committed writes
        (committed, read_aborts, ww_aborts), _ = self._on_device(self._commit, batch)
        return _EpochRound(
            epoch=epoch,
            schedule=schedule,
            n_txns=n_txns,
            committed=committed,
            aborted=n_txns - committed,
            read_aborts=read_aborts,
            ww_aborts=ww_aborts,
            exec_ms=exec_ms,
            filter_cpu_ms=filter_cpu_ms,
            fstats=fstats,
            plan_method=plan_method,
            modeled_cpu_ms=modeled_cpu_ms,
        )

    def _commit(self, batch: EpochBatch) -> tuple[int, int, int]:
        """Validate the epoch and join its committed writes into the store;
        returns (committed, read-aborted, write-write-aborted) counts (the
        generator's transaction ids are unique)."""
        vres = validate_epoch_detailed(batch, self.store)
        ok = vres.committed_mask
        w = ok[batch.write_txn]
        t = batch.write_txn[w]
        vers = torch.stack([batch.epoch[t], batch.seq[t], batch.node[t]], 1)
        self.store.merge_rows(batch.write_row[w], batch.write_val[w], vers)
        committed, ra, wa = torch.stack([ok.sum(), vres.read_mask.sum(),
                                         vres.ww_mask.sum()]).tolist()
        return committed, ra, wa

    def _epoch_stats(self, rnd: _EpochRound, sim: WANSimulator, res) -> EpochStats:
        """Assemble one epoch's stats from its round simulation."""
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
        return EpochStats(
            epoch=rnd.epoch,
            n_txns=rnd.n_txns,
            committed=rnd.committed,
            aborted=rnd.aborted,
            sync_ms=res.makespan_ms,
            exec_ms=rnd.exec_ms,
            wall_ms=max(cfg.epoch_ms, rnd.exec_ms, res.makespan_ms),
            wan_bytes=wan_bytes,
            filter_stats=rnd.fstats,
            filter_cpu_ms=rnd.filter_cpu_ms,
            plan_method=rnd.plan_method,
            sync_serial_ms=sync_serial_ms,
            sync_overlap_ms=sync_overlap_ms,
            sync_cpu_hidden_ms=cpu_hidden_ms,
            sync_wan_overlap_ms=wan_overlap_ms,
            read_aborts=rnd.read_aborts,
            ww_aborts=rnd.ww_aborts,
        )

    def run_epoch(self, epoch: int, batch: EpochBatch, lat: np.ndarray) -> EpochStats:
        cfg = self.cfg
        rnd = self._prepare_epoch(epoch, batch, lat)
        sim = WANSimulator(lat, self.bandwidth, loss=self.loss, rng=self.rng,
                           barrier=cfg.barrier)
        res = sim.run(rnd.schedule)
        self.msg_matrix += res.msg_matrix
        return self._epoch_stats(rnd, sim, res)

    # -- full run ----------------------------------------------------------------

    def run(self, generator, trace, *, txns_per_node: int = 20,
            n_epochs: int | None = None) -> RunStats:
        """``n_epochs`` epochs (default ``len(trace)``) of ``generator``'s
        transactions, epoch ``e`` on ``trace[e % len(trace)]``."""
        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else len(trace)
        if self.store is None:
            self.store = generator.table(self.device)
        agg = RunAggregator(keep_epochs=cfg.keep_epochs, window=cfg.stats_window)
        for e in range(n_epochs):
            lat = trace[e % len(trace)]
            t0 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
            draws = generator.draw(e, txns_per_node)
            t1 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
            batch = generator.to_batch(draws, self.store)
            synchronize(self.device)
            t2 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
            self._device_s = 0.0
            agg.on_epoch(self.run_epoch(e, batch, lat))
            t3 = time.perf_counter()  # lint: allow[wallclock] epoch wall split
            self.epoch_times.append({"draw_s": t1 - t0, "copy_s": t2 - t1,
                                     "device_s": self._device_s,
                                     "host_s": t3 - t2 - self._device_s})
        return RunStats(
            epochs=agg.epochs,
            msg_matrix=self.msg_matrix.copy(),
            plan_time_s=self.plan_time_s,
            state_digest=self.store.digest(),
            value_digest=self.store.digest(values_only=True),
            summary=agg.summary,
        )


class RaftCluster:
    """The reference's leader-based (CockroachDB / Raft) plane; not ported
    yet."""

    def __init__(self, *args, **kwargs):
        raise _refused("RaftCluster", "W6: RaftCluster")
