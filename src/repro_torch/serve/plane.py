"""The read serving plane: staleness-bounded follower reads on stale views
(the port's own copy of ``repro.serve.plane``).

The model (GaussDB-Global-style bounded-staleness standby reads, layered on
this repo's stitched streaming simulation):

* Node ``i``'s **view staleness** at serving time ``t`` is how far behind
  the transaction arrival stream its snapshot view is:
  ``stal_i(t) = max(0, t - v_i(t) * epoch_ms)`` where ``v_i(t)`` is the
  number of epochs whose inbound transfers the stitched simulation has
  delivered to ``i`` by ``t`` (``node_commit_ms`` — the *same* per-node
  commit signal ``staleness_feedback`` advances the ``CRDTTable``
  views on, so serving and OCC staleness are one measurement).
* Reads of epoch ``e``'s window are evaluated at the cadence arrival time
  ``e * epoch_ms`` (the same convention the OCC loop uses for optimistic
  execution), which makes every (node, epoch) client bucket a deterministic
  closed form — populations scale to millions of clients with no sampling.
* **Policy** (registered under the ``serve_policy`` strategy kind):

  - ``redirect``: a read whose local view violates ``max_staleness_ms`` is
    sent to the *freshest* replica (minimum staleness; RTT from the
    epoch's trace matrix breaks ties), paying the WAN round trip.  If even
    the freshest replica is over-bound the read is additionally counted
    ``rejected`` (the client pays a retry).  ``rejected ⊆ redirected``,
    which is what makes both counters monotone in the bound — tightening
    the bound can only grow the redirect set ``{stal_i > S}`` and the
    reject set ``{min_j stal_j > S}`` (property-tested in
    ``tests/test_property_serve.py``).
  - ``reject``: no redirects; an over-bound read fails immediately.

* **Cache-aside accounting**: each served read passes through the serving
  node's cache tier; the steady-state hit ratio is the top-``cache_keys``
  Zipf popularity mass (an ideal cache-aside cache converges to holding
  the hottest keys).  Hits cost ``cache_hit_ms``, misses pay the
  storage-engine ``local_read_ms``; redirected reads pay the RTT on top.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import strategies as _strategies
from ..core.sinks import EpochContext
from ..core.workload import ZipfianSampler
from .config import ServeConfig
from .stats import EpochServeStats, ServeStats, ServeTotals

__all__ = ["ServingSink", "simulate_serving", "view_epochs", "view_staleness_ms"]

_EPS = 1e-9


# ---------------------------------------------------------------------------
# serve policies (strategy registry kind: "serve_policy")
#
# contract: fn(staleness_ms: (n,) float array, bound: float) ->
#           (local, redirect, reject) boolean masks.  `reject ⊆ redirect`
#           under policies that attempt a redirect first; `local`,
#           `redirect` partition the nodes.
# ---------------------------------------------------------------------------


@_strategies.register("serve_policy", "redirect")
def redirect_policy(staleness_ms: np.ndarray, bound: float):
    """Over-bound reads go to the freshest replica; reject only when even
    that replica violates the bound."""
    local = staleness_ms <= bound + _EPS
    redirect = ~local
    if redirect.any() and float(staleness_ms.min()) > bound + _EPS:
        reject = redirect.copy()
    else:
        reject = np.zeros_like(redirect)
    return local, redirect, reject


@_strategies.register("serve_policy", "reject")
def reject_policy(staleness_ms: np.ndarray, bound: float):
    """Strict bounded reads: an over-bound local view fails the read."""
    local = staleness_ms <= bound + _EPS
    return local, np.zeros_like(local), ~local


# ---------------------------------------------------------------------------
# view staleness from the stitched simulation's commit-time matrix
# ---------------------------------------------------------------------------


def view_epochs(commit_ms: np.ndarray, now_ms: float) -> np.ndarray:
    """Per-node count of epochs whose inbound transfers have delivered by
    ``now_ms`` — the epoch prefix each node's snapshot view has merged
    (``advance_views`` uses the identical ``<= now + eps``
    convention, so serving sees exactly the OCC loop's views)."""
    return (commit_ms <= now_ms + _EPS).sum(axis=0)


def view_staleness_ms(
    commit_ms: np.ndarray, now_ms: float, epoch_ms: float
) -> np.ndarray:
    """Per-node view staleness: the age of the oldest transaction-arrival
    epoch the node has *not* merged yet (0 when fully caught up)."""
    v = view_epochs(commit_ms, now_ms)
    return np.maximum(now_ms - v * epoch_ms, 0.0)


# ---------------------------------------------------------------------------
# the serving simulation
# ---------------------------------------------------------------------------


class ServingSink:
    """Incremental serving plane: an :class:`~repro_torch.core.sinks.EpochSink`
    consuming commit rows + the epoch's trace matrix *as they land*.

    The batch plane received the full ``(E, n)`` commit matrix at end of
    run and counted, per serving epoch, how many epochs each node had
    merged (``view_epochs``).  This sink maintains per-node merged-prefix
    pointers over a sliding window of pushed commit rows instead, advancing
    each pointer while the next retained row is delivered by the epoch's
    serving time, and evicting rows below the slowest pointer — memory
    O(max view lag · n), not O(E · n).

    **Soundness / byte-identity**: commit columns are non-decreasing
    (``node_commit_ms`` folds rows with a cumulative max — a requirement on
    inputs to this plane), so the epochs delivered by ``now`` form a
    contiguous prefix of the full matrix and the pointer equals the batch
    count wherever it matters: the two can differ only when *future* rows
    (epochs ``> e``) are already delivered at ``now = e * epoch_ms``, and
    then both view counts exceed ``now / epoch_ms``, so both staleness
    values clamp to exactly ``0.0``.  Every downstream number is a function
    of the staleness vector, hence byte-identical (``simulate_serving`` is
    a thin replay through this sink; ``tests/test_sinks.py`` gates a
    hand-written full-matrix reference against it).

    The latency distribution is aggregated by latency class
    (value -> summed weight, insertion-ordered) instead of appended per
    epoch — the serving plane emits a handful of distinct classes, so this
    is the exact same discrete distribution with per-class weights summed.
    ``ServeConfig(keep_epochs=False)`` additionally drops the per-epoch
    ``EpochServeStats`` list (the O(E) remainder); run totals always come
    from the online :class:`~repro_torch.serve.stats.ServeTotals`.
    """

    def __init__(self, cfg: ServeConfig, n: int, epoch_ms: float):
        self.cfg = cfg
        self.n = int(n)
        self.epoch_ms = float(epoch_ms)
        self._policy = _strategies.get("serve_policy", cfg.policy)
        self._reads = cfg.reads_per_epoch(self.n, self.epoch_ms)
        self._writes = cfg.writes_per_epoch(self.n, self.epoch_ms)
        if cfg.cache_keys > 0:
            sampler = ZipfianSampler(
                cfg.n_keys, cfg.zipf_theta, np.random.default_rng(0)
            )
            self._hit = sampler.top_mass(cfg.cache_keys)
        else:
            self._hit = 0.0
        self._bound = float(cfg.max_staleness_ms)
        # sliding window of pushed commit rows: _rows[0] is absolute epoch
        # _base; rows below every node's merged-prefix pointer are evicted
        self._rows: list[np.ndarray] = []
        self._base = 0
        self._view = np.zeros(self.n, dtype=np.int64)
        self._next = 0
        self._epochs: list[EpochServeStats] = []
        self._totals = ServeTotals()
        self._lat: dict[float, float] = {}

    def _emit(self, value_ms: float, weight: float) -> None:
        if weight > 0.0:
            v = float(value_ms)
            self._lat[v] = self._lat.get(v, 0.0) + float(weight)

    def push(self, epoch: int, commit_row: np.ndarray, lat: np.ndarray) -> None:
        """Serve epoch ``epoch``'s client read load against the views
        implied by the commit rows pushed so far.  ``commit_row`` is the
        epoch's cumulative per-node commit row (``node_commit_ms[epoch]``
        semantics — its columns must be non-decreasing across pushes),
        ``lat`` the epoch's trace latency matrix (redirect RTTs).  Epochs
        must be pushed in order, exactly once."""
        if epoch != self._next:
            raise ValueError(
                f"ServingSink epochs must arrive in order: got {epoch}, "
                f"expected {self._next}"
            )
        self._next = epoch + 1
        self._rows.append(np.asarray(commit_row, dtype=float))
        now = epoch * self.epoch_ms
        # advance merged-prefix pointers (amortized O(1) per node per epoch:
        # each pointer only ever moves forward)
        for i in range(self.n):
            v = int(self._view[i])
            while v <= epoch and self._rows[v - self._base][i] <= now + _EPS:
                v += 1
            self._view[i] = v
        stal = np.maximum(now - self._view * self.epoch_ms, 0.0)
        # rows below the slowest pointer can never be read again
        floor = int(self._view.min()) if self.n else 0
        if floor > self._base:
            del self._rows[: floor - self._base]
            self._base = floor

        n = self.n
        reads = self._reads
        hit = self._hit
        local, redirect, reject = self._policy(stal, self._bound)
        served_redirect = redirect & ~reject

        lat_e = np.asarray(lat, dtype=float)
        rtt = lat_e + lat_e.T
        # freshest replica per source: minimum staleness, nearest RTT tie-break
        fresh = stal <= float(stal.min()) + _EPS
        cand = np.where(fresh[None, :], rtt, np.inf)
        target = cand.argmin(axis=1)

        local_reads = float(reads[local].sum())
        stale_local = float(reads[local & (stal > _EPS)].sum())
        redirected = float(reads[redirect].sum())
        rejected = float(reads[reject].sum())

        # latency classes: the cache tier fronts every *served* read at its
        # serving node (local or redirect target), hits and misses split
        # each bucket by the modeled steady-state hit ratio
        self._emit(self.cfg.cache_hit_ms, local_reads * hit)
        self._emit(self.cfg.local_read_ms, local_reads * (1.0 - hit))
        served_remote = 0.0
        for i in np.flatnonzero(served_redirect):
            r = float(rtt[i, target[i]])
            self._emit(r + self.cfg.cache_hit_ms, reads[i] * hit)
            self._emit(r + self.cfg.local_read_ms, reads[i] * (1.0 - hit))
            served_remote += float(reads[i])

        served = local_reads + served_remote
        es = EpochServeStats(
            epoch=epoch,
            reads=float(reads.sum()),
            writes=float(self._writes.sum()),
            served_local=local_reads,
            stale_served=stale_local,
            redirected=redirected,
            rejected=rejected,
            cache_hits=served * hit,
            cache_misses=served * (1.0 - hit),
            view_staleness_ms_mean=float(stal.mean()) if n else 0.0,
            view_staleness_ms_max=float(stal.max()) if n else 0.0,
        )
        # epoch-order left folds: byte-identical to summing a retained list
        t = self._totals
        t.reads += es.reads
        t.writes += es.writes
        t.served += es.served
        t.served_local += es.served_local
        t.stale_served += es.stale_served
        t.redirected += es.redirected
        t.rejected += es.rejected
        t.cache_hits += es.cache_hits
        t.cache_misses += es.cache_misses
        if self.cfg.keep_epochs:
            self._epochs.append(es)

    def on_epoch(self, stats, ctx: EpochContext | None = None) -> None:
        """EpochSink entry point: serve from the engine's per-epoch push."""
        if ctx is None or ctx.commit_row is None or ctx.lat is None:
            raise ValueError(
                "ServingSink requires an EpochContext carrying the epoch's "
                "commit_row and lat (streaming engine only)"
            )
        self.push(ctx.epoch, ctx.commit_row, ctx.lat)

    def finish(self, wall_ms: float) -> ServeStats:
        """Assemble the run-level report.  ``wall_ms`` is the run's measured
        wall-clock (throughput denominator)."""
        return ServeStats(
            epochs=list(self._epochs),
            latency_values_ms=np.asarray(list(self._lat.keys()), dtype=float),
            latency_weights=np.asarray(list(self._lat.values()), dtype=float),
            wall_ms=float(wall_ms),
            max_staleness_ms=self._bound,
            policy=self.cfg.policy,
            totals=dataclasses.replace(self._totals),
        )


def simulate_serving(
    cfg: ServeConfig,
    commit_ms: np.ndarray,
    lats,
    epoch_ms: float,
    wall_ms: float,
) -> ServeStats:
    """Serve every epoch's client read load against the measured views —
    a thin batch wrapper replaying a full commit matrix through
    :class:`ServingSink` (the results are identical by construction; the
    incremental engine drives the sink directly).

    ``commit_ms`` is the ``(n_epochs, n_nodes)`` per-node commit-time
    matrix of the stitched streaming run (``node_commit_ms`` — its columns
    are non-decreasing, which the sink's prefix pointers rely on); ``lats``
    indexes the per-epoch trace latency matrices (redirect RTTs; a list or
    an :class:`~repro_torch.core.simulator.EpochLatencyCycle`); ``wall_ms`` the
    run's measured wall-clock (throughput denominator).
    """
    commit_ms = np.asarray(commit_ms, dtype=float)
    n_epochs, n = commit_ms.shape
    sink = ServingSink(cfg, n, epoch_ms)
    for e in range(n_epochs):
        sink.push(e, commit_ms[e], lats[min(e, len(lats) - 1)])
    return sink.finish(wall_ms)
