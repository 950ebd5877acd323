"""Serving-plane statistics: per-epoch counters + run-level aggregates.

All counts are *expected* read counts (floats): the plane evaluates each
(node, epoch) client bucket analytically, so populations scale to millions
of simulated clients without per-request loops and every aggregate is
deterministic — which is what makes the monotonicity gates in
``benchmarks/bench_serving.py`` exact rather than statistical.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["EpochServeStats", "ServeStats", "ServeTotals", "weighted_percentile"]


def weighted_percentile(
    values: np.ndarray, weights: np.ndarray, q: float
) -> float:
    """q-th percentile (0..100) of a weighted discrete distribution.

    The serving plane's latency distribution has a handful of distinct
    values (cache hit / local read / per-target redirect RTTs) carrying
    millions of reads each, so the weighted form is exact where sampling
    would be both slow and noisy.
    """
    values = np.asarray(values, dtype=float)
    weights = np.asarray(weights, dtype=float)
    keep = weights > 0.0
    values, weights = values[keep], weights[keep]
    if values.size == 0:
        return 0.0
    order = np.argsort(values)
    values, weights = values[order], weights[order]
    cum = np.cumsum(weights)
    target = q / 100.0 * cum[-1]
    idx = int(np.searchsorted(cum, target, side="left"))
    return float(values[min(idx, values.size - 1)])


@dataclasses.dataclass
class EpochServeStats:
    """One epoch's serving outcome, summed over every node's client bucket.

    ``redirected`` counts every read whose local view violated the
    staleness bound and was *sent* to the freshest replica (the redirect
    decision is made at the serving node); ``rejected`` is the subset whose
    target was itself over-bound on arrival — so ``rejected <=
    redirected`` under the ``redirect`` policy, and served reads are
    ``reads - rejected``.
    """

    epoch: int
    reads: float
    writes: float
    served_local: float       # within-bound, answered from the node's own view
    stale_served: float       # served_local subset with a non-zero view lag
    redirected: float
    rejected: float
    cache_hits: float
    cache_misses: float
    view_staleness_ms_mean: float
    view_staleness_ms_max: float

    @property
    def served(self) -> float:
        return self.reads - self.rejected


@dataclasses.dataclass
class ServeTotals:
    """Run-level serving counters, accumulated online by
    :class:`~repro_torch.serve.plane.ServingSink` in epoch order — the same
    left-fold the ``ServeStats`` summing properties perform over a retained
    ``epochs`` list, so the totals are byte-identical whether or not the
    per-epoch list is kept (``ServeConfig(keep_epochs=False)``)."""

    reads: float = 0.0
    writes: float = 0.0
    served: float = 0.0
    served_local: float = 0.0
    stale_served: float = 0.0
    redirected: float = 0.0
    rejected: float = 0.0
    cache_hits: float = 0.0
    cache_misses: float = 0.0


@dataclasses.dataclass
class ServeStats:
    """Run-level serving-plane report (attached as ``RunStats.serve``).

    ``latency_values_ms`` / ``latency_weights`` hold the exact weighted
    read-latency distribution (one entry per distinct latency class, with
    per-class weights summed across epochs); percentiles are computed from
    it on demand.  ``totals`` carries the online run counters; the summing
    properties read it when present and fall back to folding ``epochs``
    (hand-constructed instances, pre-sink pickles).  Under
    ``ServeConfig(keep_epochs=False)`` the ``epochs`` list is empty and
    ``totals`` is the only counter surface.
    """

    epochs: list[EpochServeStats]
    latency_values_ms: np.ndarray
    latency_weights: np.ndarray
    wall_ms: float
    max_staleness_ms: float
    policy: str
    totals: ServeTotals | None = None

    # -- totals ---------------------------------------------------------------

    @property
    def reads_total(self) -> float:
        if self.totals is not None:
            return self.totals.reads
        return sum(e.reads for e in self.epochs)

    @property
    def writes_total(self) -> float:
        if self.totals is not None:
            return self.totals.writes
        return sum(e.writes for e in self.epochs)

    @property
    def served_reads(self) -> float:
        if self.totals is not None:
            return self.totals.served
        return sum(e.served for e in self.epochs)

    @property
    def served_local(self) -> float:
        if self.totals is not None:
            return self.totals.served_local
        return sum(e.served_local for e in self.epochs)

    @property
    def stale_served(self) -> float:
        if self.totals is not None:
            return self.totals.stale_served
        return sum(e.stale_served for e in self.epochs)

    @property
    def redirected(self) -> float:
        if self.totals is not None:
            return self.totals.redirected
        return sum(e.redirected for e in self.epochs)

    @property
    def rejected(self) -> float:
        if self.totals is not None:
            return self.totals.rejected
        return sum(e.rejected for e in self.epochs)

    @property
    def cache_hits(self) -> float:
        if self.totals is not None:
            return self.totals.cache_hits
        return sum(e.cache_hits for e in self.epochs)

    @property
    def cache_misses(self) -> float:
        if self.totals is not None:
            return self.totals.cache_misses
        return sum(e.cache_misses for e in self.epochs)

    # -- rates ---------------------------------------------------------------

    @property
    def redirect_rate(self) -> float:
        t = self.reads_total
        return self.redirected / t if t else 0.0

    @property
    def reject_rate(self) -> float:
        t = self.reads_total
        return self.rejected / t if t else 0.0

    @property
    def stale_serve_rate(self) -> float:
        t = self.reads_total
        return self.stale_served / t if t else 0.0

    @property
    def cache_hit_rate(self) -> float:
        t = self.cache_hits + self.cache_misses
        return self.cache_hits / t if t else 0.0

    @property
    def throughput_rps(self) -> float:
        """Served-read throughput over the run's measured wall-clock — the
        headline user-facing metric (rejected reads don't count)."""
        w = self.wall_ms / 1e3
        return self.served_reads / w if w > 0 else 0.0

    # -- latency --------------------------------------------------------------

    @property
    def read_latency_p50_ms(self) -> float:
        return weighted_percentile(
            self.latency_values_ms, self.latency_weights, 50.0
        )

    @property
    def read_latency_p99_ms(self) -> float:
        return weighted_percentile(
            self.latency_values_ms, self.latency_weights, 99.0
        )

    def summary(self) -> dict:
        """Plain-dict digest for benchmark JSON output."""
        return {
            "policy": self.policy,
            "max_staleness_ms": self.max_staleness_ms,
            "reads_total": self.reads_total,
            "served_reads": self.served_reads,
            "throughput_rps": self.throughput_rps,
            "redirect_rate": self.redirect_rate,
            "reject_rate": self.reject_rate,
            "stale_serve_rate": self.stale_serve_rate,
            "cache_hit_rate": self.cache_hit_rate,
            "read_latency_p50_ms": self.read_latency_p50_ms,
            "read_latency_p99_ms": self.read_latency_p99_ms,
        }
