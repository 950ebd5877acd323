"""WAN latency / bandwidth models, trace generation, and TIV analysis (the
port's own copy of ``repro.core.latency``).

This module provides the network substrate the paper's Planner consumes:

* an AWS-style 10-region latency matrix calibrated to the figures quoted in the
  paper (Stockholm-Frankfurt ~26 ms, Sao Paulo-Cape Town ~337 ms, N.California-
  Central Canada ~81 ms, N.California-Cape Town ~288 ms),
* synthetic geo-clustered matrices (Observation #1: geographic clustering),
* temporal jitter traces (episodic AR(1) + spikes, PCHIP-smoothed like the
  paper's trace-driven simulation setup, Sec 6.1),
* Triangle-Inequality-Violation statistics and relay-path search
  (Observation #3), and
* bandwidth matrices with the LAN >> WAN asymmetry described in Sec 2.2.

Everything here is pure numpy, as in the reference: the planner and the
control plane run on the host, a control-plane sidecar of the trainer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "AWS_REGIONS",
    "aws_latency_matrix",
    "GeoClusterSpec",
    "geo_clustered_matrix",
    "LatencyTrace",
    "jitter_trace",
    "tiv_pairs",
    "tiv_fraction",
    "one_relay_effective",
    "all_pairs_shortest",
    "bandwidth_matrix",
    "validate_latency_matrix",
]

# ---------------------------------------------------------------------------
# AWS-style 10-region matrix (paper Fig. 2)
# ---------------------------------------------------------------------------

AWS_REGIONS: tuple[str, ...] = (
    "us-east-1",       # N. Virginia
    "us-west-1",       # N. California
    "ca-central-1",    # Central Canada
    "sa-east-1",       # Sao Paulo
    "eu-west-1",       # Ireland
    "eu-north-1",      # Stockholm
    "eu-central-1",    # Frankfurt
    "af-south-1",      # Cape Town
    "ap-northeast-1",  # Tokyo
    "ap-southeast-1",  # Singapore
)

# One-way link latencies in ms, symmetric.  Calibrated so that the pairs the
# paper quotes land on the paper's numbers and the rest follow great-circle
# distance plus typical transit detours (values cross-checked against public
# cloudping-style tables).
_AWS_LATENCY_MS = np.array(
    [
        #  use   usw   cac   sae   euw   eun   euc   afs   apn   aps
        [   0.0, 62.0, 16.0,115.0, 67.0,110.0, 88.0,225.0,145.0,215.0],  # us-east-1
        [  62.0,  0.0, 81.1,174.0,137.0,175.0,147.0,288.5,107.0,170.0],  # us-west-1
        [  16.0, 81.1,  0.0,125.0, 70.0,105.0, 92.0,235.0,144.0,210.0],  # ca-central-1
        [ 115.0,174.0,125.0,  0.0,177.0,219.0,200.0,337.0,256.0,318.0],  # sa-east-1
        [  67.0,137.0, 70.0,177.0,  0.0, 38.0, 25.0,158.0,199.0,174.0],  # eu-west-1
        [ 110.0,175.0,105.0,219.0, 38.0,  0.0, 26.0,189.0,222.0,182.0],  # eu-north-1
        [  88.0,147.0, 92.0,200.0, 25.0, 26.0,  0.0,154.0,217.0,162.0],  # eu-central-1
        [ 225.0,288.5,235.0,337.0,158.0,189.0,154.0,  0.0,272.0,180.0],  # af-south-1
        [ 145.0,107.0,144.0,256.0,199.0,222.0,217.0,272.0,  0.0, 69.0],  # ap-northeast-1
        [ 215.0,170.0,210.0,318.0,174.0,182.0,162.0,180.0, 69.0,  0.0],  # ap-southeast-1
    ]
)


def aws_latency_matrix() -> np.ndarray:
    """The 10-region AWS-style latency matrix (ms, symmetric, zero diagonal)."""
    return _AWS_LATENCY_MS.copy()


# ---------------------------------------------------------------------------
# Synthetic geo-clustered matrices (Observation #1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeoClusterSpec:
    """Specification for a synthetic geo-clustered deployment.

    ``n_clusters`` regions are placed on a 2-D plane; member nodes scatter
    around their region center.  Latency ~= propagation (distance) +
    per-link transit penalty.  A random subset of links receives a
    multiplicative congestion inflation, which is what produces realistic
    Triangle Inequality Violations (a congested direct path can be beaten by
    two un-congested hops through a hub).
    """

    n_nodes: int
    n_clusters: int = 3
    intra_ms: float = 4.0           # typical intra-region latency scale
    plane_km: float = 12000.0       # spread of region centers
    ms_per_km: float = 0.015        # ~ c/1.5 fiber + routing slack
    congestion_frac: float = 0.25   # fraction of inter-region links inflated
    congestion_mult: tuple[float, float] = (1.3, 2.5)
    min_inter_ms: float = 20.0


def geo_clustered_matrix(
    spec: GeoClusterSpec, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Generate a clustered latency matrix.

    Returns ``(latency_ms, cluster_ids)``; latency is symmetric, zero-diag.
    """
    n, c = spec.n_nodes, spec.n_clusters
    centers = rng.uniform(0.0, spec.plane_km, size=(c, 2))
    cluster_ids = np.sort(rng.integers(0, c, size=n))
    # guarantee every cluster non-empty when n >= c
    if n >= c:
        cluster_ids[:c] = np.arange(c)
        cluster_ids = np.sort(cluster_ids)
    jitter_km = spec.intra_ms / spec.ms_per_km / 2.0
    pos = centers[cluster_ids] + rng.normal(0.0, jitter_km / 3.0, size=(n, 2))
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    lat = d * spec.ms_per_km
    same = cluster_ids[:, None] == cluster_ids[None, :]
    # intra-cluster: small, roughly uniform around intra_ms
    intra = rng.uniform(0.5 * spec.intra_ms, 1.5 * spec.intra_ms, size=(n, n))
    intra = (intra + intra.T) / 2.0
    lat = np.where(same, intra, np.maximum(lat, spec.min_inter_ms))
    # congestion inflation on a subset of inter-cluster links -> TIV
    infl = np.ones((n, n))
    iu = np.triu_indices(n, k=1)
    inter_mask = ~same[iu]
    n_inter = int(inter_mask.sum())
    n_congested = int(round(spec.congestion_frac * n_inter))
    if n_congested > 0:
        idx = rng.choice(np.flatnonzero(inter_mask), size=n_congested, replace=False)
        mult = rng.uniform(*spec.congestion_mult, size=n_congested)
        rows, cols = iu[0][idx], iu[1][idx]
        infl[rows, cols] = mult
        infl[cols, rows] = mult
    lat = lat * infl
    np.fill_diagonal(lat, 0.0)
    return lat, cluster_ids


# ---------------------------------------------------------------------------
# Temporal traces (Sec 6.1: PCHIP-fitted, episodic dynamics)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LatencyTrace:
    """A sequence of latency matrices over time (one per synchronization round)."""

    base: np.ndarray                 # (n, n) mean latency
    frames: np.ndarray               # (t, n, n) per-round matrices

    def __len__(self) -> int:
        return self.frames.shape[0]

    def __iter__(self) -> Iterator[np.ndarray]:
        return iter(self.frames)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.frames[i]


def jitter_trace(
    base: np.ndarray,
    n_rounds: int,
    rng: np.random.Generator,
    *,
    rel_sigma: float = 0.08,
    ar_coeff: float = 0.9,
    spike_prob: float = 0.01,
    spike_mult: tuple[float, float] = (1.5, 3.0),
    spike_len: tuple[int, int] = (5, 30),
    knot_every: int = 8,
) -> LatencyTrace:
    """Generate an episodic, smoothly-varying latency trace.

    Model: per-link AR(1) log-multiplier sampled at knots every ``knot_every``
    rounds and PCHIP-interpolated between knots (matching the paper's
    piecewise-cubic-Hermite fitting of AWS traces), plus episodic spike events
    that multiply a link's latency for a sustained window ("episodic rather
    than continuous" dynamics, Sec 4.2/5).
    """
    from scipy.interpolate import PchipInterpolator

    n = base.shape[0]
    iu = np.triu_indices(n, k=1)
    n_links = iu[0].size
    n_knots = max(2, n_rounds // knot_every + 2)
    knots_t = np.linspace(0, n_rounds - 1, n_knots)
    # AR(1) in log-space at the knots
    z = np.zeros((n_knots, n_links))
    for t in range(1, n_knots):
        z[t] = ar_coeff * z[t - 1] + rng.normal(0.0, rel_sigma, size=n_links)
    interp = PchipInterpolator(knots_t, z, axis=0)
    mult = np.exp(interp(np.arange(n_rounds)))  # (rounds, links)
    # episodic spikes
    for l in range(n_links):
        t = 0
        while t < n_rounds:
            if rng.random() < spike_prob:
                ln = int(rng.integers(*spike_len))
                m = rng.uniform(*spike_mult)
                mult[t : t + ln, l] *= m
                t += ln
            t += 1
    frames = np.repeat(base[None, :, :], n_rounds, axis=0)
    frames[:, iu[0], iu[1]] *= mult
    frames[:, iu[1], iu[0]] = frames[:, iu[0], iu[1]]
    return LatencyTrace(base=base.copy(), frames=frames)


# ---------------------------------------------------------------------------
# Triangle-Inequality Violations (Observation #3)
# ---------------------------------------------------------------------------


def tiv_pairs(lat: np.ndarray, *, margin: float = 0.0) -> np.ndarray:
    """Boolean (n, n) matrix: True where some 1-relay path beats the direct link.

    ``margin`` requires the indirect path to win by at least that fraction
    (e.g. 0.05 = 5% faster) — the paper's overlay only deploys a relay when it
    provides "sufficient latency gain".
    """
    n = lat.shape[0]
    # best one-relay path: min_r lat[i, r] + lat[r, j]
    via = lat[:, :, None] + lat.T[None, :, :]          # (i, r, j) -> i->r->j
    via = via.transpose(0, 2, 1)                        # (i, j, r)
    eye = np.eye(n, dtype=bool)
    relay_block = eye[:, None, :] | eye[None, :, :]     # r == i or r == j
    via = np.where(relay_block, np.inf, via)
    best = via.min(axis=2)
    out = best < lat * (1.0 - margin)
    np.fill_diagonal(out, False)
    return out


def tiv_fraction(lat: np.ndarray, *, margin: float = 0.0) -> float:
    """Fraction of ordered node pairs violating the triangle inequality."""
    n = lat.shape[0]
    v = tiv_pairs(lat, margin=margin)
    return float(v.sum()) / float(n * (n - 1))


def one_relay_effective(lat: np.ndarray, *, margin: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Effective latency using at most one relay, plus the chosen relay.

    Returns ``(eff, relay)`` where ``relay[i, j] = -1`` for direct transmission
    and otherwise the relay node index.  This is the paper's overlay-based TIV
    exploitation (Sec 5, "Overlay-based Implementation"): user-space relays,
    falling back to the direct path when gain is below ``margin``.
    """
    n = lat.shape[0]
    via = lat[:, :, None] + lat.T[None, :, :]
    via = via.transpose(0, 2, 1)  # (i, j, r)
    eye = np.eye(n, dtype=bool)
    relay_block = eye[:, None, :] | eye[None, :, :]
    via = np.where(relay_block, np.inf, via)
    best_r = via.argmin(axis=2)
    best = np.take_along_axis(via, best_r[:, :, None], axis=2)[:, :, 0]
    use = best < lat * (1.0 - margin)
    eff = np.where(use, best, lat)
    relay = np.where(use, best_r, -1)
    np.fill_diagonal(eff, 0.0)
    np.fill_diagonal(relay, -1)
    return eff, relay


def all_pairs_shortest(lat: np.ndarray) -> np.ndarray:
    """Floyd-Warshall all-pairs shortest latency (unbounded relays).

    Used for the theoretical lower bound in the makespan CDF (Fig 9's
    "Low Bound"): no schedule can synchronize a pair faster than its shortest
    path.
    """
    d = lat.copy().astype(float)
    n = d.shape[0]
    for r in range(n):
        d = np.minimum(d, d[:, r : r + 1] + d[r : r + 1, :])
    return d


# ---------------------------------------------------------------------------
# Bandwidth
# ---------------------------------------------------------------------------


def bandwidth_matrix(
    cluster_ids: np.ndarray | None,
    n: int,
    rng: np.random.Generator,
    *,
    lan_mbps: float = 10000.0,
    wan_mbps: tuple[float, float] = (100.0, 1000.0),
) -> np.ndarray:
    """WAN/LAN-asymmetric bandwidth matrix (Mbps).

    Sec 2.2: WAN bandwidth is on average ~15x (up to 60-80x) below LAN.  The
    defaults give a 10-100x gap.  ``cluster_ids=None`` treats every pair as WAN.
    """
    bw = rng.uniform(*wan_mbps, size=(n, n))
    bw = (bw + bw.T) / 2.0
    if cluster_ids is not None:
        same = cluster_ids[:, None] == cluster_ids[None, :]
        bw = np.where(same, lan_mbps, bw)
    np.fill_diagonal(bw, np.inf)
    return bw


def validate_latency_matrix(lat: np.ndarray) -> None:
    if lat.ndim != 2 or lat.shape[0] != lat.shape[1]:
        raise ValueError(f"latency matrix must be square, got {lat.shape}")
    if not np.allclose(np.diag(lat), 0.0):
        raise ValueError("latency matrix diagonal must be zero")
    if (lat < 0).any():
        raise ValueError("latency matrix must be non-negative")
