"""Serving-plane configuration: region-affine client populations.

Every node fronts its own client population (the region-affinity model:
users hit the replica their region routes to, as GaussDB-Global serves
geo-distributed reads off its asynchronous standbys).  Clients issue
follower reads against that node's possibly-stale snapshot view — the one
``EngineConfig(staleness_feedback=True)`` already advances at measured
stitched commit times — under **staleness-bounded read semantics**: a view
older than ``max_staleness_ms`` triggers the configured policy (redirect to
the freshest reachable replica over the WAN, or reject).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["ServeConfig"]


@dataclasses.dataclass
class ServeConfig:
    """One serving plane over a streaming ``GeoCluster`` run.

    ``clients_per_node`` is a scalar (every node fronts the same
    population) or a per-node sequence; with ``ops_per_client_s`` it fixes
    the offered load, of which ``read_ratio`` is follower reads served by
    this plane (the write fraction rides the existing OCC write path and is
    only counted).  ``cache_keys`` > 0 models a per-node cache-aside tier:
    the steady-state hit ratio is the top-``cache_keys`` probability mass
    of a Zipf(``zipf_theta``) popularity over ``n_keys`` keys.
    """

    clients_per_node: float | Sequence[float] = 200_000.0
    ops_per_client_s: float = 1.0
    read_ratio: float = 0.95
    max_staleness_ms: float = 100.0
    policy: str = "redirect"        # registered "serve_policy" strategy
    cache_keys: int = 0             # 0 = no cache tier
    n_keys: int = 10_000
    zipf_theta: float = 0.99
    cache_hit_ms: float = 0.05      # in-memory cache lookup
    local_read_ms: float = 0.5      # replica storage-engine read
    # retain the per-epoch EpochServeStats list on ServeStats.epochs (the
    # historical surface, O(E)); False keeps only the online ServeTotals +
    # aggregated latency distribution — required for bounded-memory runs
    # (EngineConfig(keep_epochs=False); rule table: repro_torch.analysis.
    # config_check).  Totals and percentiles are identical either way.
    keep_epochs: bool = True

    def __post_init__(self):
        # both imports are deliberately lazy: this module sits on the
        # repro_torch.core <-> repro_torch.serve boundary (replication imports
        # ServeConfig for its EngineConfig field), so a top-level core
        # import here would turn the layering into a cycle.  Importing the
        # plane module also guarantees the policies are registered before
        # the fail-fast lookup below.
        from ..analysis.config_check import validate_config
        from ..core import strategies as _strategies
        from . import plane as _plane  # noqa: F401

        _strategies.get("serve_policy", self.policy)
        # range/shape constraints live in the declarative rule table
        # (repro_torch.analysis.config_check) — same historical error messages
        validate_config(self)

    def clients(self, n_nodes: int) -> np.ndarray:
        c = np.asarray(self.clients_per_node, dtype=float)
        if c.ndim == 0:
            return np.full(n_nodes, float(c))
        if c.shape != (n_nodes,):
            raise ValueError(
                f"clients_per_node has shape {c.shape}, expected ({n_nodes},)"
            )
        return c.copy()

    def reads_per_epoch(self, n_nodes: int, epoch_ms: float) -> np.ndarray:
        """Expected follower reads per node per epoch window."""
        ops = self.clients(n_nodes) * self.ops_per_client_s * (epoch_ms / 1e3)
        return ops * self.read_ratio

    def writes_per_epoch(self, n_nodes: int, epoch_ms: float) -> np.ndarray:
        ops = self.clients(n_nodes) * self.ops_per_client_s * (epoch_ms / 1e3)
        return ops * (1.0 - self.read_ratio)
