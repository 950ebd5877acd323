"""``repro_torch.serve`` — the million-user read serving plane (the port's
own copy of ``repro.serve``).

The third plane beside the device plane ``repro_torch.dist`` and the WAN
synchronization plane ``repro_torch.core``: region-affine client
populations issue follower reads against their node's possibly-stale
snapshot view — the per-node ``CRDTTable`` views the streaming engine
advances at measured ``node_commit_ms`` times — under staleness-bounded
read semantics with redirect/reject policies and cache-aside accounting.
It is host numpy: it reads the measured commit times, never the tables.  Wire it through
``EngineConfig(streaming=True, serve=ServeConfig(...))``; the run's
:class:`~repro_torch.serve.stats.ServeStats` lands on ``RunStats.serve``.
"""

from .config import ServeConfig
from .plane import (
    ServingSink,
    redirect_policy,
    reject_policy,
    simulate_serving,
    view_epochs,
    view_staleness_ms,
)
from .stats import EpochServeStats, ServeStats, ServeTotals, weighted_percentile

__all__ = [
    "ServeConfig",
    "ServeStats",
    "ServeTotals",
    "ServingSink",
    "EpochServeStats",
    "simulate_serving",
    "view_epochs",
    "view_staleness_ms",
    "redirect_policy",
    "reject_policy",
    "weighted_percentile",
]
