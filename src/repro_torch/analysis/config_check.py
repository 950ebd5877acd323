"""Declarative config-compatibility checker (the port's own copy of
``repro.analysis.config_check``).

One rule table holds every ``EngineConfig`` and ``ServeConfig`` flag's
constraints (checked by their ``__post_init__`` and ``GeoCluster.__init__``),
in one place, as data — so adding a feature flag means adding a
:class:`ConfigRule`, and tooling (tests, docs) can enumerate the full
compatibility matrix without reading constructor code.

Rules are keyed by the config class *name* — deliberately stringly, so
this module imports nothing from ``repro_torch.core`` or
``repro_torch.serve`` and sits below both in the layering (they call into
it from their ``__post_init__``).

Each rule carries a ``stage``:

* ``config`` — checkable from the config object alone; runs at dataclass
  construction (``validate_config(cfg)``).
* ``cluster`` — needs the strategy registry (e.g. inspecting a registered
  schedule builder's signature); runs when the config is attached to an
  engine (``validate_config(cfg, stage="cluster")`` in
  ``GeoCluster.__init__``), preserving the historical fail-at-attach
  behavior for registry-dependent constraints.

Error-message compatibility is part of the contract: ``validate_config``
raises ``ValueError`` with the *first* violation's message, byte for byte
the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from .violations import Violation

__all__ = ["ConfigRule", "RULES", "check_config", "validate_config"]


@dataclasses.dataclass(frozen=True)
class ConfigRule:
    """One declarative compatibility constraint.

    ``check`` returns the violation message (or ``None`` when satisfied);
    ``kind`` is the constraint shape (``requires`` / ``mutually-exclusive``
    / ``range`` / ``contract``) — documentation and tooling metadata, not
    dispatch.
    """

    name: str                 # stable slug, e.g. "staleness-requires-streaming"
    applies_to: str           # config class name
    kind: str
    stage: str                # "config" (constructor) | "cluster" (attach)
    check: Callable[[Any], str | None]


def _requires(flag: str, prereq: str, message: str):
    """``flag`` set (truthy / not None) demands ``prereq`` set."""
    def check(cfg) -> str | None:
        flag_v = getattr(cfg, flag)
        if (flag_v is not None and flag_v is not False) \
                and not getattr(cfg, prereq):
            return message
        return None
    return check


def _mutually_exclusive(a: str, b: str, message: str):
    def check(cfg) -> str | None:
        if getattr(cfg, a) and getattr(cfg, b):
            return message
        return None
    return check


def _grouped_schedule_contract(cfg) -> str | None:
    # the grouping engine drives builders with hierarchical_schedule's
    # contract (plan, node payloads, group_payload_bytes, lat/tiv kwargs);
    # a registered builder without it would fail mid-run, so refuse at
    # engine attach.  Registry + inspect are runtime-only imports: this
    # module stays import-free of repro_torch.core.
    if not cfg.grouping:
        return None
    import inspect

    from ..core import strategies as _strategies

    fn = _strategies.get("schedule", cfg.resolved_schedule_name)
    if "group_payload_bytes" not in inspect.signature(fn).parameters:
        return (
            f"schedule {cfg.resolved_schedule_name!r} cannot drive the "
            "grouping engine: it does not follow the hierarchical "
            "builder contract (missing 'group_payload_bytes')"
        )
    return None


def _flat_schedule_is_all_to_all(cfg) -> str | None:
    # the non-grouping engine runs the flat all-to-all round by definition;
    # a differently-named builder would be silently ignored and the run
    # mislabeled
    if not cfg.grouping and cfg.schedule_name not in (None, "all_to_all"):
        return (
            f"schedule {cfg.schedule_name!r} requires grouping=True "
            "(the flat engine always runs 'all_to_all')"
        )
    return None


def _serve_clients_nonneg(cfg) -> str | None:
    import numpy as np

    if np.any(np.asarray(cfg.clients_per_node, dtype=float) < 0.0):
        return "clients_per_node must be non-negative"
    return None


# ---------------------------------------------------------------------------
# The rule table.  Order matters within a class: validate_config raises the
# first violation, and the historical constructors checked in this order.
# ---------------------------------------------------------------------------

RULES: list[ConfigRule] = [
    # -- EngineConfig ------------------------------------------------------
    ConfigRule(
        "streaming-x-barrier", "EngineConfig", "mutually-exclusive", "config",
        _mutually_exclusive(
            "streaming", "barrier",
            "streaming=True requires the event engine: cross-epoch "
            "stitched DAGs have no barrier-phase semantics (set "
            "barrier=False, or drop streaming for the legacy "
            "max(epoch, exec, sync) formula)",
        ),
    ),
    ConfigRule(
        "staleness-requires-streaming", "EngineConfig", "requires", "config",
        _requires(
            "staleness_feedback", "streaming",
            "staleness_feedback=True requires streaming=True: per-node "
            "view staleness is measured from the stitched multi-epoch "
            "simulation's per-node commit times",
        ),
    ),
    ConfigRule(
        "serve-requires-streaming", "EngineConfig", "requires", "config",
        _requires(
            "serve", "streaming",
            "serve=ServeConfig(...) requires streaming=True: the serving "
            "plane reads per-node view staleness off the stitched "
            "multi-epoch simulation's measured commit times",
        ),
    ),
    ConfigRule(
        "stream-mode-value", "EngineConfig", "range", "config",
        lambda cfg: (
            "stream_mode must be 'incremental' (O(E) appendable timeline) "
            "or 'resim' (the O(E²) stitch-and-rerun reference oracle)"
            if cfg.stream_mode not in ("incremental", "resim") else None
        ),
    ),
    ConfigRule(
        "stats-window-nonnegative", "EngineConfig", "range", "config",
        lambda cfg: "stats_window must be >= 0"
        if cfg.stats_window < 0 else None,
    ),
    ConfigRule(
        "bounded-run-serve-retention", "EngineConfig", "requires", "config",
        lambda cfg: (
            "keep_epochs=False requires ServeConfig(keep_epochs=False): a "
            "bounded-memory run cannot retain the serving plane's full "
            "per-epoch list (run totals and latency percentiles are "
            "unaffected — they come from the online ServeTotals)"
            if (not cfg.keep_epochs and cfg.serve is not None
                and cfg.serve.keep_epochs) else None
        ),
    ),
    ConfigRule(
        "grouped-schedule-contract", "EngineConfig", "contract", "cluster",
        _grouped_schedule_contract,
    ),
    ConfigRule(
        "flat-engine-schedule", "EngineConfig", "contract", "cluster",
        _flat_schedule_is_all_to_all,
    ),
    # -- ServeConfig -------------------------------------------------------
    ConfigRule(
        "read-ratio-range", "ServeConfig", "range", "config",
        lambda cfg: "read_ratio must be in [0, 1]"
        if cfg.read_ratio < 0.0 or cfg.read_ratio > 1.0 else None,
    ),
    ConfigRule(
        "staleness-bound-range", "ServeConfig", "range", "config",
        lambda cfg: "max_staleness_ms must be >= 0"
        if cfg.max_staleness_ms < 0.0 else None,
    ),
    ConfigRule(
        "ops-rate-positive", "ServeConfig", "range", "config",
        lambda cfg: "ops_per_client_s must be positive"
        if cfg.ops_per_client_s <= 0.0 else None,
    ),
    ConfigRule(
        "clients-nonnegative", "ServeConfig", "range", "config",
        _serve_clients_nonneg,
    ),
    ConfigRule(
        "cache-keys-range", "ServeConfig", "range", "config",
        lambda cfg: "cache_keys must be in [0, n_keys]"
        if cfg.cache_keys < 0 or cfg.cache_keys > cfg.n_keys else None,
    ),
]

_STAGES = ("config", "cluster")


def check_config(cfg: Any, *, stage: str = "config") -> list[Violation]:
    """Run every rule for ``cfg``'s class up to ``stage``; return all
    violations as structured diagnostics (empty = compatible).

    ``stage="config"`` runs constructor-checkable rules only;
    ``stage="cluster"`` additionally runs registry-dependent contract
    rules (what ``GeoCluster.__init__`` enforces).
    """
    if stage not in _STAGES:
        raise ValueError(f"unknown stage {stage!r}; expected one of {_STAGES}")
    depth = _STAGES.index(stage)
    cls = type(cfg).__name__
    out: list[Violation] = []
    for rule in RULES:
        if rule.applies_to != cls or _STAGES.index(rule.stage) > depth:
            continue
        msg = rule.check(cfg)
        if msg is not None:
            out.append(Violation(rule.name, msg, file=cls))
    return out


def validate_config(cfg: Any, *, stage: str = "config") -> None:
    """Raise ``ValueError`` with the first violation's (historical) message;
    no-op when the config is compatible."""
    violations = check_config(cfg, stage=stage)
    if violations:
        raise ValueError(violations[0].message)
