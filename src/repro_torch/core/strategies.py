"""The port's strategy registry (its own copy of the registry functions of
``repro.core.strategies``).

Entries are registered by ``(kind, name)``; the device plane registers its
gradient-exchange strategies under ``device_sync``
(``repro_torch.dist.collectives``), the planners theirs under ``planner``
(``repro_torch.core.planner``), the WAN plane its schedule builders under
``schedule`` (``repro_torch.core.schedule``), its aggregator filters under
``filter`` (``repro_torch.core.whitedata``) and its named presets under
``wan_sync`` (here).  Names are shared with the reference: ``flat`` /
``hier`` / ``geococo`` mean the same exchange in both packages and on both
planes.  This is not the reference's table: the port cannot import
``repro``, so it keeps its own.  The serving plane registers its read
policies under ``serve_policy`` (``repro_torch.serve.plane``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator

__all__ = ["register", "get", "names", "kinds", "items", "WanSyncStrategy",
           "wan_strategy_name"]


_REGISTRY: dict[str, dict[str, Any]] = {}


def register(kind: str, name: str, obj: Any = None):
    """Register ``obj`` under ``(kind, name)``.

    Usable directly (``register("device_sync", "flat", spec)``) or as a
    decorator (``@register("planner", "milp")``).  Re-registering a name
    replaces the previous entry (last one wins).
    """
    if obj is None:

        def deco(f):
            _REGISTRY.setdefault(kind, {})[name] = f
            return f

        return deco
    _REGISTRY.setdefault(kind, {})[name] = obj
    return obj


def get(kind: str, name: str) -> Any:
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        known = sorted(_REGISTRY.get(kind, {}))
        raise KeyError(
            f"no {kind!r} strategy named {name!r}; registered: {known}"
        ) from None


def names(kind: str) -> list[str]:
    return sorted(_REGISTRY.get(kind, {}))


def kinds() -> list[str]:
    return sorted(_REGISTRY)


def items(kind: str) -> Iterator[tuple[str, Any]]:
    yield from sorted(_REGISTRY.get(kind, {}).items())


# ---------------------------------------------------------------------------
# WAN-plane named presets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WanSyncStrategy:
    """One named configuration of the engine's synchronization stages.

    ``schedule`` / ``filter`` are names resolved through this registry at
    engine-construction time, so a preset can point at a custom builder
    without the engine knowing about it.
    """

    name: str
    grouping: bool
    filtering: bool
    tiv: bool
    compression: bool = False
    schedule: str = "hierarchical"
    filter: str = "whitedata"

    def describe(self) -> str:
        stages = [
            "grouping" if self.grouping else "flat",
            f"filter:{self.filter}" if self.filtering else "no-filter",
            "tiv" if self.tiv else "no-tiv",
        ]
        if self.compression:
            stages.append("zlib")
        return f"{self.name}({', '.join(stages)})"


register(
    "wan_sync",
    "flat",
    WanSyncStrategy("flat", grouping=False, filtering=False, tiv=False,
                    schedule="all_to_all", filter="none"),
)
register(
    "wan_sync",
    "hier",
    WanSyncStrategy("hier", grouping=True, filtering=False, tiv=False,
                    filter="none"),
)
register(
    "wan_sync",
    "geococo",
    WanSyncStrategy("geococo", grouping=True, filtering=True, tiv=True),
)
register(
    "wan_sync",
    "geococo-zlib",
    WanSyncStrategy("geococo-zlib", grouping=True, filtering=True, tiv=True,
                    compression=True),
)


def wan_strategy_name(
    *, grouping: bool, filtering: bool, tiv: bool, compression: bool
) -> str:
    """Faithful name for a legacy-boolean ``EngineConfig``.

    The structural base (``flat`` / ``hier`` / ``geococo[-zlib]``) comes
    from grouping/filtering/compression; when the remaining stages differ
    from the registered preset, a ``+stage``/``-stage`` modifier is
    appended (the planner's ``milp+tiv`` idiom), so the name never claims a
    preset whose stages the config does not run.  Modified names are *not*
    registered — round-tripping one through ``EngineConfig(sync_strategy=)``
    fails loudly rather than silently changing the config.  ``tiv`` only
    matters under grouping (the flat round has no relay hop) and is ignored
    otherwise.
    """
    if not grouping:
        base = "flat"
    elif not filtering:
        base = "hier"
    else:
        base = "geococo-zlib" if compression else "geococo"
    spec = get("wan_sync", base)
    if grouping and tiv != spec.tiv:
        base += "+tiv" if tiv else "-tiv"
    if compression != spec.compression:
        base += "+zlib" if compression else "-zlib"
    return base
