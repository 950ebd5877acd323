"""The port's strategy registry (its own copy of the registry functions of
``repro.core.strategies``).

Entries are registered by ``(kind, name)``; the device plane registers its
gradient-exchange strategies under ``device_sync``
(``repro_torch.dist.collectives``), the planners theirs under ``planner``
(``repro_torch.core.planner``).  Names are shared with the reference:
``flat`` / ``hier`` / ``geococo`` mean the same exchange in both packages.
This is not the reference's table: the port cannot import ``repro``, so it
keeps its own.  The reference's WAN-plane presets (``wan_sync``) belong to
the WAN simulator, which the port does not carry.
"""

from __future__ import annotations

from typing import Any, Iterator

__all__ = ["register", "get", "names", "kinds", "items"]


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
