"""The port's parameter trees: nested dicts and lists of tensors, flattened
as the JAX package flattens a pytree (dict keys in sorted order, sequence
indices in order) and keyed by the same ``/``-joined paths its checkpoint
writes into ``meta.json``.  ``models.convert``, ``checkpoint`` and the
optimizer all walk trees through this one definition."""

from __future__ import annotations

from typing import Any

__all__ = ["leaf_paths", "leaves", "map_paths"]


def leaf_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs: dict keys sorted, sequence indices, ``/``
    between; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(leaf_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree: Any) -> list[Any]:
    """The leaves of ``tree`` in ``leaf_paths`` order."""
    return [leaf for _, leaf in leaf_paths(tree)]


def map_paths(tree: Any, fn, prefix: str = "") -> Any:
    """A tree of ``tree``'s structure holding ``fn(key, leaf)`` at every
    leaf, ``key`` its ``leaf_paths`` key under ``prefix``."""
    if isinstance(tree, dict):
        return {k: map_paths(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(v, fn, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)
