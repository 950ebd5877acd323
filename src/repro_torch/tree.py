"""The port's parameter trees: nested dicts and lists of tensors, flattened
as the JAX package flattens a pytree (dict keys in sorted order, sequence
indices in order) and keyed by the same ``/``-joined paths its checkpoint
writes into ``meta.json``.  ``models.convert``, ``checkpoint`` and the
optimizer all walk trees through this one definition."""

from __future__ import annotations

from typing import Any

__all__ = ["leaf_paths", "leaves"]


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
