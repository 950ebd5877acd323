"""Parameter partitioning rules per sync strategy (the rule of
``repro.dist.sharding``, as a pure function).

* ``flat``: parameters fully replicated;
* ``hier`` / ``geococo``: 2-d+ leaves shard dim 0 over ``data`` and the last
  dim over ``model`` where divisible; 0-d/1-d leaves stay replicated;
  scan-stacked leaves (a path through ``scan``) shift the rule right by
  one, the stacked axis never sharded.

Applied to the grouped layout of ``dist.grouping``.  On a mesh of shape
``(P, 1, 1)`` no leaf is split: every entry of every spec is ``None``.
Placing the leaves by these specs (FSDP2 / DTensor) comes with in-pod
sharding.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["param_specs"]

Spec = tuple[str | None, ...]


def _leaf_spec(key: str, shape: tuple[int, ...], mesh_shape: Mapping[str, int],
               strategy: str) -> Spec:
    if strategy == "flat":
        return ()
    dd = mesh_shape.get("data", 1)
    dm = mesh_shape.get("model", 1)
    ndim = len(shape)
    off = 1 if "scan" in key.split("/") else 0
    if ndim - off < 2:
        return ()
    spec: list[str | None] = [None] * ndim
    if dd > 1 and shape[off] % dd == 0:
        spec[off] = "data"
    if dm > 1 and shape[ndim - 1] % dm == 0:
        spec[ndim - 1] = "model"
    return tuple(spec)


def param_specs(params: Mapping[str, torch.Tensor], mesh_shape: Mapping[str, int],
                strategy: str = "hier") -> dict[str, Spec]:
    """Per leaf of a grouped tree, the reference's partition spec as a tuple
    (one axis name or ``None`` per dimension; ``()`` for replicated, the
    reference's ``P()``).  ``mesh_shape`` maps axis names to sizes."""
    return {key: _leaf_spec(key, tuple(leaf.shape), mesh_shape, strategy)
            for key, leaf in params.items()}
