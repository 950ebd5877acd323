"""Parameter partitioning rules per sync strategy (the rule of
``repro.dist.sharding``, as a pure function), and the local blocks they give
a rank.

* ``flat``: parameters fully replicated;
* ``hier`` / ``geococo``: 2-d+ leaves shard dim 0 over ``data`` and the last
  dim over ``model`` where divisible; 0-d/1-d leaves stay replicated;
  scan-stacked leaves (a path through ``scan``) shift the rule right by
  one, the stacked axis never sharded.

Applied to the grouped layout of ``dist.grouping``.  A rank at coordinates
(``data`` d, ``model`` m) holds the contiguous block d of a leaf's ``data``
dimension and block m of its ``model`` dimension (:func:`local_shard`), the
block a fully manual ``shard_map`` hands the device there.  On a mesh of
shape ``(P, 1, 1)`` no leaf is split.  The placement is explicit local
shards (``dist.inpod``), not ``DTensor``: the port's mesh is a gloo mesh of
host tensors, which holds no card tensors.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

__all__ = ["param_specs", "shard_factor", "local_shape", "local_shard", "unshard",
           "fit_batch_axes", "batch_rows"]

Spec = tuple[str | tuple[str, ...] | None, ...]
INPOD = ("data", "model")


def _axis_size(axis: str | tuple[str, ...], sizes: Mapping[str, int]) -> int:
    """The ranks along ``axis``: one axis name, or several (a batch dim
    split over ``("pod", "data")``), whose sizes multiply."""
    if isinstance(axis, str):
        return sizes.get(axis, 1)
    return math.prod(sizes.get(a, 1) for a in axis)


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


def shard_factor(spec: Spec, sizes: Mapping[str, int]) -> int:
    """How many blocks ``spec`` cuts a leaf into on a mesh of ``sizes``."""
    return math.prod(_axis_size(axis, sizes) for axis in spec if axis is not None)


def local_shape(shape: Sequence[int], spec: Spec, sizes: Mapping[str, int]) -> tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``; an entry of
    ``spec`` names one axis or a tuple of them."""
    if not spec:
        return tuple(shape)
    return tuple(n // _axis_size(axis, sizes) if axis is not None else n
                 for n, axis in zip(shape, spec))


def local_shard(full: torch.Tensor, spec: Spec, coords: Mapping[str, int],
                sizes: Mapping[str, int]) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coords`` holds under
    ``spec``: along each dimension named by an axis of ``sizes[axis]``
    ranks, the ``coords[axis]``-th of as many equal contiguous blocks.  A
    new contiguous tensor (the full one may be freed)."""
    out = full
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        width = full.shape[dim] // sizes[axis]
        out = out.narrow(dim, coords[axis] * width, width)
    return out.clone(memory_format=torch.contiguous_format)


def unshard(shards: Sequence[torch.Tensor], spec: Spec,
            sizes: Mapping[str, int]) -> torch.Tensor:
    """The inverse of :func:`local_shard`: the full leaf from the blocks of
    the ranks that hold its distinct blocks, ordered row-major over the
    axes ``spec`` names (``data`` before ``model``)."""
    dims = {axis: dim for dim, axis in enumerate(spec) if axis is not None}
    if not dims:
        return shards[0]
    if len(shards) != shard_factor(spec, sizes):
        raise ValueError(f"{len(shards)} shards for spec {spec} on {dict(sizes)}")
    parts = list(shards)
    for axis in reversed([a for a in INPOD if a in dims]):   # the inner axis first
        n = sizes[axis]
        parts = [torch.cat(parts[i:i + n], dim=dims[axis]) for i in range(0, len(parts), n)]
    return parts[0]


def fit_batch_axes(mesh_shape: Mapping[str, int], dim: int) -> tuple[str, ...]:
    """The reference's ``_fit_batch_axes``: the first of (pod, data),
    (data), (pod) whose size is above 1 and divides ``dim``; ``()`` when
    none does (every rank then takes every row)."""
    for axes in (("pod", "data"), ("data",), ("pod",)):
        if all(a in mesh_shape for a in axes):
            size = math.prod(mesh_shape[a] for a in axes)
            if size > 1 and dim % size == 0:
                return axes
    return ()


def batch_rows(mesh_shape: Mapping[str, int], coords: Mapping[str, int], rows: int) -> slice:
    """The rows of a global batch of ``rows`` that the rank at ``coords``
    computes on, split over :func:`fit_batch_axes` row-major; ranks that
    differ only on an axis outside them (``model`` always) share rows."""
    axes = fit_batch_axes(mesh_shape, rows)
    block, n = 0, 1
    for axis in axes:
        block, n = block * mesh_shape[axis] + coords[axis], n * mesh_shape[axis]
    return slice(block * rows // n, (block + 1) * rows // n)
