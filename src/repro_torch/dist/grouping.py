"""The reference's leaf layout for the pod exchange.

The reference exchanges its parameter tree as ``init_params`` builds it:
the scanned layers stacked, one leaf per pattern position with a leading
``n_scan`` axis, under ``scan/{j}/...``.  The port keeps one leaf per layer
(``params["layers"][i]``).  The exchange decides per leaf (dense below
``min_leaf_size``, else chunked over the raveled leaf, chunks crossing layer
boundaries), so the port groups its gradients as the reference stacks them
before the exchange and ungroups the result after.  Residuals live in the
grouped layout, as each rank's local shards.

Under in-pod sharding every rank holds its block of each per-layer leaf.
The scan axis is never split and the rule shifts right by one on the
stacked leaves, so a scan-region leaf's per-layer spec is its grouped
spec without the leading entry (:func:`leaf_specs`), and stacking the
per-layer blocks gives the block of the grouped leaf: grouping commutes
with taking a rank's shard.

A grouped tree is a dict from the reference's ``/``-joined leaf paths to
tensors, in the reference's leaf order.  The mapping from a port layer to
its place in the reference is ``models.convert``'s, the paths those of
``tree.leaf_paths``.
"""

from __future__ import annotations

import functools
from typing import Mapping, Sequence

import torch

from ..configs.base import ModelConfig
from ..models.convert import _jax_location
from ..models.model import init_params
from ..tree import leaf_paths
from .sharding import Spec, local_shape, param_specs

__all__ = ["group_like_reference", "ungroup", "grouped_specs", "leaf_specs", "zero_residuals"]


def _reference_order(key: str) -> list:
    """Sort key giving ``leaf_paths``' order of a JAX tree: dict keys as
    strings, sequence indices as numbers."""
    return [int(p) if p.isdigit() else p for p in key.split("/")]


@functools.lru_cache(maxsize=16)
def _layout(cfg: ModelConfig) -> tuple[tuple[tuple[str, int | None], ...], tuple[str, ...], int]:
    """Per port leaf (in ``tree.leaves`` order) its reference path and index
    on the stacked axis (None outside the scan region); the reference's
    paths in its leaf order; ``n_scan``."""
    where = []
    for key, _ in leaf_paths(init_params(cfg, None, "meta")):
        parts = key.split("/")
        if parts[0] == "layers":
            loc, idx = _jax_location(cfg, int(parts[1]))
            where.append(("/".join([loc, *parts[2:]]), idx))
        else:
            where.append((key, None))
    keys = tuple(sorted({k for k, _ in where}, key=_reference_order))
    return tuple(where), keys, cfg.scan_partition()[1]


def group_like_reference(cfg: ModelConfig, leaves: Sequence[torch.Tensor]) -> dict[str, torch.Tensor]:
    """The port's per-layer leaves (``tree.leaves(params)`` order) as the
    reference lays them out: each scan-region leaf stacked over its
    ``n_scan`` layers (a new tensor), every other leaf as it is."""
    where, keys, n_scan = _layout(cfg)
    if len(leaves) != len(where):
        raise ValueError(f"{cfg.name} has {len(where)} leaves, got {len(leaves)}")
    whole: dict[str, torch.Tensor] = {}
    stacks: dict[str, list] = {}
    for (key, idx), leaf in zip(where, leaves):
        if idx is None:
            whole[key] = leaf
        else:
            stacks.setdefault(key, [None] * n_scan)[idx] = leaf
    for key, parts in stacks.items():
        whole[key] = torch.stack(parts)
    return {key: whole[key] for key in keys}


def ungroup(cfg: ModelConfig, grouped: dict[str, torch.Tensor]) -> list[torch.Tensor]:
    """The inverse of :func:`group_like_reference`: per-layer leaves in the
    port's order, each scan-region leaf a view into its stacked tensor."""
    where, _, _ = _layout(cfg)
    return [grouped[key] if idx is None else grouped[key][idx] for key, idx in where]


def _grouped_meta(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    return group_like_reference(cfg, [p for _, p in leaf_paths(init_params(cfg, None, "meta"))])


def grouped_specs(cfg: ModelConfig, mesh_shape: Mapping[str, int],
                  strategy: str) -> dict[str, Spec]:
    """``sharding.param_specs`` over ``cfg``'s grouped tree."""
    return param_specs(_grouped_meta(cfg), mesh_shape, strategy)


def leaf_specs(cfg: ModelConfig, mesh_shape: Mapping[str, int], strategy: str) -> dict[str, Spec]:
    """Per port leaf, by its ``tree.leaf_paths`` key and in that order, its
    spec: the grouped leaf's, without the stacked axis' entry for a
    scan-region leaf."""
    where, _, _ = _layout(cfg)
    specs = grouped_specs(cfg, mesh_shape, strategy)
    keys = [key for key, _ in leaf_paths(init_params(cfg, None, "meta"))]
    return {port_key: specs[key] if idx is None or not specs[key] else specs[key][1:]
            for port_key, (key, idx) in zip(keys, where, strict=True)}


def zero_residuals(cfg: ModelConfig, device: str | torch.device,
                   mesh_shape: Mapping[str, int] | None = None,
                   strategy: str = "geococo") -> dict[str, torch.Tensor]:
    """f32 zeros in the grouped layout: the error-feedback residuals a run
    starts from, each of the shape of a rank's block on a mesh of
    ``mesh_shape`` under ``strategy`` (the whole leaf without a mesh)."""
    grouped = _grouped_meta(cfg)
    specs = param_specs(grouped, mesh_shape or {}, strategy)
    return {key: torch.zeros(local_shape(leaf.shape, specs[key], mesh_shape or {}),
                             dtype=torch.float32, device=device)
            for key, leaf in grouped.items()}
