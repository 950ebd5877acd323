"""The reference's leaf layout for the pod exchange.

The reference exchanges its parameter tree as ``init_params`` builds it:
the scanned layers stacked, one leaf per pattern position with a leading
``n_scan`` axis, under ``scan/{j}/...``.  The port keeps one leaf per layer
(``params["layers"][i]``).  The exchange decides per leaf (dense below
``min_leaf_size``, else chunked over the raveled leaf, chunks crossing layer
boundaries), so the port groups its gradients as the reference stacks them
before the exchange and ungroups the result after.  Residuals live in the
grouped layout.

A grouped tree is a dict from the reference's ``/``-joined leaf paths to
tensors, in the reference's leaf order.  The mapping from a port layer to
its place in the reference is ``models.convert``'s, the paths those of
``tree.leaf_paths``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from ..configs.base import ModelConfig
from ..models.convert import _jax_location
from ..models.model import init_params
from ..tree import leaf_paths

__all__ = ["group_like_reference", "ungroup", "zero_residuals"]


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


def zero_residuals(cfg: ModelConfig, device: str | torch.device) -> dict[str, torch.Tensor]:
    """f32 zeros in the grouped layout: the error-feedback residuals a run
    starts from."""
    grouped = group_like_reference(cfg, [p for _, p in leaf_paths(init_params(cfg, None, "meta"))])
    return {key: torch.zeros(leaf.shape, dtype=torch.float32, device=device)
            for key, leaf in grouped.items()}
