"""Carry a JAX parameter tree into the port's parameters.

The JAX tree (``repro.models.model.init_params``), given as numpy arrays,
stacks the scanned layers: ``tree["scan"]`` is a tuple with one entry per
pattern block, each leaf with a leading ``n_scan`` axis.  The port keeps one
entry per layer under ``params["layers"]``.  Leaves are keyed by the same
``/``-joined paths the JAX checkpoint writes into ``meta.json``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..tree import leaf_paths
from .layers import Params
from .model import init_params

__all__ = ["params_from_jax"]


def _jax_location(cfg: ModelConfig, layer: int) -> tuple[str, int | None]:
    """JAX path prefix of port layer ``layer`` and its index on the stacked
    axis (None outside the scanned region)."""
    prefix, n_scan, pattern, _ = cfg.scan_partition()
    if layer < len(prefix):
        return f"prefix/{layer}", None
    i = layer - len(prefix)
    if i < n_scan * len(pattern):
        return f"scan/{i % len(pattern)}", i // len(pattern)
    return f"suffix/{i - n_scan * len(pattern)}", None


def params_from_jax(cfg: ModelConfig, tree: Any, *,
                    device: str | torch.device | None = None) -> Params:
    """The port's parameters holding the JAX tree's values, in float32
    (``model.cast_params_`` casts them for serving).  Raises
    ``ValueError`` on a missing or extra leaf, or a shape that differs."""
    device = resolve_device(device)
    jax_leaves = dict(leaf_paths(tree))
    used: set[str] = set()

    def fetch(port_key: str, like: torch.Tensor) -> torch.Tensor:
        parts = port_key.split("/")
        idx = None
        if parts[0] == "layers":
            loc, idx = _jax_location(cfg, int(parts[1]))
            jax_key = "/".join([loc, *parts[2:]])
        else:
            jax_key = port_key
        if jax_key not in jax_leaves:
            raise ValueError(f"JAX tree has no leaf {jax_key!r} (for {port_key!r})")
        used.add(jax_key)
        arr = np.asarray(jax_leaves[jax_key])
        if idx is not None:
            n_scan = cfg.scan_partition()[1]
            if arr.ndim == 0 or arr.shape[0] != n_scan:
                raise ValueError(
                    f"{jax_key!r} has shape {arr.shape}, expected a leading "
                    f"scan axis of {n_scan}"
                )
            arr = arr[idx]
        if arr.shape != tuple(like.shape):
            raise ValueError(
                f"{jax_key!r} has shape {arr.shape}, expected {tuple(like.shape)}"
            )
        return torch.from_numpy(arr.astype(np.float32)).to(device)

    def build(tree_: Any, key: str) -> Any:
        if isinstance(tree_, dict):
            return {k: build(v, f"{key}/{k}" if key else k) for k, v in tree_.items()}
        if isinstance(tree_, list):
            return [build(v, f"{key}/{i}") for i, v in enumerate(tree_)]
        return fetch(key, tree_)

    params = build(init_params(cfg, None, "meta"), "")
    extra = sorted(set(jax_leaves) - used)
    if extra:
        raise ValueError(f"JAX tree has leaves the port does not use: {extra}")
    return params
