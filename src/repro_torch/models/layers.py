"""Shared model primitives: plain functions on tensors over nested dicts of
parameters, the subset of ``repro.models.layers`` that rwkv6 needs.

Conventions (as in the JAX package): activations compute in ``x.dtype``;
dense weights keep the JAX ``(d_in, d_out)`` layout, so ``y = x @ w``.  An
init function takes a ``torch.Generator`` (``None`` on the meta device, where
only shapes are made) and the device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict

__all__ = [
    "Params",
    "normal",
    "dense_init",
    "dense_apply",
    "rmsnorm_init",
    "rmsnorm_apply",
    "embed_init",
    "embed_apply",
    "unembed_apply",
]


def normal(gen: torch.Generator | None, shape: tuple[int, ...], scale: float,
           device: torch.device) -> torch.Tensor:
    """float32 N(0, scale^2), drawn from ``gen`` on ``device``."""
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


def dense_init(gen, d_in: int, d_out: int, device: torch.device, *,
               scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return {"w": normal(gen, (d_in, d_out), scale, device)}


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].to(x.dtype)


def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"g": torch.ones(d, device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["g"].to(x.dtype)


def embed_init(gen, vocab: int, d_model: int, device: torch.device) -> Params:
    return {"table": normal(gen, (vocab, d_model), 0.02, device)}


def embed_apply(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same numbers as casting the table first, without
    # a copy of the whole table
    return F.embedding(tokens.long(), p["table"]).to(dtype)


def unembed_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].to(x.dtype).T
