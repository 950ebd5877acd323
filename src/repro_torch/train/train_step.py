"""Serve step builders (counterpart of ``repro.train.train_step``'s
``TrainConfig`` and ``build_serve_step``).

This slice runs on one card with the whole model on it: there is no mesh
and no sharding.  Training steps arrive with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.model import forward

__all__ = ["TrainConfig", "build_serve_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16


def build_serve_step(cfg: ModelConfig, tcfg: TrainConfig, *, kind: str = "decode",
                     device: str | torch.device | None = None) -> Callable:
    """Prefill: ``step(params, batch) -> logits``.
    Decode: ``step(params, cache, batch) -> (next_tokens int32, new_cache)``,
    greedy over the last position's f32 logits.  The batch is moved to
    ``device``; params and cache must already be there."""
    device = resolve_device(device)

    def _on_device(batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: v.to(device) for k, v in batch.items()}

    if kind == "prefill":
        @torch.inference_mode()
        def prefill(params, batch):
            logits, _ = forward(cfg, params, _on_device(batch),
                                compute_dtype=tcfg.compute_dtype)
            return logits

        return prefill

    if kind == "decode":
        @torch.inference_mode()
        def decode(params, cache, batch):
            logits, new_cache = forward(cfg, params, _on_device(batch), cache=cache,
                                        compute_dtype=tcfg.compute_dtype)
            next_tok = logits[:, -1].float().argmax(dim=-1)
            return next_tok.to(torch.int32), new_cache

        return decode

    raise ValueError(f"unknown serve step kind {kind!r}; known: ['prefill', 'decode']")
