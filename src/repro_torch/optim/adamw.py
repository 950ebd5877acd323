"""AdamW with cosine schedule, grad clipping and a dtype policy (the port's
own copy of ``repro.optim.adamw``).

The arithmetic is the reference's, in the same order and in float32: the
clip scale from the global norm, the bias corrections, then per leaf
m, v, the update and weight decay.  Where the JAX step donates its buffers
and returns new ones, this one updates parameters and m, v in place under
``torch.no_grad()``: a copy of billions of f32 parameters would not fit on
the card beside the state.  The m/v dtype is ``state_dtype`` (bf16 for the
lean policy); the step is an int32 0-d tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..tree import leaves

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: torch.dtype = torch.float32     # m/v dtype (bf16 for the lean policy)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {key: _map(sub, fn) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(sub, fn) for sub in tree)
    return fn(tree)


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero m and v in ``cfg.state_dtype`` beside each parameter, and step 0."""
    device = leaves(params)[0].device
    return {
        "m": _map(params, lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)),
        "v": _map(params, lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine to 0 at ``total_steps``;
    float32 from the int32 ``step``, as the reference divides."""
    warm = torch.clamp(step.float() / float(max(cfg.warmup_steps, 1)), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps).float() / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
        0.0, 1.0,
    )
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig, *,
                 gnorm: torch.Tensor | None = None) -> tuple[Any, dict, dict]:
    """One optimizer step, in place: ``params``, ``state["m"]``,
    ``state["v"]`` and ``state["step"]`` are updated and returned.  Returns
    (params, state, metrics) with metrics {"grad_norm", "lr"} as 0-d f32
    tensors on the parameters' device.  The clip scale comes from
    ``gnorm``, the norm of the whole gradient, which a rank holding blocks
    of the leaves (``dist.inpod``) passes in; by default
    ``global_norm(grads)``.  Everything else is elementwise, so it runs on
    blocks as on whole leaves."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), strict=True):
        # the reference's roundings, one op at a time, with at most three
        # leaf-sized temporaries (m and v in f32 are updated where they lie)
        g32 = g.float() * scale
        m32 = m.float().mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
        v32 = v.float().mul_(cfg.b2).add_(g32.square_().mul_(1 - cfg.b2))
        del g32
        delta = (m32 / b1c).div_(torch.sqrt(v32 / b2c).add_(cfg.eps))
        delta.add_(p.float() * cfg.weight_decay)
        p.sub_(delta.mul_(lr))
        del delta
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
