"""Train and serve step builders (counterpart of ``repro.train.train_step``).

This slice runs on one card with the whole model on it: there is no mesh,
no sharding and, with one pod, no gradient sync (the reference's
``build_train_step`` skips its pod sync when ``n_pods == 1`` too).
``TrainConfig.sync`` arrives with the gradient-sync slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.layers import Params
from ..models.model import forward
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import leaves

__all__ = ["TrainConfig", "loss_fn", "grads_and_loss", "build_train_step", "build_serve_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: AdamWConfig = AdamWConfig()
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # gradient-accumulation microbatches: activation memory scales ~1/m
    microbatches: int = 1


def loss_fn(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Mean next-token NLL of ``batch["labels"]``, from an f32 log-softmax
    of the logits."""
    logits, _ = forward(cfg, params, batch, compute_dtype=compute_dtype)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, batch["labels"].long()[..., None])[..., 0].mean()


def grads_and_loss(cfg: ModelConfig, tcfg: TrainConfig, params: Params,
                   batch: dict[str, torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Gradients of ``loss_fn`` for every leaf of ``params`` (in the order of
    ``tree.leaves``) and the loss.  With ``tcfg.microbatches`` = m > 1
    the batch is cut into m equal splits along its first axis; their
    gradients are summed in f32, divided by m and cast to each parameter's
    dtype, and the loss is the mean of theirs."""
    ps = leaves(params)
    for p in ps:
        if not p.requires_grad:
            p.requires_grad_(True)
    n_micro = max(1, tcfg.microbatches)
    if n_micro == 1:
        loss = loss_fn(cfg, params, batch, tcfg.compute_dtype)
        return list(torch.autograd.grad(loss, ps)), loss.detach()
    size = next(iter(batch.values())).shape[0]
    if size % n_micro:
        raise ValueError(f"a batch of {size} does not split into {n_micro} microbatches")
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps]
    lsum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for i in range(n_micro):
        sl = slice(i * size // n_micro, (i + 1) * size // n_micro)
        loss = loss_fn(cfg, params, {k: v[sl] for k, v in batch.items()}, tcfg.compute_dtype)
        for acc, g in zip(gsum, torch.autograd.grad(loss, ps)):
            acc.add_(g.float())
        lsum += loss.detach()
    return [(acc / n_micro).to(p.dtype) for acc, p in zip(gsum, ps)], lsum / n_micro


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     device: str | torch.device | None = None) -> Callable:
    """``step(params, opt_state, batch) -> metrics``: one forward and
    backward (per microbatch), then AdamW, which updates ``params`` and
    ``opt_state`` in place.  The batch is moved to ``device``; params and
    state must already be there.  ``metrics`` holds 0-d f32 tensors
    ``loss``, ``grad_norm`` and ``lr`` (no host sync)."""
    device = resolve_device(device)

    def step(params: Params, opt_state: dict, batch: dict[str, torch.Tensor]) -> dict:
        batch = {k: v.to(device) for k, v in batch.items()}
        grads, loss = grads_and_loss(cfg, tcfg, params, batch)
        _, _, metrics = adamw_update(params, grads, opt_state, tcfg.optim)
        return dict(metrics, loss=loss)

    return step


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
