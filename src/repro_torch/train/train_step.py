"""Train and serve step builders (counterpart of ``repro.train.train_step``).

The whole model sits on each rank's card.  With a mesh of more than one pod
(``launch.mesh.make_mesh``, shape ``(P, 1, 1)``: one process per pod), each
pod computes the loss on its rows of the global batch, and the gradients are
exchanged once a step by ``dist.collectives.sync_gradients`` under
``TrainConfig.sync``, in the reference's leaf layout
(``dist.grouping``), before AdamW.  With no mesh or one pod there is no
exchange (the reference's ``build_train_step`` skips its pod sync when
``n_pods == 1`` too).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..device import resolve_device, synchronize
from ..dist.collectives import PodGroup, SyncConfig, WireStats, sync_gradients
from ..dist.grouping import group_like_reference, ungroup
from ..models.layers import Params
from ..models.model import forward
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import leaves

__all__ = ["TrainConfig", "loss_fn", "grads_and_loss", "build_train_step", "build_serve_step"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    sync: SyncConfig = SyncConfig()
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


_INTS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}


def _checksums(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Per tensor, the int64 sum of its elements' bits read as integers: two
    pods' parameters agree bit for bit where these do."""
    return torch.stack([t.detach().view(_INTS[t.element_size()]).sum(dtype=torch.int64)
                        for t in tensors]).cpu()


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     device: str | torch.device | None = None, mesh=None) -> Callable:
    """``step(params, opt_state, batch, residuals=None) -> metrics``: one
    forward and backward (per microbatch), then AdamW, which updates
    ``params`` and ``opt_state`` in place.  The batch is moved to ``device``;
    params and state must already be there.  ``metrics`` holds 0-d f32
    tensors ``loss``, ``grad_norm`` and ``lr`` (no host sync).

    With a ``mesh`` (a ``DeviceMesh`` with a ``pod`` axis) of P > 1 pods,
    ``batch`` is the global batch: this pod takes its rows
    ``[p B / P, (p + 1) B / P)``, and after the backward the gradients,
    grouped as the reference stacks them, go through ``sync_gradients``
    with ``residuals`` (f32, grouped; required when ``tcfg.sync`` carries
    them), which the step replaces in place by the new ones.  ``loss`` is
    then the mean over the pods, ``pods_agree`` 1.0: every pod ends the
    step with the same parameters, bit for bit, and the step raises
    ``RuntimeError`` on every pod where they differ.  ``metrics`` also
    holds the host
    seconds of the step's parts (``compute_s``: forward and backward;
    ``exchange_s``: grouping, exchange and ungrouping, of which
    ``exchange_host_s`` staging and gloo; ``adamw_s``) and the wire's counts
    (``dense_values``, ``sparse_values``, ``nonzero_sent``, ``bytes_sent``:
    ``dist.collectives.WireStats``), each a float."""
    device = resolve_device(device)
    pods = PodGroup(mesh.get_group("pod")) if mesh is not None else None

    if pods is None or pods.size <= 1:
        def step(params: Params, opt_state: dict, batch: dict[str, torch.Tensor],
                 residuals: dict | None = None) -> dict:
            batch = {k: v.to(device) for k, v in batch.items()}
            grads, loss = grads_and_loss(cfg, tcfg, params, batch)
            _, _, metrics = adamw_update(params, grads, opt_state, tcfg.optim)
            return dict(metrics, loss=loss)

        return step

    n = pods.size

    def pod_step(params: Params, opt_state: dict, batch: dict[str, torch.Tensor],
                 residuals: dict | None = None) -> dict:
        if tcfg.sync.needs_residuals and residuals is None:
            raise ValueError(f"{tcfg.sync.strategy} carries residuals: pass them to the step")
        rows = next(iter(batch.values())).shape[0]
        if rows % n:
            raise ValueError(f"a global batch of {rows} does not split over {n} pods")
        own = slice(pods.rank * rows // n, (pods.rank + 1) * rows // n)
        batch = {k: v[own].to(device) for k, v in batch.items()}
        clock = time.perf_counter  # lint: allow[wallclock] the step's parts
        synchronize(device)
        t0 = clock()
        grads, loss = grads_and_loss(cfg, tcfg, params, batch)
        synchronize(device)
        t1 = clock()
        pods.stats = WireStats()
        grouped = group_like_reference(cfg, grads)
        del grads
        synced, new_res = sync_gradients(grouped, residuals, tcfg.sync, group=pods)
        del grouped
        if residuals is not None and new_res is not residuals:
            residuals.update(new_res)
        grads = ungroup(cfg, synced)
        del synced
        synchronize(device)
        t2 = clock()
        _, _, metrics = adamw_update(params, grads, opt_state, tcfg.optim)
        synchronize(device)
        t3 = clock()
        total = loss.detach().float().reshape(1).cpu()
        dist.all_reduce(total, group=pods.group)
        sums = _checksums(leaves(params))
        every = [torch.empty_like(sums) for _ in range(n)]
        dist.all_gather(every, sums, group=pods.group)
        differ = [p for p, s in enumerate(every) if not torch.equal(s, sums)]
        if differ:
            raise RuntimeError(f"pod {pods.rank}: the parameters of pods {differ} differ "
                               f"from this pod's after the exchange")
        stats = pods.stats
        return dict(metrics, loss=total[0] / n, pods_agree=1.0,
                    compute_s=t1 - t0, exchange_s=t2 - t1,
                    exchange_host_s=stats.host_s, adamw_s=t3 - t2,
                    dense_values=float(stats.dense_values),
                    sparse_values=float(stats.sparse_values),
                    nonzero_sent=float(stats.nonzero_sent), bytes_sent=stats.bytes_sent)

    return pod_step


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
