"""Train and serve step builders (counterpart of ``repro.train.train_step``).

Without a mesh the whole model sits on the rank's card.  On a mesh
``(P, D, M)`` (``launch.mesh.make_mesh``: one process a rank) each rank
holds its blocks of the parameters, of AdamW's m and v and of the
residuals, placed by the reference's rule (``dist.sharding``, applied per
layer through ``dist.grouping.leaf_specs``; under ``flat`` every leaf is
whole).  A step computes the loss on the rank's rows of the global batch
(split over ``pod`` and ``data`` as the reference's ``_fit_batch_axes``
splits it; ranks along ``model`` share rows), gathering each block's
parameters just before it runs and again in remat's recompute
(``dist.inpod``); the backward turns each gradient into this rank's block
of the pod's mean gradient as soon as autograd completes it.  The forward
and backward run under a distribution context (``dist.context``), as the
reference's ``build_train_step`` enters one: with ``model`` above 1 the
attention heads and the experts are split over ``model`` (each rank
computes its part, summed over ``model``); an MoE routes its pod's rows,
or with ``model`` above 1 each ``data`` rank's own, as the reference
does.  The blocks,
grouped as the reference stacks them (``dist.grouping``), are exchanged
across the pods by ``dist.collectives.sync_gradients`` under
``TrainConfig.sync``, and AdamW updates the blocks, its clip from the norm
of the whole gradient.  With one pod there is no exchange (the reference's
``build_train_step`` skips its pod sync when ``n_pods == 1`` too).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..device import resolve_device, synchronize
from ..dist.collectives import PodGroup, SyncConfig, WireStats, sync_gradients
from ..dist.context import DistContext, distribution
from ..dist.grouping import group_like_reference, leaf_specs, ungroup
from ..dist.inpod import InPodGroup, gather_tree
from ..dist.sharding import Spec, batch_rows, fit_batch_axes, local_shape
from ..models.layers import Params
from ..models.model import forward, init_cache, region_leaves
from ..optim.adamw import AdamWConfig, adamw_update
from ..tree import leaves, map_paths

__all__ = ["TrainConfig", "loss_fn", "grads_and_loss", "SyncGrads", "build_train_step",
           "build_serve_step", "cache_specs", "init_local_cache"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    sync: SyncConfig = SyncConfig()
    optim: AdamWConfig = AdamWConfig()
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # gradient-accumulation microbatches: activation memory scales ~1/m
    microbatches: int = 1


def loss_fn(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            compute_dtype: torch.dtype = torch.bfloat16, gather=None) -> torch.Tensor:
    """Mean next-token NLL of ``batch["labels"]``, from an f32 log-softmax
    of the logits.  ``gather`` as ``models.model.forward`` takes it."""
    logits, _ = forward(cfg, params, batch, compute_dtype=compute_dtype, gather=gather)
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, batch["labels"].long()[..., None])[..., 0].mean()


def grads_and_loss(cfg: ModelConfig, tcfg: TrainConfig, params: Params,
                   batch: dict[str, torch.Tensor], gather=None
                   ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Gradients of ``loss_fn`` for every leaf of ``params`` (in the order of
    ``tree.leaves``) and the loss.  With ``tcfg.microbatches`` = m > 1
    the batch is cut into m equal splits along its first axis; their
    gradients are summed in f32, divided by m and cast to each parameter's
    dtype, and the loss is the mean of theirs.  Under ``gather`` (blocks of
    the leaves, ``dist.inpod.gather_tree``) these are the blocks' gradients."""
    ps = leaves(params)
    for p in ps:
        if not p.requires_grad:
            p.requires_grad_(True)
    n_micro = max(1, tcfg.microbatches)
    if n_micro == 1:
        loss = loss_fn(cfg, params, batch, tcfg.compute_dtype, gather)
        return list(torch.autograd.grad(loss, ps)), loss.detach()
    size = next(iter(batch.values())).shape[0]
    if size % n_micro:
        raise ValueError(f"a batch of {size} does not split into {n_micro} microbatches")
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ps]
    lsum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for i in range(n_micro):
        sl = slice(i * size // n_micro, (i + 1) * size // n_micro)
        loss = loss_fn(cfg, params, {k: v[sl] for k, v in batch.items()}, tcfg.compute_dtype,
                       gather)
        for acc, g in zip(gsum, torch.autograd.grad(loss, ps)):
            acc.add_(g.float())
        lsum += loss.detach()
    return [(acc / n_micro).to(p.dtype) for acc, p in zip(gsum, ps)], lsum / n_micro


_INTS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}


def _checksums(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Per tensor, the int64 sum of its elements' bits read as integers: two
    ranks' parameters agree bit for bit where these do."""
    if not tensors:
        return torch.zeros(0, dtype=torch.int64)
    return torch.stack([t.detach().view(_INTS[t.element_size()]).sum(dtype=torch.int64)
                        for t in tensors]).cpu()


def _differ(sums: torch.Tensor, group: dist.ProcessGroup) -> list[int]:
    """The ranks of ``group`` whose ``sums`` differ from this rank's."""
    every = [torch.empty_like(sums) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, sums, group=group)
    return [r for r, s in enumerate(every) if not torch.equal(s, sums)]


class SyncGrads:
    """``grads(params, batch, residuals=None) -> (grads, loss, parts)``:
    the part of the step on a mesh before AdamW.  ``params`` holds this
    rank's blocks (``build_train_step``); ``batch`` is the global batch.
    ``grads`` are this rank's blocks of the synced gradient (in
    ``tree.leaves`` order), ``loss`` this rank's, ``parts`` the host
    seconds and counts of the parts (``compute_s``, ``inpod_s``,
    ``inpod_host_s``, ``tp_s``, ``tp_bytes``, ``exchange_s``, ...; see
    ``build_train_step``).  ``residuals`` are replaced in place.  ``pods``
    and ``inpod`` are the rank's groups, ``ctx`` its distribution context,
    ``specs`` every port leaf's spec by key."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device: str | torch.device | None,
                 mesh):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = resolve_device(device)
        self.pods = PodGroup(mesh.get_group("pod"))
        self.inpod = InPodGroup(mesh)
        self.ctx = DistContext.from_mesh(mesh)
        self.specs = leaf_specs(cfg, mesh.shape, tcfg.sync.strategy)
        self.model_parts = region_leaves(cfg) if mesh.shape["model"] > 1 else frozenset()

    def _gather(self, key: str, sub: Params) -> Params:
        return gather_tree(self.inpod, self.specs, key, sub, self.model_parts)

    def local(self, params: Params, batch: dict[str, torch.Tensor]
              ) -> tuple[list[torch.Tensor], torch.Tensor]:
        """This rank's blocks of its pod's mean gradient, before the
        exchange across the pods, and its loss, from its rows of the global
        ``batch``; the counts of ``inpod`` and ``ctx`` restart."""
        cfg, mesh, ctx = self.cfg, self.mesh, self.ctx
        rows = next(iter(batch.values())).shape[0]
        ctx.splits_rows = "data" in fit_batch_axes(mesh.shape, rows)
        if (cfg.moe is not None and ctx.model_size > 1 and ctx.data_size > 1
                and not ctx.splits_rows):
            raise ValueError(f"{cfg.name} on {mesh.shape}: a global batch of {rows} rows does "
                             f"not split over data, where the reference's expert parallelism "
                             f"splits a row's tokens over data; the port splits rows")
        own = batch_rows(mesh.shape, mesh.coords, rows)
        batch = {k: v[own].to(self.device) for k, v in batch.items()}
        self.inpod.reset()
        ctx.reset()
        with distribution(ctx):
            return grads_and_loss(cfg, self.tcfg, params, batch, self._gather)

    def __call__(self, params: Params, batch: dict[str, torch.Tensor],
                 residuals: dict | None = None) -> tuple[list[torch.Tensor], torch.Tensor, dict]:
        cfg, tcfg, pods, inpod, device = self.cfg, self.tcfg, self.pods, self.inpod, self.device
        if tcfg.sync.needs_residuals and pods.size > 1 and residuals is None:
            raise ValueError(f"{tcfg.sync.strategy} carries residuals: pass them to the step")
        clock = time.perf_counter  # lint: allow[wallclock] the step's parts
        pods.stats = WireStats()
        synchronize(device)
        t0 = clock()
        local, loss = self.local(params, batch)
        synchronize(device)
        t1 = clock()
        inpod_s, inpod_host_s = inpod.wall_s, inpod.stats.host_s
        grouped = group_like_reference(cfg, local)
        del local
        synced, new_res = sync_gradients(grouped, residuals, tcfg.sync, group=pods)
        del grouped
        if residuals is not None and new_res is not residuals:
            residuals.update(new_res)
        out = ungroup(cfg, synced)
        del synced
        synchronize(device)
        stats, ctx = pods.stats, self.ctx
        parts = dict(
            compute_s=t1 - t0, inpod_s=inpod_s, inpod_host_s=inpod_host_s,
            tp_s=ctx.wall_s, tp_bytes=ctx.stats.bytes_sent,
            exchange_s=clock() - t1, exchange_host_s=stats.host_s,
            dense_values=float(stats.dense_values), sparse_values=float(stats.sparse_values),
            nonzero_sent=float(stats.nonzero_sent), bytes_sent=stats.bytes_sent)
        if cfg.moe is not None:
            dropped = ctx.moe_dropped       # unknown on meta (the dry-run): the data decides
            meta = isinstance(dropped, torch.Tensor) and dropped.is_meta
            parts.update(moe_assigned=float(ctx.moe_assigned),
                         moe_dropped=math.nan if meta else float(dropped))
        return out, loss, parts


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     device: str | torch.device | None = None, mesh=None) -> Callable:
    """``step(params, opt_state, batch, residuals=None) -> metrics``: one
    forward and backward (per microbatch), then AdamW, which updates
    ``params`` and ``opt_state`` in place.  The batch is moved to ``device``;
    params and state must already be there.  ``metrics`` holds 0-d f32
    tensors ``loss``, ``grad_norm`` and ``lr`` (no host sync).

    With a ``mesh`` (``launch.mesh.Mesh``) of more than one rank, ``params``,
    ``opt_state`` and ``residuals`` (f32, grouped; required when
    ``tcfg.sync`` carries them) hold this rank's blocks (by
    ``dist.grouping.leaf_specs``), ``batch`` is the global
    batch, and the step is the one the module docstring describes; it
    replaces the residuals in place.  ``loss`` is then the mean over the
    ranks, ``pods_agree`` 1.0: the ranks of each pod group (one ``data``
    and ``model`` coordinate) end the step with the same blocks, bit for
    bit, and the ranks of a pod with the same whole leaves, and the step
    raises ``RuntimeError`` where they differ.  ``metrics`` also holds the
    host seconds of the step's parts, each ending in a device synchronise
    (``compute_s``: forward and backward, of which ``inpod_s`` the in-pod
    gathers and reduce-scatters, of which ``inpod_host_s`` staging and
    gloo, and ``tp_s`` the sums of the ``model``-parallel regions and the
    MoE's count prefix (``dist.context``); ``exchange_s``: grouping, the
    pod exchange and ungrouping, of
    which ``exchange_host_s`` staging and gloo; ``adamw_s``, with the
    norm's in-pod sum), the bytes handed to gloo in-pod (``inpod_bytes``,
    of the gathers and reduce-scatters; ``tp_bytes``, of the regions'
    sums and the count prefix) and the pod wire's counts
    (``dense_values``, ``sparse_values``, ``nonzero_sent``,
    ``bytes_sent``: ``dist.collectives.WireStats``), each a float; for an
    MoE also the assignments it routed and dropped over the step's calls
    (``moe_assigned``, ``moe_dropped``; remat's recompute routes again)."""
    device = resolve_device(device)

    if mesh is None or mesh.size <= 1:
        def step(params: Params, opt_state: dict, batch: dict[str, torch.Tensor],
                 residuals: dict | None = None) -> dict:
            batch = {k: v.to(device) for k, v in batch.items()}
            grads, loss = grads_and_loss(cfg, tcfg, params, batch)
            _, _, metrics = adamw_update(params, grads, opt_state, tcfg.optim)
            return dict(metrics, loss=loss)

        return step

    sync = SyncGrads(cfg, tcfg, device, mesh)
    inpod, pods = sync.inpod, sync.pods
    specs = list(sync.specs.values())
    replicated = [i for i, spec in enumerate(specs) if not any(spec)]

    def mesh_step(params: Params, opt_state: dict, batch: dict[str, torch.Tensor],
                  residuals: dict | None = None) -> dict:
        grads, loss, parts = sync(params, batch, residuals)
        clock = time.perf_counter  # lint: allow[wallclock] the step's parts
        t2 = clock()
        gnorm = inpod.global_norm(grads, specs)
        _, _, metrics = adamw_update(params, grads, opt_state, tcfg.optim, gnorm=gnorm)
        del grads
        synchronize(device)
        t3 = clock()
        total = loss.detach().float().reshape(1).cpu()
        dist.all_reduce(total)
        ps = leaves(params)
        differ = _differ(_checksums(ps), pods.group)
        if differ:
            raise RuntimeError(f"pod {pods.rank}: the parameters of pods {differ} differ "
                               f"from this pod's after the exchange")
        if inpod.size > 1:
            differ = _differ(_checksums([ps[i] for i in replicated]), mesh.get_group("inpod"))
            if differ:
                raise RuntimeError(f"rank {dist.get_rank()}: the whole leaves of in-pod ranks "
                                   f"{differ} differ from this rank's after the step")
        return dict(metrics, **parts, loss=total[0] / dist.get_world_size(), pods_agree=1.0,
                    adamw_s=t3 - t2, inpod_bytes=inpod.stats.bytes_sent)

    return mesh_step


# a cache's sequence splits over model from this many positions (the
# reference's _cache_shardings): a long decode's KV cache stays in memory
SEQ_SPLIT_MIN = 8192
# the leaves whose split along the sequence the attention knows how to merge
_SEQ_LEAVES = ("k", "v", "ckv", "kr")


def _cache_spec(key: str, leaf, mesh_shape: dict[str, int]) -> Spec:
    """:func:`cache_specs`' spec of the leaf at ``key``."""
    if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0:
        return ()
    dm = mesh_shape.get("model", 1)
    spec: list = [None] * leaf.ndim
    spec[0] = fit_batch_axes(mesh_shape, leaf.shape[0]) or None
    if leaf.ndim > 1 and dm > 1 and leaf.shape[1] % dm == 0 and leaf.shape[1] >= SEQ_SPLIT_MIN:
        if key.split("/")[-1] not in _SEQ_LEAVES:
            raise NotImplementedError(
                f"cache leaf {key} {tuple(leaf.shape)}: its dim 1 splits over model, "
                f"and only attention and MLA caches merge a split")
        spec[1] = "model"
    return tuple(spec)


def cache_specs(cache: Params, mesh_shape: dict[str, int]) -> Params:
    """The reference's ``_cache_shardings`` (``train/train_step.py:150-176``)
    applied to the port's cache (``models.model.init_cache``: one entry per
    layer, no stacked scan axis; ``len`` a host int): the same tree, each
    tensor leaf's spec a tuple with one entry a dimension, ``len``'s
    ``()``.  The batch dim goes over the batch axes that divide it
    (``dist.sharding.fit_batch_axes``, a tuple of axis names, or ``None``);
    the dim after it over ``model`` where it holds at least
    ``SEQ_SPLIT_MIN`` entries, ``model`` divides it and ``model`` is above
    1 (a ring cache spans a window and stays whole below that size).
    Raises ``NotImplementedError`` naming a leaf that rule splits but that
    is no attention or MLA cache: the port merges only those."""
    return map_paths(cache, lambda key, leaf: _cache_spec(key, leaf, mesh_shape))


def init_local_cache(cfg: ModelConfig, batch: int, max_len: int | None, mesh_shape: dict[str, int],
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device | None = None) -> Params:
    """One rank's part of ``init_cache(cfg, batch, max_len)`` on a mesh of
    ``mesh_shape``, laid out by :func:`cache_specs`: each leaf at its local
    shape (``dist.sharding.local_shape``: this rank's rows, and its
    ``1 / model`` of the positions where the sequence splits).  A layer
    whose cache splits along the sequence carries ``seq_shards`` (the
    ``model`` size): its attention then holds positions ``model coordinate
    x L / model`` on."""
    device = resolve_device(device)
    split = set()

    def local(key: str, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = _cache_spec(key, leaf, mesh_shape)
        if "model" in spec:
            split.add(key.split("/")[1])
        return torch.zeros(local_shape(leaf.shape, spec, mesh_shape), dtype=leaf.dtype,
                           device=device)

    cache = map_paths(init_cache(cfg, batch, max_len, dtype, "meta"), local)
    for i in split:
        cache["layers"][int(i)]["seq_shards"] = mesh_shape["model"]
    return cache


def build_serve_step(cfg: ModelConfig, tcfg: TrainConfig, *, kind: str = "decode",
                     device: str | torch.device | None = None, mesh=None) -> Callable:
    """Prefill: ``step(params, batch, rows=None) -> logits``.
    Decode: ``step(params, cache, batch, rows=None) -> (next_tokens int32,
    new_cache)``, greedy over the last position's f32 logits;
    ``step.logits(params, cache, batch, rows=None)`` is the same call
    returning ``(logits, new_cache)``.
    The batch is moved to ``device``; params and cache must already be
    there.

    With a ``mesh`` (``launch.mesh.Mesh``) of more than one rank, as the
    reference's ``build_serve_step(cfg, mesh, tcfg)`` serves: every rank
    holds the whole parameters (serving writes none; the reference's
    ``p_shard`` spreads them over ``data``, which moves memory, not
    numbers) and its part of the cache (:func:`init_local_cache`); the step
    runs under a distribution context (``dist.context``), so attention
    heads and experts split over ``model`` and a cache's sequence may
    (``models.layers``, ``models.moe``).  ``batch`` holds this rank's
    rows of the global batch (``dist.sharding.batch_rows``; ``img`` and
    ``embeds`` too) and the step is called with ``rows=`` the global row
    count; it returns its rows' logits or next tokens and its new cache.
    ``step.ctx`` holds the context, whose counts (``stats``, ``wall_s``,
    ``merge_bytes``, the MoE's) add up over the calls until
    ``step.ctx.reset()``."""
    device = resolve_device(device)
    if kind not in ("prefill", "decode"):
        raise ValueError(f"unknown serve step kind {kind!r}; known: ['prefill', 'decode']")
    ctx = DistContext.from_mesh(mesh) if mesh is not None and mesh.size > 1 else None

    @contextlib.contextmanager
    def placed(batch: dict[str, torch.Tensor], rows: int | None):
        """``batch`` (this rank's rows of ``rows``) on the device, under the
        context."""
        if ctx is None:
            yield {k: v.to(device) for k, v in batch.items()}
            return
        if rows is None:
            raise ValueError("a step on a mesh takes this rank's rows of the batch and "
                             "rows=, the global row count")
        ctx.splits_rows = "data" in fit_batch_axes(mesh.shape, rows)
        if (cfg.moe is not None and ctx.model_size > 1 and ctx.data_size > 1
                and not ctx.splits_rows):
            raise ValueError(f"{cfg.name} on {mesh.shape}: a global batch of {rows} rows does "
                             f"not split over data, where the reference's expert parallelism "
                             f"splits its tokens over data; the port splits rows")
        own = batch_rows(mesh.shape, mesh.coords, rows)
        n = next(iter(batch.values())).shape[0]
        if n != own.stop - own.start:
            raise ValueError(f"a batch of {n} rows is not this rank's {own} of {rows}")
        with distribution(ctx):
            yield {k: v.to(device) for k, v in batch.items()}

    if kind == "prefill":
        @torch.inference_mode()
        def prefill(params, batch, rows: int | None = None):
            with placed(batch, rows) as local:
                logits, _ = forward(cfg, params, local, compute_dtype=tcfg.compute_dtype)
            return logits

        prefill.ctx = ctx
        return prefill

    @torch.inference_mode()
    def logits(params, cache, batch, rows: int | None = None):
        with placed(batch, rows) as local:
            return forward(cfg, params, local, cache=cache, compute_dtype=tcfg.compute_dtype)

    @torch.inference_mode()
    def decode(params, cache, batch, rows: int | None = None):
        out, new_cache = logits(params, cache, batch, rows)
        next_tok = out[:, -1].float().argmax(dim=-1)
        return next_tok.to(torch.int32), new_cache

    decode.logits = logits
    decode.ctx = ctx
    return decode
