"""In-pod sharding: the collectives over a pod's ``data`` and ``model``
axes (the reference shards with GSPMD inside a pod, ``repro.dist.sharding``).

Each rank holds its block (``sharding.local_shard``) of every parameter,
of AdamW's m and v and of geococo's residuals, by the reference's
``_leaf_spec``.  A train step gathers a leaf just before it is used and
frees it after (:func:`gather_tree`, an autograd function), and the
backward of that gather turns the leaf's full gradient into this rank's
block of the pod's gradient, the mean over ``data`` (:meth:`InPodGroup.
reduce_scatter_mean`).  Ranks along ``model`` compute on the same rows
with the same gathered weights, so outside a ``model``-parallel region
(``dist.context``) their full gradients are equal: a rank keeps its own
``model`` block of it, with no message.  A leaf used inside a region
(attention's projections, the MoE's router and experts, when ``model``
is above 1) has a part of its gradient on each ``model`` rank: it is
summed over ``model`` first (a reduce-scatter along the leaf's ``model``
dimension, else a sum in rank order), then averaged over ``data``.  Then
each rank
exchanges its blocks across the pods (``collectives.sync_gradients`` over
the ranks of its (``data``, ``model``) coordinates), as the reference's
fully manual ``shard_map`` does: the filter's ``min_leaf_size`` and its
chunks see the block the rank holds (the reference's partial-auto path
would strip ``data`` and ``model`` and filter the pod's whole leaf).

Every message is staged through pinned host buffers for gloo
(``collectives.PodGroup``), and counted apart from the pod wire: one
``WireStats`` for the in-pod groups (``bytes_sent``, ``host_s``) and the
host time spent in the in-pod collectives in all (``wall_s``, ending in a
device synchronise).
"""

from __future__ import annotations

import time
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from ..device import synchronize
from ..tree import map_paths
from .collectives import PodGroup, WireStats
from .sharding import INPOD, Spec, unshard

__all__ = ["InPodGroup", "gather_tree"]


class InPodGroup:
    """This rank's in-pod axes: their sizes and its coordinates, the
    process groups of ``data``, ``model`` and the whole pod, and the counts
    of what their collectives moved.  ``mesh`` is a ``launch.mesh.Mesh``
    (``shape``, ``coords``, ``get_group``)."""

    def __init__(self, mesh: Any):
        self.sizes = {a: mesh.shape[a] for a in INPOD}
        self.coords = {a: mesh.coords[a] for a in INPOD}
        self._groups = {a: PodGroup(mesh.get_group(a)) for a in (*INPOD, "inpod")}
        self.reset()

    @property
    def size(self) -> int:
        return self.sizes["data"] * self.sizes["model"]

    def reset(self) -> None:
        """Zero the counts."""
        self.stats = WireStats()
        self.wall_s = 0.0
        for group in self._groups.values():
            group.stats = self.stats

    def _group(self, spec: Spec) -> PodGroup | None:
        """The group over the in-pod axes ``spec`` splits (a spec names only
        axes of more than one rank), if any."""
        axes = [a for a in INPOD if a in spec]
        if not axes:
            return None
        return self._groups["inpod" if len(axes) == 2 else axes[0]]

    def counts_once(self, spec: Spec) -> bool:
        """Whether this rank's block is the one to count of the ranks that
        hold the same block: those at coordinate 0 on every in-pod axis
        ``spec`` does not split."""
        return all(self.coords[a] == 0 for a in INPOD if a not in spec)

    def _timed(self, device: torch.device, t0: float) -> None:
        synchronize(device)
        self.wall_s += time.perf_counter() - t0  # lint: allow[wallclock] the in-pod part

    def gather(self, shard: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The full leaf from every rank's block of it (``shard`` this
        rank's), on ``shard``'s device."""
        group = self._group(spec)
        if group is None:
            return shard
        t0 = time.perf_counter()  # lint: allow[wallclock] the in-pod part
        blocks = group.all_gather(shard.detach())
        full = unshard(list(blocks.unbind(0)), spec, self.sizes)
        self._timed(shard.device, t0)
        return full

    def reduce_scatter_mean(self, grad: torch.Tensor, spec: Spec,
                            model_parts: bool = False) -> torch.Tensor:
        """This rank's block of the mean over ``data`` of the ranks' full
        gradients ``grad`` of a leaf of ``spec``: its own ``model`` block
        (with ``model_parts``, the ranks' gradients are parts of the
        leaf's along ``model``: first summed over them), then summed over
        the ``data`` ranks (their blocks of a split leaf, the whole of a
        leaf ``data`` does not split) and divided by their number."""
        t0 = time.perf_counter()  # lint: allow[wallclock] the in-pod part
        model = self._groups["model"] if self.sizes["model"] > 1 else None
        if model_parts and model is not None:
            if "model" in spec:
                grad = model.reduce_scatter_sum(grad.movedim(-1, 0).contiguous()).movedim(0, -1)
            else:
                grad = model.all_gather_sum(grad)
        elif "model" in spec:
            width = grad.shape[-1] // self.sizes["model"]
            grad = grad.narrow(-1, self.coords["model"] * width, width)
        n = self.sizes["data"]
        if n > 1:
            data = self._groups["data"]
            if "data" in spec:
                grad = data.reduce_scatter_sum(grad.contiguous()) / n
            else:
                grad = data.all_reduce_sum(grad) / n
        grad = grad.contiguous()
        self._timed(grad.device, t0)
        return grad

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the pod's ranks."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()  # lint: allow[wallclock] the in-pod part
        out = self._groups["inpod"].all_reduce_sum(x)
        self._timed(x.device, t0)
        return out

    def global_norm(self, grads: Sequence[torch.Tensor], specs: Sequence[Spec]) -> torch.Tensor:
        """The norm of the full gradient whose blocks ``grads`` are: the
        squares of each block summed where this rank counts it
        (:meth:`counts_once`), then over the pod's ranks."""
        total = sum((torch.sum(torch.square(g.float())) for g, spec in zip(grads, specs, strict=True)
                     if self.counts_once(spec)),
                    torch.zeros((), device=grads[0].device))
        return torch.sqrt(self.all_reduce_sum(total))

    def gather_to_first(self, shard: torch.Tensor, spec: Spec) -> torch.Tensor | None:
        """The full leaf on the host of the pod's first rank (``data`` 0,
        ``model`` 0), ``None`` on the others; every rank of the pod calls it."""
        if not self.counts_once(spec):
            return None
        host = shard.detach().to("cpu", copy=True)
        group = self._group(spec)
        if group is None:
            return host
        dst = dist.get_global_rank(group.group, 0)
        if group.rank != 0:
            dist.gather(host, None, dst=dst, group=group.group)
            return None
        parts = [torch.empty_like(host) for _ in range(group.size)]
        dist.gather(host, parts, dst=dst, group=group.group)
        return unshard(parts, spec, self.sizes)


class _Gather(torch.autograd.Function):
    """Forward: the full leaf from the ranks' blocks.  Backward: this
    rank's block of the pod's mean gradient."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, inpod: InPodGroup, spec: Spec,
                model_parts: bool) -> torch.Tensor:
        ctx.inpod, ctx.spec, ctx.model_parts = inpod, spec, model_parts
        full = inpod.gather(shard, spec)
        return full.view_as(full) if full is shard else full

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.inpod.reduce_scatter_mean(grad, ctx.spec, ctx.model_parts), None, None, None


def gather_tree(inpod: InPodGroup, specs: Mapping[str, Spec], prefix: str, tree: Any,
                model_parts: frozenset[str] = frozenset()) -> Any:
    """The full leaves of the subtree ``tree`` at ``prefix`` of a sharded
    parameter tree (``specs`` by leaf key), differentiable: the gradient
    of each reaches its block as :meth:`InPodGroup.reduce_scatter_mean`
    gives it, summed over ``model`` first for the keys in
    ``model_parts`` (the leaves used inside a ``model``-parallel region).
    A leaf that no in-pod rank splits, averages or sums is itself."""
    def one(key: str, shard: torch.Tensor) -> torch.Tensor:
        spec, parts = specs[key], key in model_parts and inpod.sizes["model"] > 1
        if inpod.sizes["data"] == 1 and not any(spec) and not parts:
            return shard
        return _Gather.apply(shard, inpod, spec, parts)

    return map_paths(tree, one, prefix)
