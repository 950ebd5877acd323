"""Distribution context: the mesh as the model code sees it (the
counterpart of ``repro.dist.context``).

The mesh step enters :func:`distribution` around the forward and backward,
as the reference's ``build_train_step`` does, so that the layers that
split their work over ``model`` (attention heads in ``models.layers``,
experts in ``models.moe``) and the MoE's routing over the pod's rows can
consult the mesh without threading it through every call.
:func:`current` returns ``None`` outside any such region: the layers then
compute whole.

A ``model``-parallel region is what the reference's manual ``shard_map``
over ``model`` is: each rank of a ``model`` group computes a part of a
sum on the same rows.  :meth:`DistContext.enter` opens it (the identity
forward; its backward sums the cotangent over ``model`` in f32, the
transpose of the reference's replicated input), :meth:`DistContext.exit`
closes it (the sum over ``model`` in f32, the reference's
``psum(out, "model")``; its backward the identity).  In a decode over a
cache whose sequence is split over ``model``, :meth:`DistContext.gather_model`
hands every rank the ranks' partial softmax sums
(``models.layers.seq_split_attention``).  f32 is the least:
under f64 compute the boundaries and sums stay f64 (:func:`wide`).  Each sum gathers the
ranks' parts and adds them in rank order, so every rank of the group
holds the same bits.  Their messages, the sequence split's gathers and
the MoE's count prefix over ``data`` are counted apart from the in-pod
gathers (``stats``: the ``tp_bytes`` of a step, of which ``merge_bytes``
the sequence split's; ``wall_s``: its ``tp_s``, ending in a device
synchronise).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator

import torch

from ..device import synchronize
from .collectives import PodGroup, WireStats
from .sharding import fit_batch_axes

__all__ = ["DistContext", "distribution", "current", "wide"]


def wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a region's boundary and sums: f32, or ``dtype`` where
    it is wider (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


class DistContext:
    """This rank's place on the mesh: each axis' size (``sizes``) and its
    coordinates (``coords``), the ``model`` and ``data`` groups of its
    regions, and whether the ``data`` ranks of its pod hold different rows
    of the pod's batch (``splits_rows``).  ``groups`` maps ``"model"`` and
    ``"data"`` to a :class:`~.collectives.PodGroup` where that axis has
    more than one rank."""

    def __init__(self, sizes: dict[str, int], coords: dict[str, int],
                 groups: dict[str, PodGroup] | None = None, splits_rows: bool = False):
        self.sizes = {a: sizes.get(a, 1) for a in ("pod", "data", "model")}
        self.coords = {a: coords.get(a, 0) for a in ("pod", "data", "model")}
        self.groups = dict(groups or {})
        self.splits_rows = splits_rows
        self.reset()

    @classmethod
    def from_mesh(cls, mesh: Any, rows: int = 0) -> "DistContext":
        """The context of this rank of ``mesh`` (``launch.mesh.Mesh``) for
        a global batch of ``rows`` rows, split as ``sharding.batch_rows``
        splits it."""
        groups = {a: PodGroup(mesh.get_group(a)) for a in ("data", "model") if mesh.shape[a] > 1}
        return cls(mesh.shape, mesh.coords, groups,
                   splits_rows="data" in fit_batch_axes(mesh.shape, rows))

    @property
    def pod_size(self) -> int:
        return self.sizes["pod"]

    @property
    def data_size(self) -> int:
        return self.sizes["data"]

    @property
    def model_size(self) -> int:
        return self.sizes["model"]

    @property
    def model_coord(self) -> int:
        return self.coords["model"]

    @property
    def data_coord(self) -> int:
        return self.coords["data"]

    def experts(self, n_experts: int) -> tuple[int, int, int]:
        """The reference's expert-parallel layout: (``e_pad``, ``e_local``,
        this rank's first expert).  The expert count is padded to a
        multiple of ``model`` (the padded experts are zeros that are never
        routed to) and rank ``m`` along ``model`` holds experts ``m *
        e_local`` to ``(m + 1) * e_local``."""
        e_pad = -(-n_experts // self.model_size) * self.model_size
        e_local = e_pad // self.model_size
        return e_pad, e_local, self.model_coord * e_local

    def reset(self) -> None:
        """Zero the counts: the regions' wire and the MoE's assignments."""
        self.stats = WireStats()
        self.wall_s = 0.0
        self.merge_bytes = 0.0
        for group in self.groups.values():
            group.stats = self.stats
        self.moe_assigned = 0
        self.moe_dropped: torch.Tensor | int = 0

    def count_moe(self, keep: torch.Tensor) -> None:
        """Add one MoE call's assignments, ``keep`` True where one is kept
        (no host sync)."""
        self.moe_assigned += keep.numel()
        self.moe_dropped = self.moe_dropped + (keep.numel() - keep.sum())

    def _sum(self, axis: str, x: torch.Tensor) -> torch.Tensor:
        """The sum over ``axis`` of the ranks' ``x`` in f32 (or ``x``'s
        dtype where that is wider), added in rank order, in ``x``'s dtype."""
        group = self.groups.get(axis)
        if group is None:
            return x
        t0 = time.perf_counter()  # lint: allow[wallclock] the regions' part
        acc = group.all_gather_sum(x.to(wide(x.dtype)))
        synchronize(x.device)
        self.wall_s += time.perf_counter() - t0  # lint: allow[wallclock] the regions' part
        return acc.to(x.dtype)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Open a ``model``-parallel region on ``x``: ``x`` itself, whose
        cotangent is summed over ``model`` on the way back."""
        return _Enter.apply(x, self) if self.model_size > 1 else x

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        """Close a region: the sum of the ranks' parts ``y`` over ``model``,
        whose cotangent reaches every part unchanged."""
        return _Exit.apply(y, self) if self.model_size > 1 else y

    def gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """Every ``model`` rank's ``x`` (all of one shape), stacked along a
        new first axis in rank order (``x[None]`` without a ``model``
        group); its bytes are counted in ``stats`` and ``merge_bytes``."""
        group = self.groups.get("model")
        if group is None:
            return x[None]
        t0 = time.perf_counter()  # lint: allow[wallclock] the regions' part
        sent = self.stats.bytes_sent
        every = group.all_gather(x.contiguous())
        synchronize(x.device)
        self.merge_bytes += self.stats.bytes_sent - sent
        self.wall_s += time.perf_counter() - t0  # lint: allow[wallclock] the regions' part
        return every

    def rows_before(self, counts: torch.Tensor) -> torch.Tensor:
        """The sum of ``counts`` over the pod's ``data`` ranks before this
        one (zeros on the first; the pod's rows in ``batch_rows`` order)."""
        group = self.groups.get("data")
        if group is None or not self.splits_rows:
            return torch.zeros_like(counts)
        t0 = time.perf_counter()  # lint: allow[wallclock] the regions' part
        every = group.all_gather(counts.contiguous())
        before = every[:self.data_coord].sum(dim=0)
        synchronize(counts.device)
        self.wall_s += time.perf_counter() - t0  # lint: allow[wallclock] the regions' part
        return before


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dctx: DistContext) -> torch.Tensor:
        ctx.dctx = dctx
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.dctx._sum("model", grad), None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, dctx: DistContext) -> torch.Tensor:
        return dctx._sum("model", y)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


_STACK: list[DistContext] = []


@contextlib.contextmanager
def distribution(ctx: DistContext) -> Iterator[DistContext]:
    """Activate ``ctx`` for the enclosed model code."""
    _STACK.append(ctx)
    try:
        yield ctx
    finally:
        _STACK.pop()


def current() -> DistContext | None:
    return _STACK[-1] if _STACK else None
