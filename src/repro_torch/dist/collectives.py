"""Device-plane synchronization over the pod axis (the counterpart of
``repro.dist.collectives``): GeoCoCo's three levers on ``torch.distributed``.

* **grouping / hierarchy** (paper Sec 4.2): ``hier`` exchanges what each
  device holds of a leaf, and :func:`relay_psum` is the aggregator relay
  ring in an explicit ``order``;
* **task-preserving filtering** (Sec 4.3): ``geococo`` runs
  :func:`chunked_topk_exchange`, a density-based top-k with error-feedback
  residuals: the dropped mass is carried to the next step, not lost;
* **consistency-guaranteed transmission** (Sec 4.4): every strategy is a
  deterministic exchange whose sums every pod adds in one order, so the
  pods end it holding the same gradients, bit for bit.

Strategies register under ``("device_sync", name)`` in the port's registry
(``repro_torch.core.strategies``), under the reference's names.

The port is multi-controller: one process per rank of the mesh, each with
its own share of the batch, so the exchange below is the real one, over
the ranks that hold the same blocks in every pod (``dist.inpod``: what a
rank exchanges is its block of each leaf, as in the reference's fully
manual ``shard_map``).  Its wire is gloo:
every message is staged from the device into a pinned host buffer, crosses
gloo, and is copied back (:class:`PodGroup`).  The top-k, the masks and
the residuals stay on the device, and so do the relay ring's sums; the
all-reduce's sum runs inside gloo, on the host.  ``geococo`` hands the wire
its whole masked tensor, zeros included, so the bytes that cross it are
those of a dense exchange.

:func:`estimate_sync_bytes` is the analytic wire model, the reference's:
it counts a (value, index) pair for each top-k selection, which this wire
does not send yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core import strategies
from ..kernels import work
from ..tree import leaves as tree_leaves

__all__ = [
    "SyncConfig",
    "DeviceSyncStrategy",
    "PodGroup",
    "WireStats",
    "sync_gradients",
    "relay_psum",
    "chunked_topk_exchange",
    "topk_select",
    "estimate_sync_bytes",
]

_INDEX_BYTES = 4  # chunk-local top-k index cost per transmitted value


# ---------------------------------------------------------------------------
# strategy objects + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceSyncStrategy:
    """One named gradient-exchange strategy.

    ``wire_values(n, cfg, shard_factor)`` returns ``(dense_values,
    sparse_values)``: how many dense values and how many (value, index)
    pairs of an ``n``-element leaf cross the pod boundary per all-reduce.
    ``shard_factor`` is how many in-pod devices a leaf is split across.

    ``react(cfg, event)`` returns an updated :class:`SyncConfig` for a
    control-plane event, or ``None`` for no reaction: ``hier`` and
    ``geococo`` adopt the relay ring of a
    :class:`~repro_torch.control.events.RelayOrderChanged`.
    """

    name: str
    needs_residuals: bool
    wire_values: Callable[[float, "SyncConfig", float], tuple[float, float]]
    react: Callable[["SyncConfig", Any], "SyncConfig | None"] | None = None


def _dense_wire(n: float, cfg: "SyncConfig", shard_factor: float = 1.0):
    return float(n), 0.0


def _topk_wire(n: float, cfg: "SyncConfig", shard_factor: float = 1.0):
    local_n = n / max(shard_factor, 1.0)
    if local_n < cfg.min_leaf_size:
        return float(n), 0.0  # small (per-shard) leaves are exchanged densely
    n_chunks = math.ceil(local_n / cfg.chunk)
    k = max(1, int(round(cfg.density * cfg.chunk)))
    return 0.0, float(n_chunks * min(k, cfg.chunk) * max(shard_factor, 1.0))


def _react_relay_order(cfg: "SyncConfig", event: Any) -> "SyncConfig | None":
    """Ring-bearing strategies adopt the control plane's new relay order."""
    from ..control.events import RelayOrderChanged

    if isinstance(event, RelayOrderChanged):
        order = tuple(int(i) for i in event.order)
        if order != cfg.ring_order:
            return dataclasses.replace(cfg, ring_order=order)
    return None


strategies.register(
    "device_sync", "flat",
    DeviceSyncStrategy("flat", needs_residuals=False, wire_values=_dense_wire),
)
strategies.register(
    "device_sync", "hier",
    DeviceSyncStrategy("hier", needs_residuals=False, wire_values=_dense_wire,
                       react=_react_relay_order),
)
strategies.register(
    "device_sync", "geococo",
    DeviceSyncStrategy("geococo", needs_residuals=True, wire_values=_topk_wire,
                       react=_react_relay_order),
)


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    """Device-plane sync strategy configuration.

    ``strategy`` must name a registered ``device_sync`` strategy.
    ``density`` is the kept fraction per chunk for the filtered exchange;
    ``chunk`` the top-k selection granularity; ``min_leaf_size`` the element
    count below which a leaf skips filtering (norm scales and biases are
    always sent densely).  ``ring_order`` is the pod relay ring for the
    exchange; ``None`` keeps the all-reduce.
    """

    strategy: str = "hier"
    density: float = 0.10
    chunk: int = 2048
    min_leaf_size: int = 4096
    ring_order: tuple[int, ...] | None = None

    def __post_init__(self):
        known = strategies.names("device_sync")
        if self.strategy not in known:
            raise ValueError(
                f"unknown sync strategy {self.strategy!r}; registered: {known}"
            )
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")
        if self.min_leaf_size < 0:
            raise ValueError(
                f"min_leaf_size must be >= 0, got {self.min_leaf_size}"
            )
        if self.ring_order is not None:
            order = tuple(int(i) for i in self.ring_order)
            if sorted(order) != list(range(len(order))):
                raise ValueError(
                    f"ring_order must be a permutation of 0..n_pods-1, "
                    f"got {self.ring_order}"
                )
            object.__setattr__(self, "ring_order", order)

    @property
    def spec(self) -> DeviceSyncStrategy:
        return strategies.get("device_sync", self.strategy)

    @property
    def needs_residuals(self) -> bool:
        return self.spec.needs_residuals


# ---------------------------------------------------------------------------
# the wire: gloo over host buffers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WireStats:
    """What one rank's exchanges did since the last reset.

    ``dense_values`` counts the values of leaves exchanged densely,
    ``sparse_values`` the selections of the top-k masks (k per chunk, the
    (value, index) pairs a sparse wire carries), ``nonzero_sent`` the
    nonzero values among those selections.  ``bytes_sent`` is what this
    rank handed to gloo (for an all-reduce, gloo's ring moves
    2 (n - 1) / n of the tensor a rank), ``host_s`` the host time of the
    staging and the gloo calls, from a device synchronise before the copy
    to the host to the end of the copy back."""

    dense_values: int = 0
    sparse_values: int = 0
    nonzero_sent: int = 0
    bytes_sent: float = 0.0
    host_s: float = 0.0


class PodGroup:
    """The process group of one mesh axis (the pod axis; ``dist.inpod``
    uses it for the in-pod axes too), with the host buffers its messages
    are staged through and the counts of what crossed it.

    gloo moves host tensors only, so a device tensor is copied into a
    pinned host buffer before each gloo call and back after it; the buffers
    are kept and grown to the largest message.  ``rank`` and ``size`` are
    this process' index on the axis and the axis' size.

    A message on the meta device (the dry-run, ``launch.dryrun``) is
    neither staged nor handed to gloo: each collective counts the bytes
    the real one would (``host_s`` stays 0) and returns a meta tensor of
    the real one's shape.  The staging and copies are hidden from a cost
    counter (``kernels.work.hidden``): their cost is the bytes on the
    link."""

    def __init__(self, group: dist.ProcessGroup | None = None):
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.stats = WireStats()
        self._bufs: list[torch.Tensor | None] = [None, None]

    def _host(self, i: int, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """Host buffer ``i`` viewed as a tensor of ``shape`` and ``dtype``."""
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            self._bufs[i] = None            # free the old buffer before pinning the new one
            buf = self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf[:nbytes].view(dtype).view(shape)

    def _recv_buffer(self, shape: tuple[int, ...], like: torch.Tensor) -> torch.Tensor:
        """Where a message of ``shape`` and ``like``'s dtype lands on the
        host: host buffer 1 for a device tensor, a new tensor for a host one."""
        if like.device.type == "cpu":
            return torch.empty(shape, dtype=like.dtype)
        return self._host(1, shape, like.dtype)

    def _stage_out(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if x.device.type == "cpu":
            return x.contiguous()
        torch.cuda.synchronize(x.device)
        host = self._host(i, tuple(x.shape), x.dtype)
        host.copy_(x)
        return host

    def _back(self, host: torch.Tensor, device: torch.device) -> torch.Tensor:
        if device.type == "cpu":
            return host
        return host.to(device)

    def _sent(self, nbytes: float, t0: float, meta: bool) -> None:
        self.stats.bytes_sent += nbytes
        if not meta:
            self.stats.host_s += time.perf_counter() - t0  # lint: allow[wallclock] the wire's host time

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the pods (gloo's all-reduce), on ``x``'s
        device; ``x`` itself is left as it is."""
        t0 = time.perf_counter()  # lint: allow[wallclock] the wire's host time
        meta = x.device.type == "meta"
        with work.hidden():
            if meta:
                out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            else:
                host = self._stage_out(x, 0)
                if host is x:
                    host = x.clone()
                dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
                out = self._back(host, x.device)
        self._sent(2 * (self.size - 1) / self.size * x.numel() * x.element_size(), t0, meta)
        return out

    def ring_pass(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """Send ``x`` to pod ``dst`` while receiving the same-shaped message
        from pod ``src``; every send and receive of the round is posted
        together and waited on together."""
        t0 = time.perf_counter()  # lint: allow[wallclock] the wire's host time
        meta = x.device.type == "meta"
        with work.hidden():
            if meta:
                out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            else:
                send = self._stage_out(x, 0)
                recv = self._recv_buffer(tuple(x.shape), x)
                ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(self.group, dst),
                                  self.group),
                       dist.P2POp(dist.irecv, recv, dist.get_global_rank(self.group, src),
                                  self.group)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
                out = self._back(recv, x.device)
        self._sent(x.numel() * x.element_size(), t0, meta)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every member's ``x`` (all of one shape), stacked along a new first
        axis in member order, on ``x``'s device."""
        t0 = time.perf_counter()  # lint: allow[wallclock] the wire's host time
        meta = x.device.type == "meta"
        with work.hidden():
            if meta:
                out = torch.empty((self.size, *x.shape), dtype=x.dtype, device=x.device)
            else:
                send = self._stage_out(x, 0)
                recv = self._recv_buffer((self.size, *x.shape), x)
                dist.all_gather(list(recv.unbind(0)), send, group=self.group)
                out = self._back(recv, x.device)
        self._sent((self.size - 1) * x.numel() * x.element_size(), t0, meta)
        return out

    def all_gather_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the members' ``x`` added on the device in member
        order, ``acc = acc + x_j``: the same bits on every member."""
        parts = self.all_gather(x.contiguous())
        acc = parts[0]
        for j in range(1, self.size):
            acc = acc + parts[j]
        return acc

    def reduce_scatter_sum(self, x: torch.Tensor) -> torch.Tensor:
        """This member's block of the sum of the members' ``x``: ``x`` is cut
        along its first axis into as many equal blocks as there are members,
        member j receives every member's block j and adds them on the
        device in member order, ``acc = acc + block``."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()  # lint: allow[wallclock] the wire's host time
        if x.shape[0] % self.size:
            raise ValueError(f"a first axis of {x.shape[0]} does not split over {self.size} ranks")
        shape = (self.size, x.shape[0] // self.size, *x.shape[1:])
        meta = x.device.type == "meta"
        with work.hidden():
            if meta:
                blocks = torch.empty(shape, dtype=x.dtype, device=x.device)
            else:
                send = self._stage_out(x, 0).view(shape)
                recv = self._recv_buffer(shape, x)
                ops = []
                for j in range(self.size):
                    if j != self.rank:
                        peer = dist.get_global_rank(self.group, j)
                        ops += [dist.P2POp(dist.isend, send[j], peer, self.group),
                                dist.P2POp(dist.irecv, recv[j], peer, self.group)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
                recv[self.rank].copy_(send[self.rank])
                blocks = self._back(recv, x.device)
        self._sent((self.size - 1) * (x.numel() // self.size) * x.element_size(), t0, meta)
        acc = blocks[0]
        for j in range(1, self.size):
            acc = acc + blocks[j]
        return acc


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def relay_psum(x: torch.Tensor, group: PodGroup, order=None) -> torch.Tensor:
    """All-reduce over the pods via an explicit relay ring.

    ``order`` is the ring order of pod indices: pod ``order[i]`` sends to
    ``order[i + 1]``.  On each of the n - 1 rounds a pod passes on the
    message it received last (first its own ``x``), so after the last
    round it holds every pod's ``x``.  Every pod then adds them in the
    sequence of the reference's pod ``order[0]``, ``acc = acc + msg`` with
    the messages in the order that pod receives them, so the pods hold the
    same bits (each pod of the reference adds in its own order, and with
    more than two pods their sums may differ in the last bits).  A pod
    keeps the n - 1 messages it received until the sum.
    """
    if order is None:
        order = tuple(range(group.size))
    n = len(order)
    if n <= 1:
        return x
    pos = list(order).index(group.rank)
    dst, src = int(order[(pos + 1) % n]), int(order[(pos - 1) % n])
    held = {pos: x}                     # ring position -> that pod's x
    msg = x
    for r in range(1, n):
        msg = group.ring_pass(msg, dst, src)
        held[(pos - r) % n] = msg
    acc = held.pop(0)
    for i in range(n - 1, 0, -1):       # pod order[0] receives order[-1], order[-2], ...
        acc = acc + held.pop(i)
    return acc


def _pod_mean(x: torch.Tensor, group: PodGroup, n_pods: int, order) -> torch.Tensor:
    """Mean over pods: through the explicit relay ring when an order is set,
    else an all-reduce."""
    if order is None:
        return group.all_reduce_sum(x) / n_pods
    return relay_psum(x, group, order) / n_pods


def _topk_mask(m: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row mask selecting the ``k`` largest-|.| entries of ``m``.  On a
    tie at the k-th magnitude ``torch.topk`` may pick either entry, where
    the reference's ``lax.top_k`` keeps the lower index."""
    rows, chunk = m.shape
    if k >= chunk:
        return torch.ones_like(m)
    idx = torch.topk(m.abs(), k, dim=1, sorted=False).indices
    return torch.zeros_like(m).scatter_(1, idx, 1.0)


def topk_select(grad: torch.Tensor, residual: torch.Tensor | None, *,
                density: float = 0.10, chunk: int = 2048
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The device work of :func:`chunked_topk_exchange` before the mean:
    ``(sent, new_residual, mask)``, each ``(rows, chunk)`` in f32 over
    ``grad + residual`` raveled and zero-padded at its end only."""
    acc = grad.float()
    if residual is not None:
        acc = acc + residual.float()
    flat = acc.reshape(-1)
    pad = (-flat.numel()) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    m = flat.view(-1, chunk)
    mask = _topk_mask(m, max(1, int(round(density * chunk))))
    sent = m * mask
    return sent, m - sent, mask


def chunked_topk_exchange(
    grad: torch.Tensor,
    residual: torch.Tensor | None,
    group: PodGroup,
    *,
    density: float = 0.10,
    chunk: int = 2048,
    order: tuple[int, ...] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Density-based top-k gradient exchange with error feedback.

    Per ``chunk``-sized block, only the ``density`` fraction of
    largest-magnitude entries of ``grad + residual`` (f32) crosses the pod
    boundary; the rest stays in the new residual and is carried to the next
    step.  Returns ``(pod mean of the sent values in grad's dtype,
    new_residual in f32)``.  With ``density=1.0`` this is a plain pod mean
    and the residual returns to zero.  ``order`` routes the sum over the
    relay ring (:func:`relay_psum`).

    On the meta device the selections are counted from the chunks (k per
    chunk, as ``topk_select`` always keeps), and the nonzero values among
    them, which depend on the data, are not.
    """
    shape, n = grad.shape, grad.numel()
    sent, new_res, mask = topk_select(grad, residual, density=density, chunk=chunk)
    if mask.device.type == "meta":
        group.stats.sparse_values += mask.shape[0] * min(max(1, int(round(density * chunk))), chunk)
    else:
        with work.hidden():
            group.stats.sparse_values += int(torch.count_nonzero(mask))
            group.stats.nonzero_sent += int(torch.count_nonzero(sent))
    del mask
    new_res = new_res.reshape(-1)[:n].view(shape)
    out = _pod_mean(sent, group, group.size, order)
    del sent
    return out.reshape(-1)[:n].view(shape).to(grad.dtype), new_res


def sync_gradients(
    grads: dict[str, torch.Tensor],
    residuals: dict[str, torch.Tensor] | None,
    cfg: SyncConfig,
    *,
    group: PodGroup | None = None,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor] | None]:
    """Synchronize a gradient mapping (key -> tensor, the grouped layout of
    ``dist.grouping``) across the pods of ``group`` under ``cfg.strategy``.

    With no group, or a group of one pod, this is the identity (the input
    objects are returned untouched).  Leaves are exchanged one at a time,
    each one's temporaries freed before the next.

    Returns ``(synced_grads, new_residuals)``.  ``new_residuals`` is
    ``None`` whenever ``residuals`` is ``None`` and the strategy carries no
    state.
    """
    n_pods = 1 if group is None else group.size
    if n_pods <= 1:
        return grads, residuals
    order = cfg.ring_order
    if order is not None and len(order) != n_pods:
        raise ValueError(
            f"ring_order {order} does not cover the {n_pods}-pod axis"
        )
    if not cfg.spec.needs_residuals:
        synced = {}
        for key, g in grads.items():
            group.stats.dense_values += g.numel()
            synced[key] = _pod_mean(g, group, n_pods, order)
        return synced, residuals

    res = residuals
    if res is None:
        res = {key: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
               for key, g in grads.items()}
    synced, new_res = {}, {}
    for key, g in grads.items():
        if g.numel() < cfg.min_leaf_size:
            group.stats.dense_values += g.numel()
            synced[key], new_res[key] = _pod_mean(g, group, n_pods, order), res[key]
        else:
            synced[key], new_res[key] = chunked_topk_exchange(
                g, res[key], group, density=cfg.density, chunk=cfg.chunk, order=order)
    return synced, new_res


# ---------------------------------------------------------------------------
# analytic wire model
# ---------------------------------------------------------------------------


def estimate_sync_bytes(
    n_params: float | Any,
    cfg: SyncConfig,
    n_pods: int,
    *,
    bytes_per_value: int = 4,
    shard_factor: float = 1.0,
) -> float:
    """Analytic inter-pod bytes per device per step.

    ``n_params`` is either an element count or a tree of leaves (nested
    dicts and lists of tensors, as ``tree.leaves`` walks them), in which
    case the per-leaf accounting (``min_leaf_size`` dense fallback,
    chunk-granular top-k) matches :func:`sync_gradients`.  When leaves are
    split across in-pod devices, pass ``shard_factor`` (devices per leaf):
    the dense-fallback threshold applies to ``leaf.numel() / shard_factor``.

    The exchange volume model is the ring all-reduce ``2 (P-1)/P`` factor;
    filtered values pay ``bytes_per_value + 4`` for the chunk-local index.

    On a mesh that splits leaves within a pod (``dist.inpod``), one rank's
    wire is this over the rank's own blocks, ``shard_factor`` 1.  The
    ``shard_factor`` form over whole leaves counts the pod's devices
    together, a whole (replicated) leaf once, where each device sends it.
    """
    if n_pods <= 1:
        return 0.0
    spec = cfg.spec
    if isinstance(n_params, (int, float)):
        sizes = [float(n_params)]
    else:
        sizes = [float(leaf.numel()) for leaf in tree_leaves(n_params)]
    dense = sparse = 0.0
    for n in sizes:
        d, s = spec.wire_values(n, cfg, shard_factor)
        dense += d
        sparse += s
    ring = 2.0 * (n_pods - 1) / n_pods
    return ring * (
        dense * bytes_per_value + sparse * (bytes_per_value + _INDEX_BYTES)
    )
