"""What one rank's step costs, counted as it runs (the counterpart of
``repro.launch.hlo_cost``, which parses the compiled HLO; eager PyTorch has
no such program, so the count is taken from what the step dispatches).

:class:`CostMode` is a ``TorchDispatchMode``.  Over the operations on its
device it counts:

* ``flops``: each aten operation's FLOPs by ``torch.utils.flop_counter``'s
  registered formulas (matmuls, convolutions, attention), plus each kernel
  call's work as its wrapper reports it (``kernels.work``; the operations a
  wrapper runs inside, the plain version on the CPU among them, are not
  counted).  Eager dispatch repeats every loop body, so no trip count needs
  fixing up.
* ``bytes``: the HBM traffic estimate, every operation's operand and output
  bytes (every operation is unfused in eager mode), views left out, plus
  each kernel call's bytes.
* ``peak_bytes``: the high-water mark of live storage bytes, counting the
  arguments held from the start (:meth:`CostMode.hold`) and every storage
  an operation makes until it is freed; the storages kernels and the wire
  make count here too.

On the meta device an operation that returns new tensors is run once for
each layout of its arguments (sizes, strides, dtypes and the other
arguments) and its results' layout remembered: the meta kernels of
PyTorch's pointwise operations run in Python, some 300 us a call, and a
step repeats a few layouts many thousand times (a flash loop over one-key
chunks).  A repeat makes empty meta tensors of the remembered layout.  What
is dispatched, and so what is counted, does not change.

The wire's counts (bytes to gloo a rank, by axis) are read from the port's
own counters (``dist.collectives.PodGroup``, ``dist.inpod.InPodGroup``,
``dist.context.DistContext``), which the meta branches keep as the real
path does; ``launch.dryrun`` reads them.  A step on the meta device, on the
CPU or on the card counts the same FLOPs and bytes when it dispatches the
same operations.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import work

__all__ = ["CostMode"]


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an operation's
    arguments and results, a step's state), in no set order."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class CostMode(TorchDispatchMode):
    """Count the FLOPs, bytes and peak live storage of the operations on
    ``device`` (``"meta"``, ``"cpu"`` or a card) while it is entered.
    Operations on other devices (the host's bookkeeping beside a step on
    the card) are not counted.  ``kernel_flops`` and ``kernel_bytes`` are
    the kernels' share of ``flops`` and ``bytes``, ``kernel_calls`` their
    number."""

    def __init__(self, device: str | torch.device):
        super().__init__()
        self.device = torch.device(device)
        self.flops = 0
        self.bytes = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.kernel_calls = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._hidden = 0
        self._live: dict[int, int] = {}
        self._layouts: dict = {}

    # ---- storage tracking -------------------------------------------------

    def _on_device(self, x: torch.Tensor) -> bool:
        dev = x.device
        return dev == self.device or (dev.type == self.device.type and self.device.index is None)

    def _track(self, x: torch.Tensor, nbytes: int | None = None) -> None:
        """Count ``x``'s storage as live until it is freed (once)."""
        st = x.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes() if nbytes is None else nbytes
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def hold(self, tree: Any, nbytes: int | None = None) -> None:
        """Count the storages of ``tree``'s tensors (a step's arguments) as
        live from now on, each at ``nbytes`` where given (a global batch of
        which the rank holds its rows)."""
        for x in _tensors(tree):
            before = self.live_bytes
            self._track(x, nbytes)
            self.argument_bytes += self.live_bytes - before

    # ---- the kernels' and the wire's hooks (kernels.work) -----------------

    def add_kernel(self, w: work.Work) -> None:
        if self._hidden:
            return
        self.flops += w.flops
        self.bytes += w.nbytes
        self.kernel_flops += w.flops
        self.kernel_bytes += w.nbytes
        self.kernel_calls += 1

    @contextlib.contextmanager
    def hide(self) -> Iterator[None]:
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def __enter__(self):
        work.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.COUNTERS.remove(self)
        return super().__exit__(*exc)

    # ---- dispatch ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula, traffic, fresh, composite = _kind(func)
        if composite:
            # a composite operation (as inference mode dispatches them) runs
            # its decomposition here, so that its parts are counted as they
            # are with grad on
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = (self._meta_call(func, args, kwargs) if fresh and self.device.type == "meta"
               else func(*args, **kwargs))
        outs = [x for x in _tensors(out) if self._on_device(x)]
        for x in outs:
            self._track(x)
        if self._hidden or not (formula or traffic):
            return out
        ins = [x for x in _tensors((args, kwargs)) if self._on_device(x)]
        if outs or ins:
            if formula:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            if traffic:
                self.bytes += sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
        return out

    def _meta_call(self, func, args, kwargs):
        """``func(*args, **kwargs)`` on meta, by its results' layout where
        arguments of this layout were seen before.  A layout is remembered
        only where the results are storages of their own that an empty
        tensor of that layout reproduces: an operation whose schema
        promises new tensors may still return a view (``_unsafe_view``),
        and the peak must see it share its input's storage."""
        key = (func, _layout(args), _layout(kwargs))
        try:
            shapes = self._layouts.get(key)
        except TypeError:       # an argument that has no layout key
            return func(*args, **kwargs)
        if shapes is None:
            out = func(*args, **kwargs)
            self._layouts[key] = _own_layout(out, (args, kwargs))
            return out
        if shapes is False:
            return func(*args, **kwargs)
        kind, shapes = shapes
        outs = [torch.empty_strided(size, stride, dtype=dtype, device="meta")
                for size, stride, dtype in shapes]
        return outs[0] if kind is torch.Tensor else kind(outs)

    def summary(self) -> dict:
        """The counts as plain numbers."""
        return {"flops": self.flops, "bytes": self.bytes, "kernel_flops": self.kernel_flops,
                "kernel_bytes": self.kernel_bytes, "kernel_calls": self.kernel_calls,
                "argument_bytes": self.argument_bytes, "peak_bytes": self.peak_bytes}


# operations that allocate and move no bytes
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided,
               torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}


_KINDS: dict = {}


def _kind(func) -> tuple:
    """``(FLOP formula or None, whether it moves bytes, whether it returns
    only new tensors and writes no argument, whether it is a composite to
    decompose)`` of an operation: a view (outputs aliasing an input it does
    not write) and an empty allocation move no bytes; an operation with a
    FLOP formula is counted whole."""
    kind = _KINDS.get(func)
    if kind is None:
        returns = func._schema.returns
        view = bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                     for r in returns)
        fresh = (bool(returns)
                 and all(r.alias_info is None and isinstance(r.type, torch.TensorType)
                         for r in returns)
                 and not any(a.alias_info is not None and a.alias_info.is_write
                             for a in func._schema.arguments))
        formula = flop_registry.get(func._overloadpacket)
        dk = torch._C.DispatchKey.CompositeImplicitAutograd
        composite = formula is None and (
            dk in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk))
        kind = _KINDS[func] = (formula, not view and func._overloadpacket not in _NO_TRAFFIC,
                               fresh, composite)
    return kind


def _own_layout(out: Any, inputs: Any) -> tuple | bool:
    """``(type of out, [(size, stride, dtype)])`` of an operation's results
    on meta when each is a storage of its own, shared with no input and no
    other result, of the size and offset an empty tensor of its layout
    has; else ``False``."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    if not all(isinstance(x, torch.Tensor) and x.is_meta for x in outs):
        return False
    seen = {id(x.untyped_storage()) for x in _tensors(inputs)}
    for x in outs:
        st = x.untyped_storage()
        empty = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")
        if (id(st) in seen or x.storage_offset()
                or st.nbytes() != empty.untyped_storage().nbytes()):
            return False
        seen.add(id(st))
    return type(out), [(x.shape, x.stride(), x.dtype) for x in outs]


def _layout(x: Any) -> Any:
    """A hashable key of an operation's arguments that fixes its results'
    layout on meta: each tensor's sizes, strides, dtype and device (not its
    storage offset), and every other argument with its type (2 and 2.0
    promote differently)."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return (type(x), *map(_layout, x))
    if isinstance(x, dict):
        return tuple((k, _layout(v)) for k, v in x.items())
    return (type(x), x)
