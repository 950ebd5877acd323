"""The white-data gradient filter over one array or a whole gradient tree:
the hand-written CUDA kernel on the card, the plain PyTorch version
(``ref.py``) on the CPU.

Counterpart of ``repro/kernels/whitedata_filter/ops.py``, without its
``use_kernel`` and ``interpret`` switches: the device of the tensors decides.
The kernel runs over the flat elements with no padding, so ``kept`` is
``ref.py``'s count for every tau; the reference's kernel path, which pads to
a multiple of 256, counts the padding as kept when tau <= 0.  Tensors on the
meta device take the kernel's checks and allocations with no launch.  Every
call reports its work (``kernels.work``) to the active cost counter,
whatever runs it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, work
from .ref import whitedata_filter_ref

__all__ = ["whitedata_filter", "filter_gradient", "whitedata_filter_ref"]

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    fn = _build.load("whitedata_filter").whitedata_filter_forward
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_float]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = _build.load("whitedata_filter").whitedata_filter_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def _route(g: torch.Tensor, r: torch.Tensor) -> str:
    """``"cpu"`` where (g, r) takes the plain version (both on the CPU),
    ``"cuda"`` where the kernel takes them, ``"meta"`` where it would;
    raises on what neither version takes."""
    if g.shape != r.shape:
        raise ValueError(f"r has shape {tuple(r.shape)}, g has {tuple(g.shape)}")
    if g.device.type == "cpu" and r.device.type == "cpu":
        return "cpu"
    if g.device != r.device or g.device.type not in ("cuda", "meta"):
        raise ValueError("whitedata_filter takes g and r both on the CPU, both on one CUDA "
                         f"device or both on meta; got {g.device} and {r.device}")
    if g.dtype not in KERNEL_DTYPES or r.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the whitedata_filter kernel takes float32 or bfloat16 g and r; "
                        f"got {g.dtype} and {r.dtype}")
    if not (g.is_contiguous() and r.is_contiguous()):
        raise ValueError("the whitedata_filter kernel takes contiguous tensors only")
    return g.device.type


def _work(g: torch.Tensor, r: torch.Tensor) -> work.Work:
    return work.whitedata_filter(g.numel(), g.element_size(), r.element_size())


def _tau_arg(tau, device: torch.device) -> tuple[torch.Tensor | None, float]:
    """(device pointer, value) for the kernel: a CUDA tensor is read on the
    device (no host sync, so the call stays graph-capturable), anything else
    is passed by value."""
    if isinstance(tau, torch.Tensor):
        if tau.numel() != 1:
            raise ValueError(f"tau must be a scalar; got shape {tuple(tau.shape)}")
        if tau.device.type == "cuda":
            if tau.device != device:
                raise ValueError(f"tau lies on {tau.device}, g on {device}")
            return tau.to(torch.float32).reshape(()), 0.0
    return None, float(tau)


def _launch(g, r, tau_dev, tau_value, kept: torch.Tensor):
    """The kernel over g and r, adding its count into ``kept`` (an int32
    element on g's device); on meta, the outputs only."""
    send = torch.empty_like(g)
    new_r = torch.empty_like(r)
    if g.numel() == 0 or g.device.type == "meta":
        return send, new_r
    with torch.cuda.device(g.device):
        rc = _kernel()(
            g.data_ptr(), r.data_ptr(), int(g.dtype == torch.bfloat16),
            int(r.dtype == torch.bfloat16),
            None if tau_dev is None else tau_dev.data_ptr(), tau_value,
            send.data_ptr(), new_r.data_ptr(), kept.data_ptr(), g.numel(),
            torch.cuda.current_stream(g.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"whitedata_filter kernel launch failed: {_error_string(rc)} ({rc})")
    whitedata_filter.launches += 1
    return send, new_r


def whitedata_filter(
    g: torch.Tensor, r: torch.Tensor, tau: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Filter one array (any shape).  Returns (send in g's dtype, new_r in
    r's dtype, kept: int32 scalar on g's device).

    CPU tensors take the plain version.  CUDA tensors launch the kernel,
    which takes contiguous float32 or bfloat16 g and r (each its own);
    anything else raises.  Meta tensors give the outputs under the kernel's
    conditions, with no launch.
    """
    route = _route(g, r)
    with work.kernel_call(_work(g, r)):
        if route == "cpu":
            return whitedata_filter_ref(g, r, tau)
        tau_dev, tau_value = _tau_arg(tau, g.device)
        kept = torch.zeros((), dtype=torch.int32, device=g.device)
        send, new_r = _launch(g, r, tau_dev, tau_value, kept)
    return send, new_r, kept


def _walk(grads, residuals, leaf):
    """(send tree, new_r tree) with ``grads``' structure, ``leaf(g, r)``
    giving each pair of leaves."""
    if isinstance(grads, dict):
        if not isinstance(residuals, dict) or residuals.keys() != grads.keys():
            raise ValueError("residuals do not have the structure of grads")
        pairs = {k: _walk(v, residuals[k], leaf) for k, v in grads.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    if isinstance(grads, list):
        if not isinstance(residuals, list) or len(residuals) != len(grads):
            raise ValueError("residuals do not have the structure of grads")
        pairs = [_walk(a, b, leaf) for a, b in zip(grads, residuals)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return leaf(grads, residuals)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def filter_gradient(grads, residuals, tau: torch.Tensor | float):
    """Apply the filter across a gradient tree (nested dicts and lists of
    tensors, as the port's parameters are).

    Returns (send_tree, new_residual_tree, stats) with the trees in
    ``grads``' structure and stats = {"kept": int32, "total": int32,
    "density": f32}, scalars on the leaves' device.  A tree of more than
    2**31 - 1 elements raises, as the reference's int32 total does.
    """
    leaves = _tensors(grads)
    if not leaves:
        raise ValueError("filter_gradient needs at least one leaf")
    device = leaves[0].device
    total = sum(g.numel() for g in leaves)
    if total > 2**31 - 1:
        raise OverflowError(f"the tree holds {total:,} elements; stats['total'] is int32")
    tau_dev, tau_value = _tau_arg(tau, device)
    # one int32 slot per leaf, zeroed once: each launch adds its count into its own
    counts = torch.zeros(len(leaves), dtype=torch.int32, device=device)
    slots = iter(counts)

    def leaf(g, r):
        if g.device != device or r.device != device:
            raise ValueError(f"filter_gradient takes every leaf on one device; got "
                             f"{g.device} and {r.device} beside {device}")
        route = _route(g, r)
        with work.kernel_call(_work(g, r)):
            if route == "cpu":
                s, nr, k = whitedata_filter_ref(g, r, tau)
                next(slots).copy_(k)
                return s, nr
            return _launch(g, r, tau_dev, tau_value, next(slots))

    send, new_r = _walk(grads, residuals, leaf)
    kept = counts.sum(dtype=torch.int32)
    total_t = torch.full((), total, dtype=torch.int32, device=device)
    density = kept.float() / torch.full((), float(total), dtype=torch.float32, device=device)
    return send, new_r, {"kept": kept, "total": total_t, "density": density}


# kernel launches since the last reset; chip_smoke.py reads it around the
# main path to show that every leaf went through the kernel
whitedata_filter.launches = 0
