"""Model-facing WKV6: the hand-written CUDA kernel on the card, the plain
PyTorch recurrence (``ref.py``) on the CPU.

Counterpart of ``repro/kernels/rwkv6_wkv/ops.py``.  The kernel reads the
model's (B, T, H, N) layout directly, so no transposes are needed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import wkv6_ref

__all__ = ["wkv6", "wkv6_ref", "KERNEL_HEAD_DIMS"]

# head dims the kernel is instantiated for (smoke config 16, rwkv6-7b 64)
KERNEL_HEAD_DIMS = (16, 64)


@functools.cache
def _kernel():
    fn = _build.load("wkv6").wkv6_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = _build.load("wkv6").wkv6_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def wkv6(
    r: torch.Tensor,      # (B, T, H, N)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,      # decay in (0, 1)
    u: torch.Tensor,      # (H, N)
    state: torch.Tensor,  # (B, H, N, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, N) f32, final state (B, H, N, N) f32).

    CPU tensors take the plain recurrence.  CUDA tensors launch the kernel,
    which takes contiguous float32 inputs on 16-byte boundaries with head
    dim in ``KERNEL_HEAD_DIMS``; anything else raises.
    """
    b, t, h, n = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, r has {tuple(r.shape)}")
    if u.shape != (h, n):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {(h, n)}")
    if state.shape != (b, h, n, n):
        raise ValueError(f"state has shape {tuple(state.shape)}, expected {(b, h, n, n)}")
    if min(b, t, h) < 1:
        raise ValueError(f"empty input: (B, T, H, N) = {(b, t, h, n)}")
    args = (r, k, v, w, u, state)
    if all(x.device.type == "cpu" for x in args):
        return wkv6_ref(*args)
    if any(x.device != r.device for x in args) or r.device.type != "cuda":
        raise ValueError(
            "wkv6 takes all tensors on the CPU or all on one CUDA device; got "
            + ", ".join(str(x.device) for x in args)
        )
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError("the wkv6 kernel takes float32 tensors only")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("the wkv6 kernel takes contiguous tensors only")
    if any(x.data_ptr() % 16 for x in args):
        raise ValueError("the wkv6 kernel takes tensors that start on 16-byte boundaries")
    if n not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel is built for head dims {KERNEL_HEAD_DIMS}, got {n}")

    y = torch.empty_like(r)
    s_fin = torch.empty_like(state)
    with torch.cuda.device(r.device):
        rc = _kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
            b, t, h, n, torch.cuda.current_stream(r.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: {_error_string(rc)} ({rc})")
    wkv6.launches += 1
    return y, s_fin


# kernel launches since the last reset; chip_smoke.py reads it around the
# main path to show that every layer went through the kernel
wkv6.launches = 0
