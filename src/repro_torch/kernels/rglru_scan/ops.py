"""Model-facing RG-LRU scan: the hand-written CUDA kernel on the card, the
plain PyTorch recurrence (``ref.py``) on the CPU.

Counterpart of ``repro/kernels/rglru_scan/ops.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_ref"]


@functools.cache
def _kernel():
    fn = _build.load("rglru_scan").rglru_scan_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = _build.load("rglru_scan").rglru_scan_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def rglru_scan(
    a: torch.Tensor,      # (B, T, D)
    b: torch.Tensor,      # (B, T, D)
    h0: torch.Tensor,     # (B, D)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (h (B, T, D) f32, h_T (B, D) f32).

    CPU tensors take the plain recurrence.  CUDA tensors launch the kernel,
    which takes contiguous float32 inputs; anything else raises.
    """
    bsz, t, d = a.shape
    if b.shape != a.shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, a has {tuple(a.shape)}")
    if h0.shape != (bsz, d):
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected {(bsz, d)}")
    if min(bsz, t, d) < 1:
        raise ValueError(f"empty input: (B, T, D) = {(bsz, t, d)}")
    args = (a, b, h0)
    if all(x.device.type == "cpu" for x in args):
        return rglru_scan_ref(*args)
    if any(x.device != a.device for x in args) or a.device.type != "cuda":
        raise ValueError(
            "rglru_scan takes all tensors on the CPU or all on one CUDA device; got "
            + ", ".join(str(x.device) for x in args)
        )
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError("the rglru_scan kernel takes float32 tensors only")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("the rglru_scan kernel takes contiguous tensors only")

    h = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    with torch.cuda.device(a.device):
        rc = _kernel()(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h.data_ptr(), h_last.data_ptr(),
            bsz, t, d, torch.cuda.current_stream(a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: {_error_string(rc)} ({rc})")
    rglru_scan.launches += 1
    return h, h_last


# kernel launches since the last reset; chip_smoke.py reads it around the
# main path to show that every RG-LRU layer went through the kernel
rglru_scan.launches = 0
