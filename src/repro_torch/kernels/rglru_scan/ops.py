"""Model-facing RG-LRU scan: the hand-written CUDA kernels on the card, the
plain PyTorch recurrence and its reverse sweep (``ref.py``) on the CPU.

Counterpart of ``repro/kernels/rglru_scan/ops.py``.

``rglru_scan`` is differentiable: where grad is on and an input requires
it, it runs as a ``torch.autograd.Function`` that saves a and the f32 h and
whose backward is ``rglru_scan_backward`` (the backward kernel on the
card).  Otherwise, as under ``torch.inference_mode``, it saves nothing.

Tensors on the meta device (the dry-run, ``launch.dryrun``) take the
kernels' checks and allocations with no launch.  Every call reports its
work (``kernels.work``) to the active cost counter, whatever runs it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, work
from .ref import rglru_scan_backward_ref, rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_backward", "rglru_scan_ref", "rglru_scan_backward_ref"]


@functools.cache
def _kernel(lib: str, fn_name: str, n_ptrs: int):
    fn = getattr(_build.load(lib), fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(lib: str, code: int) -> str:
    fn = getattr(_build.load(lib), f"{lib}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def _check_shapes(a, b, h0) -> None:
    bsz, t, d = a.shape
    if b.shape != a.shape:
        raise ValueError(f"b has shape {tuple(b.shape)}, a has {tuple(a.shape)}")
    if h0.shape != (bsz, d):
        raise ValueError(f"h0 has shape {tuple(h0.shape)}, expected {(bsz, d)}")
    if min(bsz, t, d) < 1:
        raise ValueError(f"empty input: (B, T, D) = {(bsz, t, d)}")


def _route(args) -> str:
    """``"cpu"`` when every tensor lies on the CPU; ``"cuda"`` when all lie
    on one CUDA device and the kernels take them, ``"meta"`` when all lie
    on the meta device and the kernels would take them; raises otherwise."""
    if all(x.device.type == "cpu" for x in args):
        return "cpu"
    dev = args[0].device
    if any(x.device != dev for x in args) or dev.type not in ("cuda", "meta"):
        raise ValueError(
            "rglru_scan takes all tensors on the CPU, on one CUDA device or on meta; got "
            + ", ".join(str(x.device) for x in args)
        )
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError("the rglru_scan kernels take float32 tensors only")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("the rglru_scan kernels take contiguous tensors only")
    return dev.type


def _launch(lib: str, fn_name: str, ptrs, bsz: int, t: int, d: int, device) -> None:
    with torch.cuda.device(device):
        rc = _kernel(lib, fn_name, len(ptrs))(
            *(x.data_ptr() for x in ptrs), bsz, t, d,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{lib} kernel launch failed: {_error_string(lib, rc)} ({rc})")


def _forward(a, b, h0) -> tuple[torch.Tensor, torch.Tensor]:
    route = _route((a, b, h0))
    with work.kernel_call(work.rglru(*a.shape)):
        if route == "cpu":
            return rglru_scan_ref(a, b, h0)
        h = torch.empty_like(a)
        h_last = torch.empty_like(h0)
    if route == "cuda":
        _launch("rglru_scan", "rglru_scan_forward", (a, b, h0, h, h_last), *a.shape, a.device)
        rglru_scan.launches += 1
    return h, h_last


def rglru_scan_backward(a, h, h0, dh, dh_last) -> tuple[torch.Tensor, ...]:
    """Gradients (da, db, dh0) of ``rglru_scan(a, b, h0)``, whose output was
    ``h``, given dh (B, T, D) and dh_last (B, D).  CPU tensors take the plain
    reverse scan; CUDA tensors launch the backward kernel, which takes
    contiguous float32 inputs; meta tensors take its checks and
    allocations with no launch."""
    _check_shapes(a, h, h0)
    if dh.shape != a.shape or dh_last.shape != h0.shape:
        raise ValueError(
            f"dh {tuple(dh.shape)} / dh_last {tuple(dh_last.shape)} do not match h "
            f"{tuple(a.shape)} / h0 {tuple(h0.shape)}"
        )
    args = (a, h, h0, dh, dh_last)
    route = _route(args)
    with work.kernel_call(work.rglru_backward(*a.shape)):
        if route == "cpu":
            return rglru_scan_backward_ref(*args)
        da, db, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    if route == "cuda":
        _launch("rglru_scan_backward", "rglru_scan_backward", (*args, da, db, dh0), *a.shape,
                a.device)
        rglru_scan_backward.launches += 1
    return da, db, dh0


class _Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h, h_last = _forward(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        ctx.b_dtype = b.dtype
        return h, h_last

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dh, dh_last):
        a, h, h0 = ctx.saved_tensors
        dh = torch.zeros_like(h) if dh is None else dh.float().contiguous()
        dh_last = torch.zeros_like(h0) if dh_last is None else dh_last.float().contiguous()
        da, db, dh0 = rglru_scan_backward(a, h, h0, dh, dh_last)
        need = ctx.needs_input_grad
        return (da.to(a.dtype) if need[0] else None, db.to(ctx.b_dtype) if need[1] else None,
                dh0.to(h0.dtype) if need[2] else None)


def rglru_scan(
    a: torch.Tensor,      # (B, T, D)
    b: torch.Tensor,      # (B, T, D)
    h0: torch.Tensor,     # (B, D)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (h (B, T, D) f32, h_T (B, D) f32).

    CPU tensors take the plain recurrence.  CUDA tensors launch the kernel,
    which takes contiguous float32 inputs; anything else raises.  Meta
    tensors give the outputs under the kernel's conditions, with no launch.
    """
    _check_shapes(a, b, h0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        return _Scan.apply(a, b, h0)
    return _forward(a, b, h0)


# kernel launches since the last reset; chip_smoke.py reads them around the
# main path to show that every RG-LRU layer went through the kernels
rglru_scan.launches = 0
rglru_scan_backward.launches = 0
