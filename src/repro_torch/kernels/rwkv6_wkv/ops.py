"""Model-facing WKV6: the hand-written CUDA kernels on the card, the plain
PyTorch recurrence and its reverse sweep (``ref.py``) on the CPU.

Counterpart of ``repro/kernels/rwkv6_wkv/ops.py``.  The kernels read the
model's (B, T, H, N) layout directly, so no transposes are needed.

``wkv6`` is differentiable: where grad is on and an input requires it, it
runs as a ``torch.autograd.Function`` whose backward is ``wkv6_backward``
(the backward kernel on the card).  Otherwise, as under
``torch.inference_mode``, it saves nothing.

Tensors on the meta device (the dry-run, ``launch.dryrun``) take the
kernels' checks and allocations with no launch.  Every call reports its
work (``kernels.work``) to the active cost counter, whatever runs it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, work
from .ref import wkv6_backward_ref, wkv6_ref

__all__ = ["wkv6", "wkv6_backward", "wkv6_ref", "wkv6_backward_ref", "KERNEL_HEAD_DIMS"]

# head dims the kernels are instantiated for (smoke config 16, rwkv6-7b 64)
KERNEL_HEAD_DIMS = (16, 64)
# steps between the backward kernel's state checkpoints (kChunk in
# csrc/wkv6_backward.cu), which size its (B H, ceil(T / chunk), N, N) buffer
BACKWARD_CHUNK = 8


@functools.cache
def _kernel():
    fn = _build.load("wkv6").wkv6_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_kernel():
    lib = _build.load("wkv6_backward")
    lib.wkv6_backward_chunk.argtypes = []
    lib.wkv6_backward_chunk.restype = ctypes.c_int
    if lib.wkv6_backward_chunk() != BACKWARD_CHUNK:
        raise RuntimeError(f"the wkv6 backward kernel checkpoints every "
                           f"{lib.wkv6_backward_chunk()} steps, BACKWARD_CHUNK is {BACKWARD_CHUNK}")
    fn = lib.wkv6_backward
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _error_string(lib: str, code: int) -> str:
    fn = getattr(_build.load(lib), f"{lib}_error_string")
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def _check_shapes(r, k, v, w, u, state) -> None:
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


def _route(args) -> str:
    """``"cpu"`` when every tensor lies on the CPU; ``"cuda"`` when all lie
    on one CUDA device and the kernels take them, ``"meta"`` when all lie
    on the meta device and the kernels would take them; raises otherwise."""
    if all(x.device.type == "cpu" for x in args):
        return "cpu"
    dev = args[0].device
    if any(x.device != dev for x in args) or dev.type not in ("cuda", "meta"):
        raise ValueError(
            "wkv6 takes all tensors on the CPU, on one CUDA device or on meta; got "
            + ", ".join(str(x.device) for x in args)
        )
    if any(x.dtype != torch.float32 for x in args):
        raise TypeError("the wkv6 kernels take float32 tensors only")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("the wkv6 kernels take contiguous tensors only")
    if any(x.data_ptr() % 16 for x in args):
        raise ValueError("the wkv6 kernels take tensors that start on 16-byte boundaries")
    if args[0].shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the wkv6 kernels are built for head dims {KERNEL_HEAD_DIMS}, got {args[0].shape[-1]}"
        )
    return dev.type


def _forward(r, k, v, w, u, state) -> tuple[torch.Tensor, torch.Tensor]:
    args = (r, k, v, w, u, state)
    route = _route(args)
    with work.kernel_call(work.wkv6(*r.shape)):
        if route == "cpu":
            return wkv6_ref(*args)
        y = torch.empty_like(r)
        s_fin = torch.empty_like(state)
    if route == "meta":
        return y, s_fin
    b, t, h, n = r.shape
    with torch.cuda.device(r.device):
        rc = _kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
            b, t, h, n, torch.cuda.current_stream(r.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: {_error_string('wkv6', rc)} ({rc})")
    wkv6.launches += 1
    return y, s_fin


def wkv6_backward(r, k, v, w, u, state, dy, ds_fin) -> tuple[torch.Tensor, ...]:
    """Gradients (dr, dk, dv, dw, du, ds0) of ``wkv6(r, k, v, w, u, state)``
    given dy (B, T, H, N) and ds_fin (B, H, N, N); du is summed over batch
    and time.  CPU tensors take the plain reverse sweep; CUDA tensors launch
    the backward kernel, under the forward kernel's conditions; meta tensors
    take its checks and allocations with no launch."""
    _check_shapes(r, k, v, w, u, state)
    if dy.shape != r.shape or ds_fin.shape != state.shape:
        raise ValueError(
            f"dy {tuple(dy.shape)} / ds_fin {tuple(ds_fin.shape)} do not match y "
            f"{tuple(r.shape)} / the state {tuple(state.shape)}"
        )
    args = (r, k, v, w, u, state, dy, ds_fin)
    route = _route(args)
    b, t, h, n = r.shape
    with work.kernel_call(work.wkv6_backward(b, t, h, n)):
        if route == "cpu":
            return wkv6_backward_ref(*args)
        ckpt = torch.empty((b * h, -(-t // BACKWARD_CHUNK), n, n), dtype=torch.float32,
                           device=r.device)
        dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
        du_part = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
        ds0 = torch.empty_like(state)
        if route == "cuda":
            with torch.cuda.device(r.device):
                rc = _backward_kernel()(
                    *(x.data_ptr() for x in (*args, ckpt, dr, dk, dv, dw, du_part, ds0)),
                    b, t, h, n, torch.cuda.current_stream(r.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"wkv6 backward kernel launch failed: "
                                   f"{_error_string('wkv6_backward', rc)} ({rc})")
            wkv6_backward.launches += 1
        del ckpt
        return dr, dk, dv, dw, du_part.sum(0), ds0


def _dense(g: torch.Tensor) -> torch.Tensor:
    """An incoming gradient as the kernel takes it: f32, contiguous, on a
    16-byte boundary (autograd may hand over a broadcast or a view)."""
    g = g.float().contiguous()
    return g if g.data_ptr() % 16 == 0 else g.clone()


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return _forward(r, k, v, w, u, state)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, ds_fin):
        saved = ctx.saved_tensors
        r, state = saved[0], saved[5]
        # a None grad counts as zeros (training discards the final state)
        dy = torch.zeros_like(r) if dy is None else _dense(dy)
        ds_fin = torch.zeros_like(state) if ds_fin is None else _dense(ds_fin)
        grads = wkv6_backward(*saved, dy, ds_fin)
        return tuple(g.to(x.dtype) if need else None
                     for g, x, need in zip(grads, saved, ctx.needs_input_grad))


def wkv6(
    r: torch.Tensor,      # (B, T, H, N)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,      # decay in [0, 1)
    u: torch.Tensor,      # (H, N)
    state: torch.Tensor,  # (B, H, N, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, N) f32, final state (B, H, N, N) f32).

    CPU tensors take the plain recurrence.  CUDA tensors launch the kernel,
    which takes contiguous float32 inputs on 16-byte boundaries with head
    dim in ``KERNEL_HEAD_DIMS``; anything else raises.  Meta tensors give
    the outputs under the kernel's conditions, with no launch.
    """
    _check_shapes(r, k, v, w, u, state)
    args = (r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return _WKV6.apply(*args)
    return _forward(*args)


# kernel launches since the last reset; chip_smoke.py reads them around the
# main path to show that every layer went through the kernels
wkv6.launches = 0
wkv6_backward.launches = 0
