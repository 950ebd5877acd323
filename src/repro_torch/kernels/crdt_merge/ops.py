"""The versioned CRDT merge of update batches: the hand-written CUDA kernel
on the card, the plain PyTorch version (``ref.py``) on the CPU.

Counterpart of ``repro/kernels/crdt_merge/ops.py``, without its
``use_kernel`` and ``interpret`` switches: the device of the tensors decides.
Tensors on the meta device take the kernel's checks and allocations with no
launch.  Every call reports its work (``kernels.work``) to the active cost
counter, whatever runs it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, work
from .ref import crdt_merge_ref

__all__ = ["crdt_merge", "crdt_merge_many", "crdt_merge_ref"]

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


@functools.cache
def _kernel():
    fn = _build.load("crdt_merge").crdt_merge_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = _build.load("crdt_merge").crdt_merge_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def crdt_merge(
    val_a: torch.Tensor,   # (M, N)
    ver_a: torch.Tensor,   # (M,) integer
    val_b: torch.Tensor,
    ver_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two versioned slot batches: (M, N) payloads + (M,) versions,
    cast to int32 as the reference casts them.  Returns (out_val (M, N),
    out_ver (M,) int32); ties keep side a.

    CPU tensors take the plain version.  CUDA tensors launch the kernel,
    which takes contiguous float32, bfloat16 or int32 payloads of one dtype;
    anything else raises.  Meta tensors give the outputs under the kernel's
    conditions, with no launch.
    """
    if val_a.dim() != 2 or val_b.shape != val_a.shape:
        raise ValueError(f"payloads must be (M, N) of one shape; got {tuple(val_a.shape)} "
                         f"and {tuple(val_b.shape)}")
    m, n = val_a.shape
    if ver_a.shape != (m,) or ver_b.shape != (m,):
        raise ValueError(f"versions must be ({m},); got {tuple(ver_a.shape)} and "
                         f"{tuple(ver_b.shape)}")
    if val_b.dtype != val_a.dtype:
        raise TypeError(f"payloads of two dtypes: {val_a.dtype} and {val_b.dtype}")
    ver_a, ver_b = ver_a.to(torch.int32), ver_b.to(torch.int32)
    args = (val_a, ver_a, val_b, ver_b)
    call_work = work.crdt_merge(m, n, val_a.element_size())
    if all(x.device.type == "cpu" for x in args):
        with work.kernel_call(call_work):
            return crdt_merge_ref(*args)
    if any(x.device != val_a.device for x in args) or val_a.device.type not in ("cuda", "meta"):
        raise ValueError(
            "crdt_merge takes all tensors on the CPU, on one CUDA device or on meta; got "
            + ", ".join(str(x.device) for x in args)
        )
    if val_a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the crdt_merge kernel takes float32, bfloat16 or int32 payloads; "
                        f"got {val_a.dtype}")
    if not all(x.is_contiguous() for x in args):
        raise ValueError("the crdt_merge kernel takes contiguous tensors only")

    with work.kernel_call(call_work):
        out_val = torch.empty_like(val_a)
        out_ver = torch.empty_like(ver_a)
    if m == 0 or val_a.device.type == "meta":
        return out_val, out_ver
    with torch.cuda.device(val_a.device):
        rc = _kernel()(
            val_a.data_ptr(), ver_a.data_ptr(), val_b.data_ptr(), ver_b.data_ptr(),
            out_val.data_ptr(), out_ver.data_ptr(), m, n, val_a.element_size(),
            torch.cuda.current_stream(val_a.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"crdt_merge kernel launch failed: {_error_string(rc)} ({rc})")
    crdt_merge.launches += 1
    return out_val, out_ver


def crdt_merge_many(batches) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold-merge a list of (values, versions) batches, first to last (ACI,
    so any order gives the same versions, and the same payloads wherever
    the top version of a row is unique)."""
    val, ver = batches[0]
    ver = ver.to(torch.int32)
    for vb, rb in batches[1:]:
        val, ver = crdt_merge(val, ver, vb, rb)
    return val, ver


# kernel launches since the last reset; chip_smoke.py reads it around the
# main path to show that every merge went through the kernel
crdt_merge.launches = 0
