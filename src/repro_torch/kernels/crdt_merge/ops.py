"""The versioned CRDT merge of update batches, and the same join straight
into a table's rows: by int32 ranks (``crdt_merge_rows``) or into the
table's own version, length and presence columns (``crdt_join_rows``, the
store's join).  The hand-written CUDA kernels on the card, the plain
PyTorch versions (``ref.py``) on the CPU.

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
from .ref import crdt_join_rows_ref, crdt_merge_ref, crdt_merge_rows_ref

__all__ = ["crdt_merge", "crdt_merge_many", "crdt_merge_ref", "crdt_merge_rows",
           "crdt_merge_rows_ref", "crdt_join_rows", "crdt_join_rows_ref"]

KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.int32)


@functools.cache
def _kernel():
    fn = _build.load("crdt_merge").crdt_merge_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _rows_kernel():
    fn = _build.load("crdt_merge").crdt_merge_rows_forward
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _join_kernel():
    fn = _build.load("crdt_merge").crdt_join_rows_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = _build.load("crdt_merge").crdt_merge_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def _check_kernel_args(name: str, args, dtype: torch.dtype) -> None:
    """Raise unless ``args`` lie on one CUDA device (or on meta) and the
    kernel takes their payload dtype and layout."""
    device = args[0].device
    if any(x.device != device for x in args) or device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} takes all tensors on the CPU, on one CUDA device or on meta; "
                         "got " + ", ".join(str(x.device) for x in args))
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the {name} kernel takes float32, bfloat16 or int32 payloads; "
                        f"got {dtype}")
    if not all(x.is_contiguous() for x in args):
        raise ValueError(f"the {name} kernel takes contiguous tensors only")


def _launch(name: str, kernel, device: torch.device, *args) -> None:
    """Launch ``kernel(*args, stream)`` on ``device``'s current stream; raise
    if the launch failed."""
    with torch.cuda.device(device):
        rc = kernel(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: {_error_string(rc)} ({rc})")


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
    _check_kernel_args("crdt_merge", args, val_a.dtype)

    with work.kernel_call(call_work):
        out_val = torch.empty_like(val_a)
        out_ver = torch.empty_like(ver_a)
    if m == 0 or val_a.device.type == "meta":
        return out_val, out_ver
    _launch("crdt_merge", _kernel(), val_a.device, val_a.data_ptr(), ver_a.data_ptr(),
            val_b.data_ptr(), ver_b.data_ptr(), out_val.data_ptr(), out_ver.data_ptr(), m, n,
            val_a.element_size())
    crdt_merge.launches += 1
    return out_val, out_ver


def crdt_merge_rows(
    table_val: torch.Tensor,   # (R, N), joined in place
    rows: torch.Tensor,        # (K,) int64
    cur_rank: torch.Tensor,    # (K,) integer: the versions of the table's rows
    new_val: torch.Tensor,     # (K, N)
    new_rank: torch.Tensor,    # (K,) integer
) -> torch.Tensor:
    """Join a batch into the table's rows in place: where ``new_rank[i] >
    cur_rank[i]``, ``new_val[i]`` becomes ``table_val[rows[i]]``; returns
    ``out_rank = max(cur_rank, new_rank)`` (K,) int32.  Ranks are cast to
    int32 as ``crdt_merge`` casts versions.  The result is, bit for bit,
    ``out_val, out_rank = crdt_merge(table_val[rows], cur_rank, new_val,
    new_rank); table_val[rows] = out_val``, and a row the table keeps is
    not written.

    Precondition, not checked: ``rows`` are distinct.  Each row must lie in
    ``[0, R)``: on the CPU an index outside raises, on the card the kernel
    traps.  CPU tensors take the plain version.  CUDA tensors launch the
    kernel, which takes contiguous float32, bfloat16 or int32 payloads of
    one dtype; anything else raises.  Meta tensors give ``out_rank`` and
    touch nothing.
    """
    if table_val.dim() != 2 or new_val.dim() != 2 or new_val.shape[1] != table_val.shape[1]:
        raise ValueError(f"table and batch must be (R, N) and (K, N); got "
                         f"{tuple(table_val.shape)} and {tuple(new_val.shape)}")
    (n_rows, n), k = table_val.shape, new_val.shape[0]
    if rows.shape != (k,) or cur_rank.shape != (k,) or new_rank.shape != (k,):
        raise ValueError(f"rows and ranks must be ({k},); got {tuple(rows.shape)}, "
                         f"{tuple(cur_rank.shape)} and {tuple(new_rank.shape)}")
    if rows.dtype != torch.int64:
        raise TypeError(f"rows must be int64; got {rows.dtype}")
    if new_val.dtype != table_val.dtype:
        raise TypeError(f"payloads of two dtypes: {table_val.dtype} and {new_val.dtype}")
    cur_rank, new_rank = cur_rank.to(torch.int32), new_rank.to(torch.int32)
    args = (table_val, rows, cur_rank, new_val, new_rank)
    call_work = work.crdt_merge_rows(k, n, table_val.element_size())
    if all(x.device.type == "cpu" for x in args):
        with work.kernel_call(call_work):
            lo, hi = (int(rows.min()), int(rows.max())) if k else (0, 0)
            if lo < 0 or hi >= n_rows:
                raise IndexError(f"rows must lie in [0, {n_rows}); got {lo} to {hi}")
            return crdt_merge_rows_ref(*args)
    _check_kernel_args("crdt_merge_rows", args, table_val.dtype)

    with work.kernel_call(call_work):
        out_rank = torch.empty_like(cur_rank)
    if k == 0 or table_val.device.type == "meta":
        return out_rank
    _launch("crdt_merge_rows", _rows_kernel(), table_val.device, table_val.data_ptr(), n_rows,
            rows.data_ptr(), cur_rank.data_ptr(), new_val.data_ptr(), new_rank.data_ptr(),
            out_rank.data_ptr(), k, n, table_val.element_size())
    crdt_merge_rows.launches += 1
    return out_rank


def crdt_join_rows(
    table_val: torch.Tensor,       # (R, N), joined in place
    table_ver: torch.Tensor,       # (R, 3) int64 (epoch, seq, node), in place
    table_len: torch.Tensor,       # (R,) int64, in place
    table_present: torch.Tensor,   # (R,) bool, in place
    rows: torch.Tensor,            # (K,) int64
    new_val: torch.Tensor,         # (K, N)
    new_ver: torch.Tensor,         # (K, 3) int64
    new_len: torch.Tensor,         # (K,) int64
) -> torch.Tensor:
    """Join a batch into a table's columns in place: row ``rows[i]`` takes
    the batch's value, version and length, and becomes present, where it is
    absent or ``new_ver[i]`` is above its version in the lexicographic
    order of ``(epoch, seq, node)`` (int64, any range); a tie keeps the
    table's row.  Returns ``took`` (K,) bool, the rows taken.  It is the
    reference store's ``apply`` of each row, and ``crdt_merge``'s function
    with side a the table's rows; a row the table keeps is not written.

    Precondition, not checked: ``rows`` are distinct.  Each row must lie in
    ``[0, R)``: on the CPU an index outside raises, on the card the kernel
    traps.  CPU tensors take the plain version.  CUDA tensors launch the
    kernel, which takes contiguous float32, bfloat16 or int32 payloads of
    one dtype and contiguous int64 versions, lengths and rows and bool
    presence; anything else raises.  Meta tensors give ``took`` and touch
    nothing.
    """
    if table_val.dim() != 2 or new_val.dim() != 2 or new_val.shape[1] != table_val.shape[1]:
        raise ValueError(f"table and batch must be (R, N) and (K, N); got "
                         f"{tuple(table_val.shape)} and {tuple(new_val.shape)}")
    (n_rows, n), k = table_val.shape, new_val.shape[0]
    shapes = {"table_ver": (table_ver, (n_rows, 3)), "table_len": (table_len, (n_rows,)),
              "table_present": (table_present, (n_rows,)), "rows": (rows, (k,)),
              "new_ver": (new_ver, (k, 3)), "new_len": (new_len, (k,))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(x.shape)}")
        want = torch.bool if name == "table_present" else torch.int64
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}; got {x.dtype}")
    if new_val.dtype != table_val.dtype:
        raise TypeError(f"payloads of two dtypes: {table_val.dtype} and {new_val.dtype}")
    args = (table_val, table_ver, table_len, table_present, rows, new_val, new_ver, new_len)
    call_work = work.crdt_join_rows(k, n, table_val.element_size())
    if all(x.device.type == "cpu" for x in args):
        with work.kernel_call(call_work):
            lo, hi = (int(rows.min()), int(rows.max())) if k else (0, 0)
            if lo < 0 or hi >= n_rows:
                raise IndexError(f"rows must lie in [0, {n_rows}); got {lo} to {hi}")
            return crdt_join_rows_ref(*args)
    _check_kernel_args("crdt_join_rows", args, table_val.dtype)

    with work.kernel_call(call_work):
        took = torch.empty(k, dtype=torch.bool, device=table_val.device)
    if k == 0 or table_val.device.type == "meta":
        return took
    _launch("crdt_join_rows", _join_kernel(), table_val.device, table_val.data_ptr(),
            table_ver.data_ptr(), table_len.data_ptr(), table_present.data_ptr(), n_rows,
            rows.data_ptr(), new_val.data_ptr(), new_ver.data_ptr(), new_len.data_ptr(),
            took.data_ptr(), k, n, table_val.element_size())
    crdt_join_rows.launches += 1
    return took


def crdt_merge_many(batches) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold-merge a list of (values, versions) batches, first to last (ACI,
    so any order gives the same versions, and the same payloads wherever
    the top version of a row is unique)."""
    val, ver = batches[0]
    ver = ver.to(torch.int32)
    for vb, rb in batches[1:]:
        val, ver = crdt_merge(val, ver, vb, rb)
    return val, ver


# kernel launches since the last reset; chip_smoke.py reads them around the
# main paths to show that every merge and every join went through a kernel
crdt_merge.launches = 0
crdt_merge_rows.launches = 0
crdt_join_rows.launches = 0
