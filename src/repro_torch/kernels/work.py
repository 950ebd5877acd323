"""One call's work for each of the port's kernels, and the hooks through
which a wrapper reports it to a cost counter (``launch.cost.CostMode``).

Each work function gives the operations and the bytes of one call: every
input read once and every output written once, at 4 bytes an f32 element
where no size is given.  ``chip_smoke.py`` turns them into each kernel's
bound on the card; the dry-run counts them in a step's FLOPs and bytes.

A wrapper runs its call inside :func:`kernel_call`: the active counter adds
the call's work, and the tensor operations inside (the plain version where
it stands in for the kernel on the CPU, the outputs' allocation) are not
counted, though the storage they make is.  So a step counts the same
whatever implements a kernel: the CUDA kernel, the plain version or the
meta branch.  :func:`hidden` hides operations without adding work (the
wire's staging and copies, whose cost is the bytes on the link).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple

__all__ = ["Work", "wkv6", "wkv6_backward", "rglru", "rglru_backward", "whitedata_filter",
           "crdt_merge", "crdt_merge_rows", "crdt_join_rows", "kernel_call", "hidden",
           "COUNTERS"]


class Work(NamedTuple):
    flops: int
    nbytes: int


def wkv6(b: int, t: int, h: int, n: int) -> Work:
    """r/k/v/w, u and s0 read once, y and the final state written once; 5
    N^2 operations per step and head in the factored form y = r.S +
    (r.(u*k)) v, S <- diag(w) S + k v^T."""
    nbytes = 4 * (4 * b * t * h * n + h * n + b * h * n * n) + 4 * (b * t * h * n + b * h * n * n)
    return Work(5 * b * h * t * n * n, nbytes)


def wkv6_backward(b: int, t: int, h: int, n: int) -> Work:
    """r/k/v/w/dy, u, s0 and ds_fin read once; dr/dk/dv/dw, du and ds0
    written once; 14 N^2 operations per step and head (the state and dS
    recurrences, 3 each; the contractions into dr, dk, dv and dw, 2 each;
    the O(N) terms left out)."""
    return Work(14 * b * h * t * n * n, 4 * (9 * b * t * h * n + 2 * h * n + 3 * b * h * n * n))


def rglru(b: int, t: int, d: int) -> Work:
    """a, b and h0 read once, h and h_T written once; one FMA (2
    operations) per element and step."""
    return Work(2 * b * t * d, 4 * (2 * b * t * d + b * d) + 4 * (b * t * d + b * d))


def rglru_backward(b: int, t: int, d: int) -> Work:
    """a, h, dh, h0 and dh_last read once, da, db and dh0 written once; an
    add and two multiplies per element and step."""
    return Work(3 * b * t * d, 4 * (5 * b * t * d + 3 * b * d))


def whitedata_filter(n: int, g_size: int, r_size: int) -> Work:
    """n elements: g and r read once, send and new_r written once; one add
    and one compare per element."""
    return Work(2 * n, 2 * n * (g_size + r_size))


def crdt_merge(m: int, n: int, size: int) -> Work:
    """(m, n) payloads: the winner's row read once (the function needs no
    more), both version vectors read, the payload and out_ver written; one
    compare per row."""
    return Work(m, 2 * m * n * size + 3 * 4 * m)


def crdt_merge_rows(k: int, n: int, size: int, taken: int | None = None) -> Work:
    """k rows of n elements joined into a table in place: each row's index
    and two ranks read and out_rank written, and the payload of each row
    the batch takes read from the batch and written into the table (a row
    the table keeps moves none); one compare per row.  The wrapper counts
    every row taken, the most a call can move; a bound from a run's data
    passes the rows it took."""
    taken = k if taken is None else taken
    return Work(k, 2 * taken * n * size + (3 * 4 + 8) * k)


def crdt_join_rows(k: int, n: int, size: int, taken: int | None = None) -> Work:
    """k rows of n elements joined into a table's columns in place: each
    row's index, both (epoch, seq, node) triples, the batch's length and the
    table's presence byte read and ``took`` written (66 bytes); each row the
    batch takes also reads and writes its payload and writes its triple,
    length and presence (33 bytes more); one compare per row.  The wrapper
    counts every row taken; a bound from a run's data passes the rows it
    took."""
    taken = k if taken is None else taken
    return Work(k, 2 * taken * n * size + 66 * k + 33 * taken)


# the active cost counters, innermost last (``launch.cost.CostMode`` pushes
# itself while it is entered); each has ``add_kernel(work)`` and ``hide()``
COUNTERS: list = []


@contextlib.contextmanager
def kernel_call(work: Work) -> Iterator[None]:
    """One kernel call: the innermost active counter adds ``work`` and
    counts none of the operations inside."""
    if not COUNTERS:
        yield
        return
    counter = COUNTERS[-1]
    counter.add_kernel(work)
    with counter.hide():
        yield


@contextlib.contextmanager
def hidden() -> Iterator[None]:
    """Operations the innermost active counter does not count."""
    if not COUNTERS:
        yield
        return
    with COUNTERS[-1].hide():
        yield
