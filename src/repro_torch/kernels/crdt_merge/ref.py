"""Plain PyTorch versioned CRDT merge (last-writer-wins lattice join).

Row-wise over two batches of slots:

    winner_i   = a if ver_a[i] >= ver_b[i] else b
    out_val[i] = winner_i's values
    out_ver[i] = max(ver_a[i], ver_b[i])

Ties keep side a.  The join is associative, commutative and idempotent
(ACI) wherever equal versions carry equal payloads, so duplicated or
reordered batches merge to the same state.  Counterpart of
``repro/kernels/crdt_merge/ref.py``.

``crdt_merge_rows_ref`` is the same join with side a a table's rows:
gathered, merged with the batch and scattered back, in place.
"""

from __future__ import annotations

import torch

__all__ = ["crdt_merge_ref", "crdt_merge_rows_ref"]


def crdt_merge_ref(
    val_a: torch.Tensor,   # (M, N)
    ver_a: torch.Tensor,   # (M,) int32
    val_b: torch.Tensor,
    ver_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    take_a = ver_a >= ver_b
    out_val = torch.where(take_a[:, None], val_a, val_b)
    out_ver = torch.maximum(ver_a, ver_b)
    return out_val, out_ver


def crdt_merge_rows_ref(
    table_val: torch.Tensor,   # (R, N), joined in place
    rows: torch.Tensor,        # (K,) int64, distinct
    cur_rank: torch.Tensor,    # (K,) int32, the table's rows' versions
    new_val: torch.Tensor,     # (K, N)
    new_rank: torch.Tensor,    # (K,) int32
) -> torch.Tensor:
    out_val, out_rank = crdt_merge_ref(table_val[rows], cur_rank, new_val, new_rank)
    table_val[rows] = out_val
    return out_rank
