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
``crdt_join_rows_ref`` joins into a table's own columns (values, versions,
lengths, presence), comparing ``(epoch, seq, node)`` triples: the same
function with an absent row taking any version.
"""

from __future__ import annotations

import torch

__all__ = ["crdt_merge_ref", "crdt_merge_rows_ref", "crdt_join_rows_ref"]


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


def _lex_greater(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[i] > b[i]`` in the lexicographic order of ``(N, 3)`` rows."""
    e, s = a[:, 0] == b[:, 0], a[:, 1] == b[:, 1]
    return (a[:, 0] > b[:, 0]) | (e & (a[:, 1] > b[:, 1])) | (e & s & (a[:, 2] > b[:, 2]))


def crdt_join_rows_ref(
    table_val: torch.Tensor,       # (R, N), joined in place
    table_ver: torch.Tensor,       # (R, 3) int64 (epoch, seq, node), in place
    table_len: torch.Tensor,       # (R,) int64, in place
    table_present: torch.Tensor,   # (R,) bool, in place
    rows: torch.Tensor,            # (K,) int64, distinct
    new_val: torch.Tensor,         # (K, N)
    new_ver: torch.Tensor,         # (K, 3) int64
    new_len: torch.Tensor,         # (K,) int64
) -> torch.Tensor:
    took = ~table_present[rows] | _lex_greater(new_ver, table_ver[rows])
    table_val[rows] = torch.where(took[:, None], new_val, table_val[rows])
    table_ver[rows] = torch.where(took[:, None], new_ver, table_ver[rows])
    table_len[rows] = torch.where(took, new_len, table_len[rows])
    table_present[rows] = table_present[rows] | took
    return took
