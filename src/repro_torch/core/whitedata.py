"""Task-preserved white-data filtering (paper Sec 4.3); the port's
counterpart of ``repro.core.whitedata``.

*White data* is what crosses the WAN and is then discarded without changing
the receiver's state: updates of aborted transactions, stale updates
(version already superseded), redundant content (the same ``(key, value)``
sent again) and null-effect updates (the value the receiver already holds).
The aggregator drops it before the WAN, from its epoch-start snapshot and
the group's own metadata.  The filter is task-preserving: merging the kept
batch gives the same value state as merging the raw one.

This is the replication engine's filter over a group's transaction batch,
as tensor passes on the store's device.  It is not the gradient threshold
kernel ``kernels/whitedata_filter``, which stays off this path.
"""

from __future__ import annotations

import dataclasses

import torch

from . import strategies as _strategies
from .crdt import CRDTTable, lex_greater, version_rank
from .occ import EpochBatch, validate_epoch_detailed

__all__ = ["FilterStats", "FilterResult", "filter_group_batch", "no_filter", "white_ratio"]


@dataclasses.dataclass
class FilterStats:
    total_updates: int = 0
    total_bytes: int = 0
    kept_updates: int = 0
    kept_bytes: int = 0
    aborted_updates: int = 0
    aborted_bytes: int = 0
    duplicate_updates: int = 0
    duplicate_bytes: int = 0
    stale_updates: int = 0
    stale_bytes: int = 0
    null_updates: int = 0
    null_bytes: int = 0

    def merge(self, other: "FilterStats") -> "FilterStats":
        out = FilterStats()
        for f in dataclasses.fields(FilterStats):
            setattr(out, f.name, getattr(self, f.name) + getattr(other, f.name))
        return out

    @property
    def white_bytes(self) -> int:
        return self.total_bytes - self.kept_bytes

    @property
    def white_byte_ratio(self) -> float:
        return self.white_bytes / self.total_bytes if self.total_bytes else 0.0

    @property
    def white_update_ratio(self) -> float:
        if not self.total_updates:
            return 0.0
        return 1.0 - self.kept_updates / self.total_updates

    @property
    def wire_bytes(self) -> int:
        """Bytes crossing the WAN: surviving payloads plus a validation
        tombstone (key + version metadata, ~24 B) for every dropped update:
        a dropped transaction's write-set footprint must still reach global
        validation, or a transaction that lost a key to it could be
        reinstated."""
        dropped = self.total_updates - self.kept_updates
        return self.kept_bytes + 24 * dropped


@dataclasses.dataclass
class FilterResult:
    """``kept``: ``(W,)`` mask over the batch's writes (the reference's
    ``kept`` list, in batch order); ``null``: the kept writes whose payload
    is stripped on the wire; ``aborted``: ``(T,)`` mask over the batch's
    transactions (the reference's ``aborted_txns`` by position)."""

    kept: torch.Tensor
    null: torch.Tensor
    aborted: torch.Tensor
    stats: FilterStats


def filter_group_batch(
    batch: EpochBatch,
    snapshot: CRDTTable,
    *,
    enable_abort: bool = True,
    enable_dedup: bool = True,
    enable_stale: bool = True,
    enable_null: bool = True,
) -> FilterResult:
    """Aggregator-side filtering of one group's epoch batch against its
    epoch-start ``snapshot``, the reference's rules in its order:

    1. *abort*: the group's transactions validated among themselves; every
       update of an aborted transaction is white;
    2. *stale*: version not newer than the snapshot's;
    3. *dedup*: an update is a duplicate when an earlier update of the
       batch with the same ``(key, value)`` that passed rules 1-2 has a
       version not greater than its own: a running minimum of versions per
       ``(key, value)`` group in update order (a later update can carry a
       smaller version, from another node);
    4. *null*: the value equals the snapshot's; kept, but only its
       key + version metadata crosses the WAN.

    Two values are equal when their lengths and their bytes are: the words
    of a value shorter than the table's width are zero padded.
    """
    dev = batch.write_row.device
    w = batch.n_writes
    nbytes = batch.write_nbytes()
    meta = batch.write_klen + 24
    aborted = torch.zeros(batch.n_txns, dtype=torch.bool, device=dev)
    if enable_abort:
        v = validate_epoch_detailed(batch, snapshot)
        aborted = v.read_mask | v.ww_mask
    wtid = batch.txn_id[batch.write_txn]
    is_ab = torch.isin(wtid, batch.txn_id[aborted])
    alive = ~is_ab
    wver = batch.versions()[batch.write_txn]
    stale = torch.zeros(w, dtype=torch.bool, device=dev)
    if enable_stale:
        stale = alive & ~lex_greater(wver, snapshot.versions[batch.write_row])
        alive &= ~stale
    dup = torch.zeros(w, dtype=torch.bool, device=dev)
    if enable_dedup and bool(alive.any()):
        idx = torch.nonzero(alive).flatten()
        # a short value is zero padded, so its length is part of its content
        content = torch.cat([batch.write_row[idx, None], batch.write_len[idx, None],
                             batch.write_val[idx].to(torch.int64)], 1)
        gid = torch.unique(content, dim=0, return_inverse=True)[1]
        rank = version_rank(wver[idx])
        o = torch.sort(gid, stable=True).indices
        g, r = gid[o], rank[o]
        # a running minimum of ranks within each group, as a running maximum
        # of g * (top + 1) + (top - rank): groups are sorted, so each one's
        # values exceed every earlier group's and the maximum restarts there
        top = int(r.max()) if r.numel() else 0
        run_min = top - (torch.cummax(g * (top + 1) + (top - r), 0).values - g * (top + 1))
        d = torch.zeros_like(g, dtype=torch.bool)
        d[1:] = (g[1:] == g[:-1]) & (run_min[:-1] <= r[1:])
        dup[idx[o]] = d
        alive &= ~dup
    null = torch.zeros(w, dtype=torch.bool, device=dev)
    if enable_null:
        row = batch.write_row
        same = (snapshot.present[row] & (snapshot.lengths[row] == batch.write_len)
                & (snapshot.values[row] == batch.write_val).all(dim=1))
        null = alive & same
    full = alive & ~null
    counts = torch.stack([
        torch.tensor(w, device=dev), nbytes.sum(),
        alive.sum(), nbytes[full].sum() + meta[null].sum(),
        is_ab.sum(), nbytes[is_ab].sum(),
        dup.sum(), nbytes[dup].sum(),
        stale.sum(), nbytes[stale].sum(),
        null.sum(), (nbytes - meta)[null].sum(),
    ]).tolist()
    return FilterResult(alive, null, aborted, FilterStats(*counts))


def no_filter(batch: EpochBatch, snapshot: CRDTTable) -> FilterResult:
    """Baseline passthrough: every update is kept and paid on the wire
    (``wire_bytes`` then equals the raw batch bytes)."""
    dev = batch.write_row.device
    w = batch.n_writes
    total = int(batch.write_nbytes().sum()) if w else 0
    return FilterResult(
        torch.ones(w, dtype=torch.bool, device=dev), torch.zeros(w, dtype=torch.bool, device=dev),
        torch.zeros(batch.n_txns, dtype=torch.bool, device=dev),
        FilterStats(total_updates=w, total_bytes=total, kept_updates=w, kept_bytes=total))


def white_ratio(stats: FilterStats) -> float:
    return stats.white_byte_ratio


# registry wiring: aggregator-side filters by name (the device plane's
# `geococo` top-k exchange is the gradient analogue)
_strategies.register("filter", "whitedata", filter_group_batch)
_strategies.register("filter", "none", no_filter)
