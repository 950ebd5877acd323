"""Epoch-based optimistic concurrency control (GeoGauss-style, paper Sec
4.3); the port's counterpart of ``repro.core.occ``.

Every replica executes its transactions against the epoch-start snapshot,
then the epoch is validated deterministically, the same at every replica:

* **write-write (first-writer-wins, no reinstatement)**: for each key
  written in the epoch the writer with the smallest ``(version, txn_id)``
  wins; a transaction aborts iff it loses any key it writes, whether or not
  the winner itself aborts (so an aggregator's abort decisions over a
  group's subset are a sound under-approximation of the global outcome);
* **reads**: a transaction aborts if the snapshot's version of a key it
  read is newer than the version it read.

:class:`Txn`, :func:`txn_updates` are the reference's host objects.  The
epoch travels as an :class:`EpochBatch`, a struct of arrays on the store's
device, and :func:`validate_epoch_detailed` is one tensor path modelled on
the reference's ``_validate_numpy``: a stable lexicographic sort of the
writes by ``(key, epoch, seq, node, txn_id)`` with the winner carried down
each key group, and the reads' snapshot versions gathered from the table and
compared lexicographically.  The reference picks its python or numpy path
by size; the two give equal results, so the port has this one.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .crdt import CRDTTable, Update, Version, lex_greater, lexsort

__all__ = ["Txn", "txn_updates", "EpochBatch", "ValidationResult",
           "validate_epoch_detailed"]


@dataclasses.dataclass(frozen=True)
class Txn:
    """One transaction executed optimistically at ``node`` during ``epoch``.

    ``seq`` is the node-local commit timestamp; the global deterministic order
    is by ``Version(epoch, seq, node)``.
    """

    txn_id: int
    node: int
    epoch: int
    seq: int
    read_set: tuple[tuple[str, Version], ...] = ()
    write_set: tuple[tuple[str, bytes], ...] = ()

    @property
    def version(self) -> Version:
        return Version(self.epoch, self.seq, self.node)

    def writes_keys(self) -> tuple[str, ...]:
        return tuple(k for k, _ in self.write_set)


def txn_updates(txn: Txn) -> list[Update]:
    """The delta updates a transaction would produce if committed."""
    return [
        Update(key=k, value=v, version=txn.version, txn_id=txn.txn_id)
        for k, v in txn.write_set
    ]


def _i64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


@dataclasses.dataclass
class EpochBatch:
    """Transactions as a struct of arrays on one device.

    Per transaction ``txn_id``, ``node``, ``epoch``, ``seq`` (``(T,)``
    int64); per read its transaction's position ``read_txn``, the key's
    table row ``read_row`` and the version read ``read_ver`` (``(R, 3)``);
    per write its transaction's position ``write_txn``, ``write_row``, the
    value ``write_val`` (``(W, words)`` int32, as the table holds values)
    the key's length ``write_klen`` and the value's ``write_len``
    (``Update.nbytes`` counts both).
    Reads and writes follow their transactions' order, each transaction's
    in its own order: the order of ``[u for t in txns for u in
    txn_updates(t)]``.
    """

    txn_id: torch.Tensor
    node: torch.Tensor
    epoch: torch.Tensor
    seq: torch.Tensor
    read_txn: torch.Tensor
    read_row: torch.Tensor
    read_ver: torch.Tensor
    write_txn: torch.Tensor
    write_row: torch.Tensor
    write_val: torch.Tensor
    write_klen: torch.Tensor
    write_len: torch.Tensor

    @property
    def n_txns(self) -> int:
        return self.txn_id.numel()

    @property
    def n_writes(self) -> int:
        return self.write_row.numel()

    def versions(self) -> torch.Tensor:
        """``(T, 3)`` transaction versions ``(epoch, seq, node)``."""
        return torch.stack([self.epoch, self.seq, self.node], dim=1)

    def write_nbytes(self) -> torch.Tensor:
        """``Update.nbytes`` of each write: key + value + 24."""
        return self.write_klen + self.write_len + 24

    def select(self, txns: torch.Tensor) -> "EpochBatch":
        """The transactions at positions ``txns``, in that order, with their
        reads and writes."""
        pos = torch.full((self.n_txns,), -1, dtype=torch.int64, device=self.txn_id.device)
        pos[txns] = torch.arange(txns.numel(), device=pos.device)

        def keep(owner: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            p = pos[owner]
            idx = torch.nonzero(p >= 0).flatten()
            idx = idx[torch.sort(p[idx], stable=True).indices]
            return idx, p[idx]

        r, r_txn = keep(self.read_txn)
        w, w_txn = keep(self.write_txn)
        return EpochBatch(
            self.txn_id[txns], self.node[txns], self.epoch[txns], self.seq[txns],
            r_txn, self.read_row[r], self.read_ver[r],
            w_txn, self.write_row[w], self.write_val[w], self.write_klen[w],
            self.write_len[w])

    def node_txns(self, nodes: Sequence[int]) -> torch.Tensor:
        """Positions of the transactions of ``nodes``, node by node in the
        order given, each node's in batch order."""
        parts = [torch.nonzero(self.node == i).flatten() for i in nodes]
        if not parts:
            return torch.zeros(0, dtype=torch.int64, device=self.node.device)
        return torch.cat(parts)

    # -- host forms (tests, the reference's API) ----------------------------

    @classmethod
    def from_txns(cls, txns: Sequence[Txn], table: CRDTTable | None = None,
                  device: str | torch.device | None = None) -> "EpochBatch":
        """The batch of host :class:`Txn`\\ s.  Keys go to ``table``'s rows
        and values into its words; without a table keys get first-seen ids
        and values are left out but for their lengths (enough for
        validation without a snapshot).  Every integer field is one copy to
        the device (views of one buffer), the values another."""
        dev = table.device if table is not None else torch.device(device or "cpu")
        ids: dict[str, int] = {}
        row = table.row_of if table is not None else (lambda k: ids.setdefault(k, len(ids)))
        reads = [(i, row(k), (v.epoch, v.seq, v.node))
                 for i, t in enumerate(txns) for k, v in t.read_set]
        writes = [(i, row(k), k, v) for i, t in enumerate(txns) for k, v in t.write_set]
        if table is not None:
            vals = table.pack([w[3] for w in writes]) if writes else \
                torch.zeros(0, table.words, dtype=torch.int32, device=dev)
        else:
            vals = torch.zeros(len(writes), 0, dtype=torch.int32, device=dev)
        cols = [[t.txn_id for t in txns], [t.node for t in txns], [t.epoch for t in txns],
                [t.seq for t in txns], [r[0] for r in reads], [r[1] for r in reads],
                [x for r in reads for x in r[2]], [w[0] for w in writes],
                [w[1] for w in writes], [len(w[2]) for w in writes], [len(w[3]) for w in writes]]
        flat = _i64([x for c in cols for x in c], dev)
        parts = list(torch.split(flat, [len(c) for c in cols]))
        parts[6] = parts[6].reshape(-1, 3)
        return cls(*parts[:9], vals, *parts[9:])

    def to_txns(self, table: CRDTTable) -> list[Txn]:
        """The host :class:`Txn`\\ s of the batch (keys and values through
        ``table``)."""
        reads: list[list] = [[] for _ in range(self.n_txns)]
        writes: list[list] = [[] for _ in range(self.n_txns)]
        for i, r, v in zip(self.read_txn.tolist(), self.read_row.tolist(),
                           self.read_ver.tolist()):
            reads[i].append((table.key_of(r), Version(*v)))
        for i, r, v in zip(self.write_txn.tolist(), self.write_row.tolist(),
                           table.unpack(self.write_val, self.write_len)):
            writes[i].append((table.key_of(r), v))
        return [Txn(tid, nd, ep, sq, tuple(rs), tuple(ws))
                for tid, nd, ep, sq, rs, ws in zip(self.txn_id.tolist(), self.node.tolist(),
                                                   self.epoch.tolist(), self.seq.tolist(),
                                                   reads, writes)]

    def updates(self, table: CRDTTable, mask: torch.Tensor | None = None) -> list[Update]:
        """The writes (those under ``mask``) as host :class:`Update`\\ s, in
        batch order."""
        idx = torch.arange(self.n_writes, device=self.write_row.device)
        if mask is not None:
            idx = idx[mask]
        t = self.write_txn[idx]
        vers = torch.stack([self.epoch[t], self.seq[t], self.node[t]], 1).tolist()
        return [Update(table.key_of(r), v, Version(*ver), tid)
                for r, v, ver, tid in zip(self.write_row[idx].tolist(),
                                          table.unpack(self.write_val[idx],
                                                       self.write_len[idx]), vers,
                                          self.txn_id[t].tolist())]


@dataclasses.dataclass(frozen=True)
class ValidationResult:
    """Abort breakdown of one epoch validation, as ``(T,)`` masks over the
    batch's transactions; the reference's id sets are the properties.

    ``read_mask`` (stale read versions) and ``ww_mask`` (lost a written key
    to an earlier writer) may overlap; a transaction commits iff neither
    holds.
    """

    txn_id: torch.Tensor
    read_mask: torch.Tensor
    ww_mask: torch.Tensor

    @property
    def committed_mask(self) -> torch.Tensor:
        return ~(self.read_mask | self.ww_mask)

    def _ids(self, mask: torch.Tensor) -> frozenset[int]:
        return frozenset(self.txn_id[mask].tolist())

    @property
    def read_aborted(self) -> frozenset[int]:
        return self._ids(self.read_mask)

    @property
    def ww_aborted(self) -> frozenset[int]:
        return self._ids(self.ww_mask)

    @property
    def aborted(self) -> frozenset[int]:
        return self.read_aborted | self.ww_aborted

    @property
    def committed(self) -> frozenset[int]:
        return frozenset(self.txn_id.tolist()) - self.aborted


def validate_epoch_detailed(batch: EpochBatch,
                            snapshot: CRDTTable | None = None) -> ValidationResult:
    """Deterministic epoch validation with a per-rule abort breakdown, the
    reference's ``validate_epoch_detailed`` on a batch.

    Works on any subset of the epoch's transactions (an aggregator's
    group).  Reads are checked against ``snapshot`` (skipped without one);
    the write-write winner map includes read-aborted writers and breaks
    version ties by ``txn_id``, so a forced ``(epoch, seq, node)``
    collision still yields exactly one winner per key.
    """
    dev = batch.txn_id.device
    read_mask = torch.zeros(batch.n_txns, dtype=torch.bool, device=dev)
    if snapshot is not None and batch.read_row.numel():
        stale = lex_greater(snapshot.versions[batch.read_row], batch.read_ver)
        read_mask[batch.read_txn[stale]] = True
    ww_mask = torch.zeros(batch.n_txns, dtype=torch.bool, device=dev)
    if batch.n_writes:
        t = batch.write_txn
        tid, ep, sq, nd = batch.txn_id[t], batch.epoch[t], batch.seq[t], batch.node[t]
        order = lexsort([tid, nd, sq, ep, batch.write_row])
        row = batch.write_row[order]
        start = torch.ones_like(row, dtype=torch.bool)
        start[1:] = row[1:] != row[:-1]
        n = row.numel()
        first = torch.where(start, torch.arange(n, device=dev), 0)
        win = order[torch.cummax(first, 0).values]
        lose = ((tid[order] != tid[win]) | (ep[order] != ep[win])
                | (sq[order] != sq[win]) | (nd[order] != nd[win]))
        ww_mask[t[order][lose]] = True
    return ValidationResult(batch.txn_id, read_mask, ww_mask)
