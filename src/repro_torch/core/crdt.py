"""Delta-CRDT replication state (paper Sec 4.4); the port's counterpart of
``repro.core.crdt``.

:class:`Version`, :class:`Update` and :func:`merge_updates` are the
reference's, host objects.  The replicated store is a device table,
:class:`CRDTTable`, in place of the reference's dict ``DeltaCRDTStore``:
per-key last-writer-wins registers under the total version order
``(epoch, seq, node)``, joined through ``kernels.crdt_merge.crdt_merge_rows``
(the CUDA kernel on the card).  The join is the lattice max by version, so
it is commutative, associative and idempotent (ACI) and a batch merges to
the same state whatever its order and multiplicity.

Key strings are interned to rows by formula: ``k{i}`` is row ``i``,
``h{r}:{h}`` (a region's hot set) is row ``n_keys + r * hot_set_size + h``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import ClassVar, Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.crdt_merge.ops import crdt_merge_rows

__all__ = ["Version", "Update", "merge_updates", "CRDTTable", "load_entries",
           "lexsort", "version_rank", "lex_greater"]


@dataclasses.dataclass(frozen=True, order=True)
class Version:
    epoch: int
    seq: int          # deterministic within-epoch order (e.g. commit timestamp)
    node: int         # tie-break: origin replica id

    ZERO: ClassVar["Version"]


Version.ZERO = Version(-1, -1, -1)


@dataclasses.dataclass(frozen=True)
class Update:
    """A delta: one versioned write to one key."""

    key: str
    value: bytes
    version: Version
    txn_id: int = -1

    @property
    def nbytes(self) -> int:
        # key + value payload + fixed version/txn metadata
        return len(self.key) + len(self.value) + 24

    def meta_only(self) -> "Update":
        """Payload-stripped wire form (key + version metadata, no value):
        the byte accounting of null-effect white data."""
        return dataclasses.replace(self, value=b"")


def merge_updates(updates: Iterable[Update]) -> dict[str, Update]:
    """Pure merge of a batch: per-key version-order maximum.

    ``merge_updates(perm_with_dups(U)) == merge_updates(U)`` for any
    permutation and multiplicity — the Sec 4.4 invariance equation.
    """
    out: dict[str, Update] = {}
    for u in updates:
        cur = out.get(u.key)
        if cur is None or u.version > cur.version:
            out[u.key] = u
    return out


# ---------------------------------------------------------------------------
# version order on tensors
# ---------------------------------------------------------------------------


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort`` on tensors: the permutation sorting by the last key,
    ties by the one before it, ..., and finally by position (stable sorts
    from the least significant key up)."""
    idx = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in keys:
        idx = idx[torch.sort(k[idx], stable=True).indices]
    return idx


def version_rank(ver: torch.Tensor) -> torch.Tensor:
    """Dense ranks (int64) of ``(N, 3)`` versions in ``(epoch, seq, node)``
    order: equal versions share a rank, a greater version has a greater
    rank."""
    n = ver.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=ver.device)
    order = lexsort([ver[:, 2], ver[:, 1], ver[:, 0]])
    s = ver[order]
    new = torch.ones(n, dtype=torch.int64, device=ver.device)
    new[0] = 0
    new[1:] = (s[1:] != s[:-1]).any(dim=1).to(torch.int64)
    rank = torch.empty(n, dtype=torch.int64, device=ver.device)
    rank[order] = torch.cumsum(new, 0)
    return rank


def lex_greater(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Version(*a[i]) > Version(*b[i])`` row by row, for ``(N, 3)``
    versions."""
    e, s = a[:, 0] == b[:, 0], a[:, 1] == b[:, 1]
    return (a[:, 0] > b[:, 0]) | (e & (a[:, 1] > b[:, 1])) | (e & s & (a[:, 2] > b[:, 2]))


def _ndigits(x: torch.Tensor) -> torch.Tensor:
    """Decimal digits of non-negative int64 values."""
    out = torch.ones_like(x)
    p = 10
    while p <= 10**18:
        out += (x >= p).to(x.dtype)
        p *= 10
    return out


# ---------------------------------------------------------------------------
# the device table
# ---------------------------------------------------------------------------

class CRDTTable:
    """The replicated store as rows of device tensors (identical on every
    replica, as the reference's store is).

    ``values`` holds each row's value as little-endian int32 words, zero
    padded to a whole word (the merge kernel takes int32 payloads), every
    value ``value_bytes`` long; ``versions`` the full ``(epoch, seq, node)``
    triple (int64), ``Version.ZERO`` on absent rows; ``present`` which rows
    hold a value.  ``merges`` counts the batches joined through the kernel
    wrapper.
    """

    def __init__(self, n_keys: int, value_bytes: int, *, n_regions: int = 0,
                 hot_set_size: int = 16, device: str | torch.device | None = None):
        if n_keys <= 0 or value_bytes <= 0:
            raise ValueError("n_keys and value_bytes must be positive")
        self.device = resolve_device(device)
        self.n_keys, self.value_bytes = int(n_keys), int(value_bytes)
        self.n_regions, self.hot_set_size = int(n_regions), int(hot_set_size)
        self.n_rows = self.n_keys + self.n_regions * self.hot_set_size
        self.words = -(-self.value_bytes // 4)
        self.values = torch.zeros(self.n_rows, self.words, dtype=torch.int32, device=self.device)
        self.versions = torch.full((self.n_rows, 3), -1, dtype=torch.int64, device=self.device)
        self.present = torch.zeros(self.n_rows, dtype=torch.bool, device=self.device)
        self.merges = 0

    # -- interning ---------------------------------------------------------

    def row_of(self, key: str) -> int:
        try:
            if key[0] == "k":
                i = int(key[1:])
                if 0 <= i < self.n_keys and key == f"k{i}":
                    return i
            elif key[0] == "h":
                r, h = (int(x) for x in key[1:].split(":"))
                if (0 <= r < self.n_regions and 0 <= h < self.hot_set_size
                        and key == f"h{r}:{h}"):
                    return self.n_keys + r * self.hot_set_size + h
        except (IndexError, ValueError):
            pass
        raise KeyError(f"{key!r} is no key of this table (k0..k{self.n_keys - 1}, "
                       f"h{{r}}:{{h}} for {self.n_regions} regions x {self.hot_set_size})")

    def key_of(self, row: int) -> str:
        if row < self.n_keys:
            return f"k{row}"
        r, h = divmod(row - self.n_keys, self.hot_set_size)
        return f"h{r}:{h}"

    def key_lengths(self, rows: torch.Tensor) -> torch.Tensor:
        """``len(key_of(row))`` for each row, as int64 on the rows' device."""
        rows = rows.to(torch.int64)
        hot = rows >= self.n_keys
        k = 1 + _ndigits(torch.where(hot, 0, rows))
        off = torch.where(hot, rows - self.n_keys, 0)
        r, h = off // self.hot_set_size, off % self.hot_set_size
        return torch.where(hot, 2 + _ndigits(r) + _ndigits(h), k)

    # -- values ------------------------------------------------------------

    def pack(self, values: Sequence[bytes]) -> torch.Tensor:
        """Values (each ``value_bytes`` long) as ``(N, words)`` int32 rows."""
        for v in values:
            if len(v) != self.value_bytes:
                raise ValueError(f"a value of {len(v)} bytes in a table of "
                                 f"{self.value_bytes}-byte values")
        width = 4 * self.words
        buf = b"".join(v.ljust(width, b"\0") for v in values)
        arr = np.frombuffer(buf, dtype="<i4").reshape(len(values), self.words)
        return torch.from_numpy(arr.astype(np.int32)).to(self.device)

    def unpack(self, words: torch.Tensor) -> list[bytes]:
        raw = words.cpu().numpy().astype("<i4").view(np.uint8).reshape(len(words), 4 * self.words)
        return [bytes(r[: self.value_bytes]) for r in raw]

    # -- reads -------------------------------------------------------------

    def get(self, keys: str | Sequence[str]):
        """The value of each key (``None`` where absent), gathered in one
        pass; a single key gives a single value."""
        one = isinstance(keys, str)
        rows = torch.tensor([self.row_of(k) for k in ([keys] if one else keys)],
                            dtype=torch.int64, device=self.device)
        vals, here = self.unpack(self.values[rows]), self.present[rows].tolist()
        out = [v if p else None for v, p in zip(vals, here)]
        return out[0] if one else out

    def version_of(self, keys: str | Sequence[str]):
        """The version of each key (``Version.ZERO`` where absent)."""
        one = isinstance(keys, str)
        rows = torch.tensor([self.row_of(k) for k in ([keys] if one else keys)],
                            dtype=torch.int64, device=self.device)
        out = [Version(*v) for v in self.versions[rows].tolist()]
        return out[0] if one else out

    def __len__(self) -> int:
        return int(self.present.sum())

    def full_state(self) -> dict[str, tuple[bytes, Version]]:
        """Every present key's value and version (the reference store's
        ``full_state()``)."""
        rows = torch.nonzero(self.present).flatten()
        vals, vers = self.unpack(self.values[rows]), self.versions[rows].tolist()
        return {self.key_of(r): (v, Version(*ver))
                for r, v, ver in zip(rows.tolist(), vals, vers)}

    def digest(self, *, values_only: bool = False) -> str:
        """SHA-256 over the present keys in string order, each key, value
        and (unless ``values_only``) ``"epoch:seq:node"``: the reference's
        digest bit for bit.  String order is not row order (``k10`` sorts
        before ``k9``), so the present rows come to the host and are
        sorted there."""
        rows = torch.nonzero(self.present).flatten()
        raw = self.values[rows].cpu().numpy().astype("<i4").view(np.uint8)
        raw = raw.reshape(len(rows), 4 * self.words)[:, : self.value_bytes]
        vers = self.versions[rows].tolist()
        keys = [self.key_of(r) for r in rows.tolist()]
        parts: list[bytes] = []
        for i in sorted(range(len(keys)), key=keys.__getitem__):
            parts.append(keys[i].encode())
            parts.append(raw[i].tobytes())
            if not values_only:
                parts.append("{}:{}:{}".format(*vers[i]).encode())
        return hashlib.sha256(b"".join(parts)).hexdigest()

    def snapshot(self) -> "CRDTTable":
        out = CRDTTable.__new__(CRDTTable)
        out.__dict__.update(self.__dict__)
        out.values, out.versions = self.values.clone(), self.versions.clone()
        out.present, out.merges = self.present.clone(), 0
        return out

    # -- the join ----------------------------------------------------------

    def merge_rows(self, rows: torch.Tensor, values: torch.Tensor,
                   versions: torch.Tensor) -> int:
        """Join a batch of versioned rows (``(N,)`` rows, ``(N, words)``
        int32 values, ``(N, 3)`` versions) into the table; returns how many
        rows changed.

        Each row is first reduced to its top version (the first of equal
        tops, as sequential applies keep it), so the rows are distinct; the
        batch is joined straight into the table's rows through
        ``crdt_merge_rows``, which writes only the rows it takes.  The
        kernel compares int32 versions: each side's
        ``(epoch, seq, node)`` becomes its dense rank among the ``2K``
        versions of this join, an order key exact for every pair it
        compares whatever the triples' range (``Version.ZERO`` ranks lowest;
        equal versions share a rank, and the kernel keeps the table's row on
        a tie, as the reference's ``apply`` does).  The full triple of the
        winner goes back into ``versions``.
        """
        if rows.numel() == 0:
            return 0
        rows = rows.to(torch.int64)
        order = lexsort([-version_rank(versions), rows])
        srt = rows[order]
        top = torch.ones_like(srt, dtype=torch.bool)
        top[1:] = srt[1:] != srt[:-1]
        pick = order[top]
        keys, new_val, new_ver = rows[pick], values[pick].contiguous(), versions[pick]
        k = keys.numel()
        cur_ver = self.versions[keys]
        rank = version_rank(torch.cat([cur_ver, new_ver])).to(torch.int32)
        cur_rank, new_rank = rank[:k].contiguous(), rank[k:].contiguous()
        out_rank = crdt_merge_rows(self.values, keys, cur_rank, new_val, new_rank)
        self.merges += 1
        took = out_rank != cur_rank
        self.versions[keys] = torch.where(took[:, None], new_ver, cur_ver)
        self.present[keys] = self.present[keys] | took
        return int(took.sum())

    def apply_many(self, updates: Iterable[Update]) -> int:
        """Join host :class:`Update`\\ s (the reference store's
        ``apply_many``); returns how many rows changed."""
        ups = list(updates)
        if not ups:
            return 0
        rows = torch.tensor([self.row_of(u.key) for u in ups], dtype=torch.int64,
                            device=self.device)
        vers = torch.tensor([(u.version.epoch, u.version.seq, u.version.node) for u in ups],
                            dtype=torch.int64, device=self.device)
        return self.merge_rows(rows, self.pack([u.value for u in ups]), vers)


def load_entries(table: CRDTTable,
                 entries: Iterable[tuple[str, bytes, tuple[int, int, int]]]) -> None:
    """Write ``(key, value, (epoch, seq, node))`` entries into ``table``
    as they are, no join: a store's state carried over from elsewhere (a
    reference store's ``full_state()``), so two stores can start from one
    state.  Keys must be distinct."""
    entries = list(entries)
    if not entries:
        return
    keys = [k for k, _, _ in entries]
    if len(set(keys)) != len(keys):
        raise ValueError("load_entries takes each key once")
    rows = torch.tensor([table.row_of(k) for k in keys], dtype=torch.int64, device=table.device)
    table.values[rows] = table.pack([v for _, v, _ in entries])
    table.versions[rows] = torch.tensor([tuple(ver) for _, _, ver in entries],
                                        dtype=torch.int64, device=table.device)
    table.present[rows] = True
