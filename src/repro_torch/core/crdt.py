"""Delta-CRDT replication state (paper Sec 4.4); the port's counterpart of
``repro.core.crdt``.

:class:`Version`, :class:`Update` and :func:`merge_updates` are the
reference's, host objects.  The replicated store is a device table,
:class:`CRDTTable`, in place of the reference's dict ``DeltaCRDTStore``:
per-key last-writer-wins registers under the total version order
``(epoch, seq, node)``, joined through ``kernels.crdt_merge.crdt_merge_rows``
(the CUDA kernel on the card).  The join is the lattice max by version, so
it is commutative, associative and idempotent (ACI) and a batch merges to
the same state whatever its order and multiplicity.  A node's snapshot
view (the streaming engine's ``staleness_feedback``) is a table of its own,
a :meth:`CRDTTable.snapshot` of the store, advanced by joining whole
committed epochs held on the device as distinct rows
(:meth:`CRDTTable.top_rows`) through :meth:`CRDTTable.join_rows`.

Key strings are interned to rows by formula, three families one after
another: ``k{i}`` is row ``i``; ``h{r}:{h}`` (a region's hot set) is row
``n_keys + r * hot_set_size + h``; ``w{w}:i{i}`` (a TPC-C warehouse's
item) is row ``w_base + w * items_per_warehouse + i``, with ``w_base`` the
rows of the first two.  The digest renders every present row's key on the
device and sorts the keys there in the reference's string order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
from typing import ClassVar, Iterable, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.crdt_merge.ops import crdt_merge_rows

__all__ = ["Version", "Update", "merge_updates", "CRDTTable", "load_entries", "load_rows",
           "seeded_words", "LOAD_VERSION", "lexsort", "version_rank", "lex_greater"]

# bytes of a digest's stream built on the device at a time
DIGEST_CHUNK_BYTES = 1 << 27


@dataclasses.dataclass(frozen=True, order=True)
class Version:
    epoch: int
    seq: int          # deterministic within-epoch order (e.g. commit timestamp)
    node: int         # tie-break: origin replica id

    ZERO: ClassVar["Version"]


Version.ZERO = Version(-1, -1, -1)
# the version of a row loaded before epoch 0: above ZERO, below every
# version an epoch's transactions carry (epochs count from 0)
LOAD_VERSION = (-1, 0, 0)


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


def _digits_of(n: int) -> int:
    return len(str(abs(int(n))))


# ---------------------------------------------------------------------------
# seeded data
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _i64(c: int) -> int:
    """A 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64's finalizer on int64 bits (products wrap mod 2**64, on the
    CPU and on the card alike)."""
    x = x + _i64(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def seeded_words(seed: int, rows: torch.Tensor, n_words: int) -> torch.Tensor:
    """``(N, n_words)`` int32 words made from ``seed`` and each row's index
    alone, the same on every device: word ``j`` of row ``r`` is half of
    SplitMix64 of ``(seed, r, j // 2)``."""
    rows = rows.to(torch.int64)
    halves = -(-n_words // 2)
    j = torch.arange(halves, dtype=torch.int64, device=rows.device)
    x = _mix64(_mix64(rows[:, None] * halves + j + _i64((seed * 0x2545F4914F6CDD1D) & _M64)))
    return x.contiguous().view(torch.int32)[:, :n_words]


# ---------------------------------------------------------------------------
# key bytes on the device
# ---------------------------------------------------------------------------


class _Render:
    """Bytes of N strings built field by field in a ``(N, width)`` uint8
    buffer: each row writes at its own column, and a row outside a field's
    mask writes into a spare last column that is cut off at the end."""

    def __init__(self, n: int, width: int, device: torch.device):
        self.buf = torch.zeros(n, width + 1, dtype=torch.uint8, device=device)
        self.width = width
        self.pow10 = torch.tensor([10**i for i in range(19)], dtype=torch.int64, device=device)

    def _col(self, col: torch.Tensor, where: torch.Tensor | None) -> torch.Tensor:
        return col if where is None else torch.where(where, col, self.width)

    def char(self, off: torch.Tensor, text: str, where: torch.Tensor | None = None,
             ) -> torch.Tensor:
        for t, ch in enumerate(text.encode()):
            self.buf.scatter_(1, self._col(off + t, where)[:, None], ch)
        return off + len(text)

    def number(self, off: torch.Tensor, x: torch.Tensor, max_digits: int,
               where: torch.Tensor | None = None, signed: bool = False) -> torch.Tensor:
        """Write ``str(x)`` at ``off``; returns the column after it."""
        if signed:
            neg = x < 0
            self.char(off, "-", neg if where is None else neg & where)
            off, x = off + neg.to(off.dtype), x.abs()
        nd = _ndigits(x)
        for j in range(max_digits):
            p = self.pow10[(nd - 1 - j).clamp(min=0)]
            digit = ((x // p) % 10 + 48).to(torch.uint8)
            ok = nd > j if where is None else (nd > j) & where
            self.buf.scatter_(1, torch.where(ok, off + j, self.width)[:, None], digit[:, None])
        return off + nd

    def bytes(self) -> torch.Tensor:
        return self.buf[:, : self.width]


def _sort_words(raw: torch.Tensor) -> list[torch.Tensor]:
    """Zero-padded ``(N, L)`` bytes as ``ceil(L / 7)`` int64 words, 7 bytes
    each, the first byte most significant: comparing the words in order is
    comparing the bytes, and a zero pad sorts a prefix first."""
    n, width = raw.shape
    pad = -width % 7
    if pad:
        raw = torch.cat([raw, raw.new_zeros(n, pad)], 1)
    b = raw.view(n, -1, 7).to(torch.int64)
    shift = torch.arange(48, -1, -8, dtype=torch.int64, device=raw.device)
    return list((b << shift).sum(2).unbind(1))


def _compact(rec: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``rec[mask]`` (row-major), through numpy on the CPU, where it is some
    ten times faster than torch's boolean index."""
    if rec.device.type == "cpu":
        return torch.from_numpy(rec.numpy()[mask.numpy()])
    return rec[mask]


class _Hasher:
    """SHA-256 of a stream fed in pieces from another thread: pieces on the
    card are copied to pinned host buffers (a ring of ``depth``) and hashed
    as each copy completes, while the next piece is built; hashlib releases
    the GIL on large buffers."""

    def __init__(self, device: torch.device, capacity: int, depth: int = 3):
        self.h = hashlib.sha256()
        self.cuda = device.type == "cuda"
        self.todo: queue.Queue = queue.Queue(maxsize=depth)
        self.free: queue.Queue = queue.Queue()
        if self.cuda:
            for _ in range(depth):
                self.free.put(torch.empty(capacity, dtype=torch.uint8, pin_memory=True))
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while (item := self.todo.get()) is not None:
            buf, n, done = item
            try:
                if self.error is None:
                    if done is not None:
                        done.synchronize()
                    self.h.update(buf.numpy()[:n])
            except BaseException as e:  # re-raised by the producer
                self.error = e
            if self.cuda:
                self.free.put(buf)

    def feed(self, piece: torch.Tensor) -> None:
        if self.error is not None:
            raise self.error
        n = piece.numel()
        if not self.cuda:
            self.todo.put((piece, n, None))
            return
        buf = self.free.get()
        buf[:n].copy_(piece, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(piece.device))
        self.todo.put((buf, n, done))

    def hexdigest(self) -> str:
        self.todo.put(None)
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.h.hexdigest()


# ---------------------------------------------------------------------------
# the device table
# ---------------------------------------------------------------------------

class CRDTTable:
    """The replicated store as rows of device tensors (identical on every
    replica, as the reference's store is).

    ``values`` holds each row's value as little-endian int32 words, zero
    padded to a whole word (the merge kernel takes int32 payloads), values
    of up to ``value_bytes``; ``lengths`` each row's value length (int64,
    0 on absent rows); ``versions`` the full ``(epoch, seq, node)`` triple
    (int64), ``Version.ZERO`` on absent rows; ``present`` which rows hold a
    value.  ``merges`` counts the batches joined through the kernel
    wrapper; ``digest_bytes`` the bytes of each stream that the last
    digest hashed.
    """

    def __init__(self, n_keys: int, value_bytes: int, *, n_regions: int = 0,
                 hot_set_size: int = 16, n_warehouses: int = 0, items_per_warehouse: int = 0,
                 device: str | torch.device | None = None):
        if min(n_keys, n_regions, hot_set_size, n_warehouses, items_per_warehouse) < 0:
            raise ValueError("a table's key counts must not be negative")
        if value_bytes <= 0:
            raise ValueError("value_bytes must be positive")
        self.device = resolve_device(device)
        self.n_keys, self.value_bytes = int(n_keys), int(value_bytes)
        self.n_regions, self.hot_set_size = int(n_regions), int(hot_set_size)
        self.n_warehouses, self.items_per_warehouse = int(n_warehouses), int(items_per_warehouse)
        self.w_base = self.n_keys + self.n_regions * self.hot_set_size
        self.n_rows = self.w_base + self.n_warehouses * self.items_per_warehouse
        if self.n_rows <= 0:
            raise ValueError("a table needs at least one key")
        self.words = -(-self.value_bytes // 4)
        self.values = torch.zeros(self.n_rows, self.words, dtype=torch.int32, device=self.device)
        self.lengths = torch.zeros(self.n_rows, dtype=torch.int64, device=self.device)
        self.versions = torch.full((self.n_rows, 3), -1, dtype=torch.int64, device=self.device)
        self.present = torch.zeros(self.n_rows, dtype=torch.bool, device=self.device)
        self.merges, self.digest_bytes = 0, ()

    def layout(self) -> dict:
        """The constructor's arguments but the device."""
        return dict(n_keys=self.n_keys, value_bytes=self.value_bytes, n_regions=self.n_regions,
                    hot_set_size=self.hot_set_size, n_warehouses=self.n_warehouses,
                    items_per_warehouse=self.items_per_warehouse)

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
            elif key[0] == "w":
                w, item = key[1:].split(":")
                w, i = int(w), int(item[1:])
                if (0 <= w < self.n_warehouses and 0 <= i < self.items_per_warehouse
                        and key == f"w{w}:i{i}"):
                    return self.w_base + w * self.items_per_warehouse + i
        except (IndexError, ValueError):
            pass
        raise KeyError(f"{key!r} is no key of this table (k0..k{self.n_keys - 1}, "
                       f"h{{r}}:{{h}} for {self.n_regions} regions x {self.hot_set_size}, "
                       f"w{{w}}:i{{i}} for {self.n_warehouses} warehouses x "
                       f"{self.items_per_warehouse} items)")

    def key_of(self, row: int) -> str:
        if row < self.n_keys:
            return f"k{row}"
        if row < self.w_base:
            r, h = divmod(row - self.n_keys, self.hot_set_size)
            return f"h{r}:{h}"
        w, i = divmod(row - self.w_base, self.items_per_warehouse)
        return f"w{w}:i{i}"

    def _families(self, rows: torch.Tensor):
        """Per row its family masks and numbers: ``k`` (i), ``h`` (r, h),
        ``w`` (w, i)."""
        hot = (rows >= self.n_keys) & (rows < self.w_base)
        wh = rows >= self.w_base
        off_h = torch.where(hot, rows - self.n_keys, 0)
        off_w = torch.where(wh, rows - self.w_base, 0)
        hs, items = max(self.hot_set_size, 1), max(self.items_per_warehouse, 1)
        return (~(hot | wh), torch.where(hot | wh, 0, rows), hot, off_h // hs, off_h % hs,
                wh, off_w // items, off_w % items)

    def key_lengths(self, rows: torch.Tensor) -> torch.Tensor:
        """``len(key_of(row))`` for each row, as int64 on the rows' device."""
        rows = rows.to(torch.int64)
        _, i, hot, r, h, wh, w, item = self._families(rows)
        return torch.where(hot, 2 + _ndigits(r) + _ndigits(h),
                           torch.where(wh, 3 + _ndigits(w) + _ndigits(item), 1 + _ndigits(i)))

    def key_bytes(self, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Each row's key as zero-padded ASCII bytes, rendered on the rows'
        device: ``(N, L)`` uint8 for the table's longest key, and the
        lengths."""
        rows = rows.to(torch.int64)
        is_k, i, hot, r, h, wh, w, item = self._families(rows)
        nk, nr, nw = self.n_keys, self.n_regions, self.n_warehouses
        dk = _digits_of(max(nk - 1, 0))
        dr, dh = _digits_of(max(nr - 1, 0)), _digits_of(self.hot_set_size - 1)
        dw, di = _digits_of(max(nw - 1, 0)), _digits_of(max(self.items_per_warehouse - 1, 0))
        width = max(1 + dk if nk else 0, 2 + dr + dh if nr else 0, 3 + dw + di if nw else 0)
        out = _Render(rows.numel(), width, rows.device)
        zero = torch.zeros_like(rows)
        if nk:
            out.number(out.char(zero, "k", is_k), i, dk, is_k)
        if nr and self.hot_set_size:
            o = out.number(out.char(zero, "h", hot), r, dr, hot)
            out.number(out.char(o, ":", hot), h, dh, hot)
        if nw and self.items_per_warehouse:
            o = out.number(out.char(zero, "w", wh), w, dw, wh)
            out.number(out.char(o, ":i", wh), item, di, wh)
        return out.bytes(), self.key_lengths(rows)

    def record_bytes(self, rows: torch.Tensor, values: torch.Tensor, lengths: torch.Tensor,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """``b"".join(key + value)`` of records in their order, built on the
        rows' device as one flat uint8 tensor (each key from
        :meth:`key_bytes`, each value its ``(words,)`` int32 row's bytes cut
        to its length), and each record's length in it."""
        keyb, klen = self.key_bytes(rows)
        vals = values.reshape(-1).view(torch.uint8).reshape(rows.numel(), 4 * self.words)
        rec = torch.cat([keyb, vals], 1)
        cols = torch.arange(rec.shape[1], device=rec.device)
        kw = keyb.shape[1]
        lengths = lengths.to(torch.int64)
        mask = torch.where(cols < kw, cols < klen[:, None], cols - kw < lengths[:, None])
        return _compact(rec, mask), klen + lengths

    # -- values ------------------------------------------------------------

    def pack(self, values: Sequence[bytes]) -> torch.Tensor:
        """Values (each up to ``value_bytes`` long) as ``(N, words)`` int32
        rows, zero padded."""
        for v in values:
            if len(v) > self.value_bytes:
                raise ValueError(f"a value of {len(v)} bytes in a table of values up to "
                                 f"{self.value_bytes} bytes")
        width = 4 * self.words
        buf = b"".join(v.ljust(width, b"\0") for v in values)
        arr = np.frombuffer(buf, dtype="<i4").reshape(len(values), self.words)
        return torch.from_numpy(arr.astype(np.int32)).to(self.device)

    def unpack(self, words: torch.Tensor, lengths: torch.Tensor | Sequence[int] | None = None,
               ) -> list[bytes]:
        """``(N, words)`` int32 rows as bytes, each cut to its length
        (``value_bytes`` where no lengths are given)."""
        raw = words.cpu().numpy().astype("<i4").view(np.uint8).reshape(len(words), 4 * self.words)
        if lengths is None:
            return [bytes(r[: self.value_bytes]) for r in raw]
        if isinstance(lengths, torch.Tensor):
            lengths = lengths.tolist()
        return [bytes(r[:n]) for r, n in zip(raw, lengths)]

    # -- reads -------------------------------------------------------------

    def get(self, keys: str | Sequence[str]):
        """The value of each key (``None`` where absent), gathered in one
        pass; a single key gives a single value."""
        one = isinstance(keys, str)
        rows = torch.tensor([self.row_of(k) for k in ([keys] if one else keys)],
                            dtype=torch.int64, device=self.device)
        vals = self.unpack(self.values[rows], self.lengths[rows])
        out = [v if p else None for v, p in zip(vals, self.present[rows].tolist())]
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
        vals = self.unpack(self.values[rows], self.lengths[rows])
        vers = self.versions[rows].tolist()
        return {self.key_of(r): (v, Version(*ver))
                for r, v, ver in zip(rows.tolist(), vals, vers)}

    # -- digests -----------------------------------------------------------

    def digest(self, *, values_only: bool = False) -> str:
        """SHA-256 over the present keys in string order, each key, value
        and (unless ``values_only``) ``"epoch:seq:node"``: the reference's
        digest bit for bit (see :meth:`digests`)."""
        return self._digests((values_only,))[0]

    def digests(self) -> tuple[str, str]:
        """The state and the value digest in one pass: one gather of the
        rows feeds both streams, each hashed in its own thread."""
        return tuple(self._digests((False, True)))

    def _digests(self, values_only: tuple[bool, ...]) -> list[str]:
        """The digest of each stream asked for; ``digest_bytes`` keeps the
        bytes of each stream hashed, in the same order.  String order is not row
        order (``k10`` sorts before ``k9``, ``w10:i2`` before ``w1:i5``), so
        each present row's key is rendered on the device, packed 7 bytes to
        an int64 word and lexsorted.  Each entry's bytes (key, value, version
        string) sit in fixed columns of a record; a mask of each entry's
        lengths selects them in row-major order, which is the stream.
        Blocks of whole entries of up to ``DIGEST_CHUNK_BYTES`` (one entry
        at least) are built on the device, copied to the host in pieces of
        up to ``DIGEST_CHUNK_BYTES`` and hashed there while the next block
        is built."""
        dev, chunk_bytes = self.device, DIGEST_CHUNK_BYTES
        rows = torch.nonzero(self.present).flatten()
        if rows.numel() == 0:
            self.digest_bytes = tuple(0 for _ in values_only)
            return [hashlib.sha256().hexdigest() for _ in values_only]
        keyb, klen = self.key_bytes(rows)
        order = lexsort(_sort_words(keyb)[::-1])
        rows, keyb, klen = rows[order], keyb[order], klen[order]
        vlen = self.lengths[rows]
        need_ver = not all(values_only)
        if need_ver:
            ver = self.versions[rows]
            most = ver.abs().amax(0).tolist()
            width = 5 + sum(_digits_of(m) for m in most)
            out = _Render(rows.numel(), width, dev)
            o = torch.zeros_like(vlen)
            for f in range(3):
                o = out.number(o, ver[:, f], _digits_of(most[f]), signed=True)
                if f < 2:
                    o = out.char(o, ":")
            verb, vslen = out.bytes(), o
        else:
            verb, vslen = keyb.new_zeros(rows.numel(), 0), torch.zeros_like(vlen)
        size = klen + vlen + (vslen if need_ver else 0)
        ends = torch.cumsum(size, 0).cpu().numpy()
        kv_bytes = int((klen + vlen).sum())
        self.digest_bytes = tuple(kv_bytes if vo else int(ends[-1]) for vo in values_only)
        piece = max(1, int(chunk_bytes))
        hashers = [_Hasher(dev, min(piece, int(ends[-1]))) for _ in values_only]
        cols_k = torch.arange(keyb.shape[1], device=dev)
        cols_v = torch.arange(4 * self.words, device=dev)
        cols_s = torch.arange(verb.shape[1], device=dev)
        kv_cols = keyb.shape[1] + 4 * self.words
        lo, n = 0, rows.numel()
        try:
            while lo < n:
                start = int(ends[lo - 1]) if lo else 0
                hi = max(lo + 1, int(np.searchsorted(ends, start + chunk_bytes, side="right")))
                vals = self.values[rows[lo:hi]].view(torch.uint8)
                rec = torch.cat([keyb[lo:hi], vals, verb[lo:hi]], 1)
                mask = torch.cat([cols_k < klen[lo:hi, None], cols_v < vlen[lo:hi, None],
                                  cols_s < vslen[lo:hi, None]], 1)
                for h, vo in zip(hashers, values_only):
                    stream = _compact(rec[:, :kv_cols], mask[:, :kv_cols]) if vo else \
                        _compact(rec, mask)
                    for p in range(0, stream.numel(), piece):
                        h.feed(stream[p:p + piece])
                lo = hi
        finally:
            done = [h.hexdigest() for h in hashers]
        return done

    def snapshot(self) -> "CRDTTable":
        """A copy of the table on its device (its own tensors; ``merges``
        starts at 0): a node's snapshot view."""
        out = CRDTTable.__new__(CRDTTable)
        out.__dict__.update(self.__dict__)
        out.values, out.versions = self.values.clone(), self.versions.clone()
        out.lengths = self.lengths.clone()
        out.present, out.merges = self.present.clone(), 0
        return out

    # -- the join ----------------------------------------------------------

    def merge_rows(self, rows: torch.Tensor, values: torch.Tensor,
                   versions: torch.Tensor, lengths: torch.Tensor | None = None) -> int:
        """Join a batch of versioned rows (``(N,)`` rows, ``(N, words)``
        int32 values, ``(N, 3)`` versions, ``(N,)`` value lengths, all
        ``value_bytes`` where not given) into the table; returns how many
        rows changed (not the reference's count of updates that changed
        the store: :meth:`apply_many` gives that).  :meth:`top_rows`, then
        :meth:`join_rows`."""
        if rows.numel() == 0:
            return 0
        return int(self.join_rows(*self.top_rows(rows, values, versions, lengths)).sum())

    def top_rows(self, rows: torch.Tensor, values: torch.Tensor, versions: torch.Tensor,
                 lengths: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
        """A batch (as :meth:`merge_rows` takes it) reduced to each row's
        top version, the first of equal tops as sequential applies keep it:
        distinct int64 rows, their values, versions and int64 lengths."""
        rows = rows.to(torch.int64)
        if lengths is None:
            lengths = torch.full_like(rows, self.value_bytes)
        if rows.numel() == 0:
            return rows, values, versions, lengths.to(torch.int64)
        order = lexsort([-version_rank(versions), rows])
        srt = rows[order]
        top = torch.ones_like(srt, dtype=torch.bool)
        top[1:] = srt[1:] != srt[:-1]
        pick = order[top]
        return rows[pick], values[pick].contiguous(), versions[pick], lengths[pick].to(torch.int64)

    def join_rows(self, keys: torch.Tensor, values: torch.Tensor, versions: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
        """Join distinct rows (:meth:`top_rows`' output) straight into the
        table's rows through ``crdt_merge_rows``, which writes only the rows
        it takes; returns the mask of rows taken, on the device (no sync).
        The kernel compares int32 versions: each side's ``(epoch, seq,
        node)`` becomes its dense rank among the ``2K`` versions of this
        join, an order key exact for every pair it compares whatever the
        triples' range (``Version.ZERO`` ranks lowest; equal versions share
        a rank, and the kernel keeps the table's row on a tie, as the
        reference's ``apply`` does).  The full triple and the length of the
        winner go back into ``versions`` and ``lengths``."""
        k = keys.numel()
        if k == 0:
            return torch.zeros(0, dtype=torch.bool, device=keys.device)
        cur_ver = self.versions[keys]
        rank = version_rank(torch.cat([cur_ver, versions])).to(torch.int32)
        cur_rank, new_rank = rank[:k].contiguous(), rank[k:].contiguous()
        out_rank = crdt_merge_rows(self.values, keys, cur_rank, values, new_rank)
        self.merges += 1
        took = out_rank != cur_rank
        self.versions[keys] = torch.where(took[:, None], versions, cur_ver)
        self.lengths[keys] = torch.where(took, lengths, self.lengths[keys])
        self.present[keys] = self.present[keys] | took
        return took

    def merge_store(self, other: "CRDTTable") -> None:
        """Join every present row of ``other`` (a table of the same layout)
        into this one through :meth:`top_rows` and :meth:`join_rows`, so
        through ``crdt_merge_rows``: the reference store's ``merge_store``.
        The join is the lattice max, so no order of the rows is needed."""
        if other.layout() != self.layout():
            raise ValueError(f"merge_store joins tables of one layout; got {other.layout()} "
                             f"into {self.layout()}")
        rows = torch.nonzero(other.present).flatten()
        if rows.numel() == 0:
            return
        batch = (other.values[rows], other.versions[rows], other.lengths[rows])
        self.join_rows(*self.top_rows(rows.to(self.device), *(x.to(self.device) for x in batch)))

    def _changes(self, rows: torch.Tensor, versions: torch.Tensor) -> int:
        """How many updates of a batch would change the table applied one
        by one in batch order (the reference's ``apply_many`` count): those
        whose version is above the table's and above every earlier version
        of the same row in the batch.  Sorted by (row, position), a running
        maximum of the batch's dense ranks restarts at each row: each row's
        segment is lifted above all earlier ones, so one ``cummax`` serves
        all rows."""
        k = rows.numel()
        if k == 0:
            return 0
        rows = rows.to(torch.int64)
        rank = version_rank(torch.cat([self.versions[rows], versions]))
        order = torch.sort(rows, stable=True).indices
        r, cur, new = rows[order], rank[:k][order], rank[k:][order]
        start = torch.ones_like(r, dtype=torch.bool)
        start[1:] = r[1:] != r[:-1]
        lift = (torch.cumsum(start, 0) - 1) * (2 * k + 1)
        run = torch.cummax(lift + new, 0).values - lift
        before = torch.full_like(run, -1)
        before[1:] = run[:-1]
        before[start] = -1
        return int((new > torch.maximum(before, cur)).sum())

    def apply_many(self, updates: Iterable[Update]) -> int:
        """Join host :class:`Update`\\ s (the reference store's
        ``apply_many``); returns how many updates changed the store,
        applied in batch order, as the reference counts them."""
        ups = list(updates)
        if not ups:
            return 0
        rows = torch.tensor([self.row_of(u.key) for u in ups], dtype=torch.int64,
                            device=self.device)
        vers = torch.tensor([(u.version.epoch, u.version.seq, u.version.node) for u in ups],
                            dtype=torch.int64, device=self.device)
        lens = torch.tensor([len(u.value) for u in ups], dtype=torch.int64, device=self.device)
        count = self._changes(rows, vers)
        self.merge_rows(rows, self.pack([u.value for u in ups]), vers, lens)
        return count


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
    vals = [v for _, v, _ in entries]
    load_rows(table, rows, table.pack(vals),
              torch.tensor([tuple(ver) for _, _, ver in entries], dtype=torch.int64,
                           device=table.device),
              torch.tensor([len(v) for v in vals], dtype=torch.int64, device=table.device))


def load_rows(table: CRDTTable, rows: torch.Tensor, values: torch.Tensor,
              versions: torch.Tensor | Sequence[int] = LOAD_VERSION,
              lengths: torch.Tensor | None = None) -> None:
    """The bulk form of :func:`load_entries`: write ``(N,)`` rows, their
    ``(N, words)`` int32 values, versions (``(N, 3)`` or one triple for
    all, ``LOAD_VERSION`` by default) and value lengths (``value_bytes``
    where not given) into ``table`` as they are, no join.  Rows must be
    distinct."""
    dev = table.device
    rows = rows.to(device=dev, dtype=torch.int64)
    n = rows.numel()
    if values.shape != (n, table.words):
        raise ValueError(f"values must be ({n}, {table.words}); got {tuple(values.shape)}")
    if n == 0:
        return
    if torch.unique(rows).numel() != n:
        raise ValueError("load_rows takes each row once")
    lo, hi = int(rows.min()), int(rows.max())
    if lo < 0 or hi >= table.n_rows:
        raise IndexError(f"rows must lie in [0, {table.n_rows}); got {lo} to {hi}")
    if lengths is None:
        lengths = torch.full((n,), table.value_bytes, dtype=torch.int64, device=dev)
    lengths = lengths.to(device=dev, dtype=torch.int64)
    if int(lengths.max()) > table.value_bytes or int(lengths.min()) < 0:
        raise ValueError(f"value lengths must lie in [0, {table.value_bytes}]")
    table.values[rows] = values.to(device=dev, dtype=torch.int32)
    table.versions[rows] = torch.as_tensor(versions, dtype=torch.int64, device=dev).expand(n, 3)
    table.lengths[rows] = lengths
    table.present[rows] = True
