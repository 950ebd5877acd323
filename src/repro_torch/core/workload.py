"""Workload generators (paper Sec 6.1); the port's counterpart of
``repro.core.workload``.

YCSB: key-value transactions with Zipfian key skew (``theta``) and a read /
write mix.  TPC-C: the paper's four mixes over the five transaction types,
on warehouse-scoped keys ``w{w}:i{i}`` with a small cross-warehouse
probability; NewOrder, Payment and Delivery write 120-, 80- and 100-byte
values.  Each generator draws every transaction of an epoch on the host,
from the same numpy ``Generator`` stream as the reference's (so a seed
gives the same transactions), then makes the epoch's :class:`EpochBatch`
on the store's device in one pass that gathers the read versions (and
YCSB's rewritten values) from the table.  The draws do not depend on the
store (the reference draws its rewrite coin unconditionally), which is
what lets the host draw first.  :class:`DiurnalLoad` scales any
generator's transactions an epoch.

``load`` fills a generator's store before epoch 0 (YCSB's load phase, a
TPC-C database populated before the run): every row, its value made from
a seed on the store's device, at ``crdt.LOAD_VERSION``.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Sequence

import numpy as np
import torch

from .crdt import LOAD_VERSION, CRDTTable, load_rows, seeded_words
from .occ import EpochBatch

__all__ = ["ZipfianSampler", "YCSBConfig", "YCSBGenerator", "EpochDraws", "TPCC_MIXES",
           "TPCCConfig", "TPCCGenerator", "TPCCDraws", "DiurnalLoad"]

# rows a loader writes at a time
LOAD_CHUNK_ROWS = 1 << 20


def _check_layout(table: CRDTTable, layout: dict) -> None:
    if table.layout() != layout:
        raise ValueError(f"a store of layout {table.layout()} for a workload of {layout}")


def _load(table: CRDTTable, layout: dict, values) -> None:
    """Load every row of ``table``, ``values(rows)`` giving their int32
    words, LOAD_CHUNK_ROWS rows at a time."""
    _check_layout(table, layout)
    step = LOAD_CHUNK_ROWS
    for lo in range(0, table.n_rows, step):
        rows = torch.arange(lo, min(lo + step, table.n_rows), device=table.device)
        load_rows(table, rows, values(rows), LOAD_VERSION)


class ZipfianSampler:
    """Bounded Zipfian sampler: P(rank r) ∝ 1 / r^theta over n_keys items.

    theta=0 is uniform; theta→1+ concentrates on a hot head.  Ranks are
    shuffled onto key ids so that "hot" keys are spread across the keyspace.
    """

    def __init__(self, n_keys: int, theta: float, rng: np.random.Generator):
        if n_keys <= 0:
            raise ValueError("n_keys must be positive")
        ranks = np.arange(1, n_keys + 1, dtype=float)
        p = ranks ** (-theta)
        self.p = p / p.sum()
        self.perm = rng.permutation(n_keys)
        self.n_keys = n_keys
        # Generator.choice(n, size, p=p) draws cdf.searchsorted(random(size),
        # "right") with cdf = p.cumsum() / its last entry, after checking and
        # summing p: O(n_keys) a call.  The cdf is built once here and drawn
        # from the same way, bit for bit.
        cdf = self.p.cumsum()
        self._cdf = cdf / cdf[-1]

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        """``perm[rng.choice(n_keys, size=size, p=p)]``, bit for bit."""
        return self.keys_of(rng.random(size))

    def keys_of(self, u: np.ndarray) -> np.ndarray:
        """The keys that uniform draws ``u`` (any shape) pick."""
        return self.perm[self._cdf.searchsorted(u, side="right")]

    def top_mass(self, k: int) -> float:
        """Probability mass of the ``k`` most popular keys."""
        if k <= 0:
            return 0.0
        return float(self.p[: min(k, self.n_keys)].sum())


@dataclasses.dataclass
class YCSBConfig:
    n_keys: int = 10_000
    theta: float = 0.7
    read_ratio: float = 0.5
    ops_per_txn: int = 4
    value_bytes: int = 100
    # fraction of write ops redirected to a tiny shared hot set — the knob the
    # benchmarks use to hit the paper's target conflict ratios exactly
    hot_write_frac: float = 0.0
    hot_set_size: int = 16
    # fraction of writes that re-write the key's current value (no-op UPSERTs;
    # the "null or sparse data" class of white data)
    rewrite_frac: float = 0.0
    # when True (and the generator is given node regions), each region has its
    # own hot set — the paper's workload-locality assumption (Sec 6.6):
    # conflicts concentrate within latency-proximate groups
    hot_locality: bool = False


@dataclasses.dataclass
class EpochDraws:
    """One epoch's host draws: per transaction ``(txn_id, node, epoch,
    seq)``; per read ``(txn, row)``; per write ``(txn, row, seed, rewrite)``
    with its 8-byte value seed as two little-endian int32 words.  Positions
    index the epoch's transactions."""

    txns: np.ndarray      # (T, 4) int64
    reads: np.ndarray     # (R, 2) int64
    writes: np.ndarray    # (W, 5) int64: txn, row, seed word 0, seed word 1, rewrite


class YCSBGenerator:
    """Generates per-node, per-epoch transaction batches."""

    def __init__(
        self,
        cfg: YCSBConfig,
        n_nodes: int,
        seed: int = 0,
        node_region: Sequence[int] | None = None,
    ):
        self.cfg = cfg
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)
        self.sampler = ZipfianSampler(cfg.n_keys, cfg.theta, self.rng)
        self.node_region = (
            np.asarray(node_region) if node_region is not None else np.zeros(n_nodes, dtype=int)
        )
        self._txn_counter = 0
        # node-local monotone commit sequence: Version = (epoch, seq, node)
        # must be unique per transaction
        self._seq = [0] * n_nodes

    @property
    def value_bytes(self) -> int:
        """The length of every value written: an 8-byte seed tiled to
        ``value_bytes`` and cut there (96 bytes for 100)."""
        vb = self.cfg.value_bytes
        return min(vb, 8 * max(1, vb // 8))

    def _layout(self) -> dict:
        cfg = self.cfg
        hot = cfg.hot_write_frac > 0.0
        n_keys, n_regions = cfg.n_keys, 0
        if hot and cfg.hot_locality:
            n_regions = int(self.node_region.max()) + 1
        elif hot:
            n_keys = max(n_keys, cfg.hot_set_size)
        return dict(n_keys=n_keys, value_bytes=self.value_bytes, n_regions=n_regions,
                    hot_set_size=cfg.hot_set_size, n_warehouses=0, items_per_warehouse=0)

    def table(self, device: str | torch.device | None = None) -> CRDTTable:
        """An empty store holding every key this workload can write: ``k0``
        .. ``k{n_keys - 1}`` (and the shared hot set ``k{h}``), or with
        ``hot_locality`` a hot set ``h{r}:{h}`` per region."""
        return CRDTTable(**self._layout(), device=device)

    def _fresh(self, seeds: torch.Tensor, words: int) -> torch.Tensor:
        """Values of 8-byte seeds (two int32 words a row) tiled to the value
        width, cut at ``value_bytes`` (the reference's ``_value``)."""
        out = seeds[:, torch.arange(words, device=seeds.device) % 2]
        tail = self.value_bytes % 4
        if tail:
            out[:, -1] &= (1 << (8 * tail)) - 1
        return out

    def load(self, table: CRDTTable, *, seed: int = 0) -> None:
        """YCSB's load phase: every row of ``table`` present before epoch 0,
        each value an 8-byte seed made from ``seed`` and the row tiled to
        the value width, as the workload's writes are."""
        _load(table, self._layout(),
              lambda rows: self._fresh(seeded_words(seed, rows, 2), table.words))

    def draw(self, epoch: int, txns_per_node: int) -> EpochDraws:
        """Every draw of one epoch's transactions, node by node, in the
        reference's order (``workload.py:171-203``): the keys' uniforms, then
        per key the read coin, the hot coin and slot, the value seed and the
        rewrite coin.  ``rng.bytes(8)`` is two ``next_uint32`` draws of the
        bit generator (``Generator.bytes`` draws ``integers(0, 2**32,
        size=2, dtype=uint32)``, which takes one ``next_uint32`` each), taken
        here through its ctypes interface at a tenth of the cost.  The
        loop draws only; keys, rows and each transaction's write set
        (``dict(writes)``: a key written twice keeps its first position and
        its last value) are found afterwards, in arrays."""
        cfg = self.cfg
        rng = self.rng
        bits = rng.bit_generator.ctypes
        next_u32, state = bits.next_uint32, bits.state
        ops, hot = cfg.ops_per_txn, cfg.hot_write_frac > 0.0
        n_t = self.n_nodes * txns_per_node
        u = np.empty((n_t, ops))
        # per op: -1 a read, -2 a write to its key, h >= 0 a write to hot slot h
        kind = np.full((n_t, ops), -1, dtype=np.int64)
        seed = np.zeros((n_t, ops, 2), dtype=np.uint32)
        rewrite = np.zeros((n_t, ops), dtype=bool)
        txns = []
        t = 0
        for node in range(self.n_nodes):
            for _ in range(txns_per_node):
                u[t] = rng.random(ops)
                for j in range(ops):
                    if rng.random() < cfg.read_ratio:
                        continue
                    if hot and rng.random() < cfg.hot_write_frac:
                        kind[t, j] = int(rng.integers(0, cfg.hot_set_size))
                    else:
                        kind[t, j] = -2
                    seed[t, j] = (next_u32(state), next_u32(state))
                    if cfg.rewrite_frac > 0.0:
                        rewrite[t, j] = rng.random() < cfg.rewrite_frac
                txns.append((self._txn_counter, node, epoch, self._seq[node]))
                self._seq[node] += 1
                self._txn_counter += 1
                t += 1
        keys = self.sampler.keys_of(u)
        owner = np.repeat(np.arange(n_t), ops)
        kind, keys = kind.ravel(), keys.ravel()
        reads = np.stack([owner[kind == -1], keys[kind == -1]], 1)
        region = np.repeat(self.node_region[np.array([x[1] for x in txns], dtype=np.int64)], ops)
        if cfg.hot_locality:
            hot_row = cfg.n_keys + region * cfg.hot_set_size + kind
        else:
            hot_row = kind
        row = np.where(kind == -2, keys, hot_row)
        pos = np.flatnonzero(kind != -1)
        wt, wr = owner[pos], row[pos]
        # per (transaction, row): its first position and its last op
        order = np.lexsort((pos, wr, wt))
        ot, orow = wt[order], wr[order]
        brk = np.ones(len(order) + 1, dtype=bool)
        brk[1:-1] = (ot[1:] != ot[:-1]) | (orow[1:] != orow[:-1])
        first, last = pos[order[brk[:-1]]], pos[order[brk[1:]]]
        keep = np.argsort(first, kind="stable")
        first, last = first[keep], last[keep]
        words = seed.reshape(-1, 2)[last].view(np.int32).astype(np.int64)
        writes = np.column_stack([owner[first], row[first], words, rewrite.ravel()[last]])
        return EpochDraws(np.array(txns, dtype=np.int64).reshape(-1, 4),
                          reads.astype(np.int64).reshape(-1, 2),
                          writes.astype(np.int64).reshape(-1, 5))

    def to_batch(self, draws: EpochDraws, snapshot: CRDTTable) -> EpochBatch:
        """The epoch's batch on the store's device: the draws copied over,
        the read versions gathered from ``snapshot``, each write's value the
        seed tiled to the value width, or the snapshot's current value where
        the rewrite coin fell and the key is present."""
        _check_layout(snapshot, self._layout())
        dev = snapshot.device
        t = torch.from_numpy(draws.txns).to(dev)
        r = torch.from_numpy(draws.reads).to(dev)
        w = torch.from_numpy(draws.writes).to(dev)
        row = w[:, 1]
        fresh = self._fresh(w[:, 2:4].to(torch.int32), snapshot.words)
        use_cur = (w[:, 4] != 0) & snapshot.present[row]
        val = torch.where(use_cur[:, None], snapshot.values[row], fresh)
        length = torch.where(use_cur, snapshot.lengths[row], self.value_bytes)
        return EpochBatch(
            t[:, 0], t[:, 1], t[:, 2], t[:, 3],
            r[:, 0], r[:, 1], snapshot.versions[r[:, 1]],
            w[:, 0], row, val.contiguous(), snapshot.key_lengths(row), length)

    def epoch_txns(self, epoch: int, txns_per_node: int, snapshot: CRDTTable) -> EpochBatch:
        """One epoch's transactions for every node, as a batch on the
        snapshot's device (the reference's ``epoch_txns``, whose reads are
        versioned against ``snapshot``)."""
        return self.to_batch(self.draw(epoch, txns_per_node), snapshot)


# ---------------------------------------------------------------------------
# TPC-C mixes (paper Sec 6.1)
# ---------------------------------------------------------------------------

# (NewOrder, Payment, OrderStatus, Delivery, StockLevel)
TPCC_MIXES: dict[str, tuple[float, float, float, float, float]] = {
    # write-intensive: NewOrder+Payment > 90%
    "TPCC-A": (0.55, 0.37, 0.03, 0.03, 0.02),
    # read-intensive: OrderStatus + StockLevel dominate
    "TPCC-B": (0.08, 0.08, 0.42, 0.04, 0.38),
    # balanced: even
    "TPCC-C": (0.20, 0.20, 0.20, 0.20, 0.20),
    # real-time: OrderStatus-heavy with moderate writes
    "TPCC-D": (0.18, 0.14, 0.50, 0.08, 0.10),
}

_TXN_WRITES = {  # (n_write_keys, n_read_keys, value_bytes)
    "NewOrder": (10, 3, 120),
    "Payment": (3, 1, 80),
    "OrderStatus": (0, 4, 0),
    "Delivery": (6, 2, 100),
    "StockLevel": (0, 8, 0),
}
_TXN_TYPES = tuple(_TXN_WRITES)
_TPCC_VALUE_BYTES = max(v for _, _, v in _TXN_WRITES.values())


@dataclasses.dataclass
class TPCCConfig:
    n_warehouses: int = 100
    mix: str = "TPCC-C"
    remote_prob: float = 0.10       # cross-warehouse access (NewOrder remote items)
    items_per_warehouse: int = 200


@dataclasses.dataclass
class TPCCDraws:
    """One epoch's TPC-C host draws: per transaction ``(txn_id, node,
    epoch, seq)``; per read ``(txn, row)``; per write ``(txn, row,
    length)`` and its value as int32 words (zero padded to 120 bytes).
    Positions index the epoch's transactions; writes are each transaction's
    write set (``dict(writes)``: a key written twice keeps its first
    position and its last value)."""

    txns: np.ndarray      # (T, 4) int64
    reads: np.ndarray     # (R, 2) int64
    writes: np.ndarray    # (W, 3) int64: txn, row, length
    values: np.ndarray    # (W, 30) int32


def _write_sets(owner: np.ndarray, row: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per (transaction, row) of a batch's writes in draw order: the
    position of its first write and of its last, in the order of the
    first."""
    pos = np.arange(len(row))
    order = np.lexsort((pos, row, owner))
    ot, orow = owner[order], row[order]
    brk = np.ones(len(order) + 1, dtype=bool)
    brk[1:-1] = (ot[1:] != ot[:-1]) | (orow[1:] != orow[:-1])
    first, last = pos[order[brk[:-1]]], pos[order[brk[1:]]]
    keep = np.argsort(first, kind="stable")
    return first[keep], last[keep]


class TPCCGenerator:
    """TPC-C transactions a node an epoch over the nodes' home warehouses
    (``np.array_split`` of the warehouses).  ``neworder_ids`` holds the
    newest epoch's NewOrder transaction ids and ``neworder_count`` the
    run's total: the tpmC accounting."""

    def __init__(self, cfg: TPCCConfig, n_nodes: int, seed: int = 0):
        if cfg.mix not in TPCC_MIXES:
            raise ValueError(f"unknown mix {cfg.mix!r}")
        self.cfg = cfg
        self.n_nodes = n_nodes
        self.rng = np.random.default_rng(seed)
        self._txn_counter = 0
        # node-local monotone commit sequence: Version = (epoch, seq, node)
        # must be unique per transaction
        self._seq = [0] * n_nodes
        self.neworder_ids: set[int] = set()
        self.neworder_count = 0
        # warehouses are partitioned across nodes (home warehouses)
        self.home = np.array_split(np.arange(cfg.n_warehouses), n_nodes)
        # Generator.choice(5, p=p) searches the cdf p.cumsum() / its last
        # entry for one random() draw, after checking p: the same cdf here
        p = np.array(TPCC_MIXES[cfg.mix])
        cdf = p.cumsum()
        cdf /= cdf[-1]
        self._cdf = cdf.tolist()

    @property
    def value_bytes(self) -> int:
        """The widest value a transaction writes (NewOrder's)."""
        return _TPCC_VALUE_BYTES

    def _layout(self) -> dict:
        return dict(n_keys=0, value_bytes=self.value_bytes, n_regions=0, hot_set_size=16,
                    n_warehouses=self.cfg.n_warehouses,
                    items_per_warehouse=self.cfg.items_per_warehouse)

    def table(self, device: str | torch.device | None = None) -> CRDTTable:
        """An empty store of every ``w{w}:i{i}``."""
        return CRDTTable(**self._layout(), device=device)

    def load(self, table: CRDTTable, *, seed: int = 0) -> None:
        """Every row of ``table`` present before epoch 0, each value 120
        random bytes (a NewOrder's width) made from ``seed`` and the row."""
        _load(table, self._layout(), lambda rows: seeded_words(seed, rows, table.words))

    def draw(self, epoch: int, txns_per_node: int) -> TPCCDraws:
        """Every draw of one epoch's transactions, node by node, in the
        reference's order (``workload.py:269-327``): the type
        (``choice(5, p=p)``), then per write the remote coin, the
        warehouse (``choice(homes)`` or ``integers(0, n_warehouses)``), the
        item and the value's bytes, then per read the warehouse and the
        item.  ``random()`` is the bit generator's ``next_double``, taken
        through its ctypes interface, and ``choice(homes)`` is
        ``homes[integers(0, len(homes))]``, the draw ``Generator.choice``
        makes."""
        cfg = self.cfg
        rng = self.rng
        bits = rng.bit_generator.ctypes
        next_double, state = bits.next_double, bits.state
        integers, take = rng.integers, rng.bytes
        cdf, remote, n_wh, items = self._cdf, cfg.remote_prob, cfg.n_warehouses, \
            cfg.items_per_warehouse
        txns, reads, w_txn, w_row, w_len, vals = [], [], [], [], [], []
        self.neworder_ids = set()
        t = 0
        for node in range(self.n_nodes):
            homes = self.home[node].tolist()
            n_home = len(homes)
            for _ in range(txns_per_node):
                kind = bisect.bisect_right(cdf, next_double(state))
                n_w, n_r, vbytes = _TXN_WRITES[_TXN_TYPES[kind]]
                for _ in range(n_w):
                    if next_double(state) < remote or n_home == 0:
                        w = int(integers(0, n_wh))
                    else:
                        w = homes[integers(0, n_home)]
                    w_row.append(w * items + int(integers(0, items)))
                    w_txn.append(t)
                    w_len.append(vbytes)
                    vals.append(take(vbytes))
                for _ in range(n_r):
                    w = homes[integers(0, n_home)] if n_home else int(integers(0, n_wh))
                    reads.append((t, w * items + int(integers(0, items))))
                txns.append((self._txn_counter, node, epoch, self._seq[node]))
                if kind == 0:
                    self.neworder_ids.add(self._txn_counter)
                    self.neworder_count += 1
                self._seq[node] += 1
                self._txn_counter += 1
                t += 1
        owner, row = np.array(w_txn, dtype=np.int64), np.array(w_row, dtype=np.int64)
        first, last = _write_sets(owner, row)
        width = 4 * (-(-self.value_bytes // 4))
        buf = b"".join(vals[i].ljust(width, b"\0") for i in last.tolist())
        words = np.frombuffer(buf, dtype="<i4").astype(np.int32).reshape(-1, width // 4)
        writes = np.column_stack([owner[first], row[first], np.array(w_len, dtype=np.int64)[last]])
        return TPCCDraws(np.array(txns, dtype=np.int64).reshape(-1, 4),
                         np.array(reads, dtype=np.int64).reshape(-1, 2),
                         writes.astype(np.int64).reshape(-1, 3), words)

    def to_batch(self, draws: TPCCDraws, snapshot: CRDTTable) -> EpochBatch:
        """The epoch's batch on the store's device: the draws copied over,
        the read versions gathered from ``snapshot``."""
        _check_layout(snapshot, self._layout())
        dev = snapshot.device
        t = torch.from_numpy(draws.txns).to(dev)
        r = torch.from_numpy(draws.reads).to(dev)
        w = torch.from_numpy(draws.writes).to(dev)
        row = w[:, 1] + snapshot.w_base
        return EpochBatch(
            t[:, 0], t[:, 1], t[:, 2], t[:, 3],
            r[:, 0], r[:, 1] + snapshot.w_base, snapshot.versions[r[:, 1] + snapshot.w_base],
            w[:, 0], row, torch.from_numpy(draws.values).to(dev), snapshot.key_lengths(row),
            w[:, 2])

    def epoch_txns(self, epoch: int, txns_per_node: int, snapshot: CRDTTable) -> EpochBatch:
        """One epoch's transactions for every node, as a batch on the
        snapshot's device (reads versioned against ``snapshot``)."""
        return self.to_batch(self.draw(epoch, txns_per_node), snapshot)


class DiurnalLoad:
    """Deterministic diurnal (time-varying) load around any generator: the
    transactions a node an epoch become ``round(txns_per_node * (1 +
    amplitude * sin(2*pi*epoch/period_epochs + phase)))``, at least 1.
    Key skew, read ratio and transaction ids stay the wrapped generator's;
    ``table``, ``load`` and ``to_batch`` are its own."""

    def __init__(self, inner, *, period_epochs: int, amplitude: float = 0.5,
                 phase: float = 0.0):
        if period_epochs <= 0:
            raise ValueError("period_epochs must be positive")
        if not 0.0 <= amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        self.inner = inner
        self.period_epochs = int(period_epochs)
        self.amplitude = float(amplitude)
        self.phase = float(phase)

    def load_factor(self, epoch: int) -> float:
        """The multiplier applied at ``epoch`` (1 ± amplitude)."""
        ang = 2.0 * np.pi * epoch / self.period_epochs + self.phase
        return 1.0 + self.amplitude * float(np.sin(ang))

    def scaled(self, epoch: int, txns_per_node: int) -> int:
        return max(1, int(round(txns_per_node * self.load_factor(epoch))))

    def table(self, device: str | torch.device | None = None) -> CRDTTable:
        return self.inner.table(device)

    def load(self, table: CRDTTable, **kw) -> None:
        self.inner.load(table, **kw)

    def draw(self, epoch: int, txns_per_node: int):
        return self.inner.draw(epoch, self.scaled(epoch, txns_per_node))

    def to_batch(self, draws, snapshot: CRDTTable) -> EpochBatch:
        return self.inner.to_batch(draws, snapshot)

    def epoch_txns(self, epoch: int, txns_per_node: int, snapshot: CRDTTable) -> EpochBatch:
        return self.to_batch(self.draw(epoch, txns_per_node), snapshot)
