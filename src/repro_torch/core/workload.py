"""Workload generators (paper Sec 6.1); the port's counterpart of the YCSB
half of ``repro.core.workload``.

YCSB: key-value transactions with Zipfian key skew (``theta``) and a read /
write mix.  The generator draws every transaction of an epoch on the host,
from the same numpy ``Generator`` stream as the reference's (so a seed
gives the same transactions), then makes the epoch's :class:`EpochBatch`
on the store's device in one pass that gathers the read versions and the
rewritten values from the table.  The draws do not depend on the store
(the reference draws its rewrite coin unconditionally), which is what lets
the host draw first.

The reference's ``TPCCGenerator`` and ``DiurnalLoad`` are not ported yet
(ROADMAP §1, W5).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .crdt import CRDTTable
from .occ import EpochBatch

__all__ = ["ZipfianSampler", "YCSBConfig", "YCSBGenerator", "EpochDraws"]


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
                    hot_set_size=cfg.hot_set_size)

    def table(self, device: str | torch.device | None = None) -> CRDTTable:
        """An empty store holding every key this workload can write: ``k0``
        .. ``k{n_keys - 1}`` (and the shared hot set ``k{h}``), or with
        ``hot_locality`` a hot set ``h{r}:{h}`` per region."""
        return CRDTTable(**self._layout(), device=device)

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
        got = dict(n_keys=snapshot.n_keys, value_bytes=snapshot.value_bytes,
                   n_regions=snapshot.n_regions, hot_set_size=snapshot.hot_set_size)
        if got != self._layout():
            raise ValueError(f"a store of layout {got} for a workload of {self._layout()}")
        dev = snapshot.device
        t = torch.from_numpy(draws.txns).to(dev)
        r = torch.from_numpy(draws.reads).to(dev)
        w = torch.from_numpy(draws.writes).to(dev)
        row = w[:, 1]
        seeds = w[:, 2:4].to(torch.int32)
        words = snapshot.words
        fresh = seeds[:, torch.arange(words, device=dev) % 2]
        tail = self.value_bytes % 4
        if tail:
            fresh[:, -1] &= (1 << (8 * tail)) - 1
        use_cur = (w[:, 4] != 0) & snapshot.present[row]
        val = torch.where(use_cur[:, None], snapshot.values[row], fresh)
        return EpochBatch(
            t[:, 0], t[:, 1], t[:, 2], t[:, 3],
            r[:, 0], r[:, 1], snapshot.versions[r[:, 1]],
            w[:, 0], row, val.contiguous(), snapshot.key_lengths(row), self.value_bytes)

    def epoch_txns(self, epoch: int, txns_per_node: int, snapshot: CRDTTable) -> EpochBatch:
        """One epoch's transactions for every node, as a batch on the
        snapshot's device (the reference's ``epoch_txns``, whose reads are
        versioned against ``snapshot``)."""
        return self.to_batch(self.draw(epoch, txns_per_node), snapshot)
