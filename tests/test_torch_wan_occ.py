"""The port's epoch validation (``repro_torch.core.occ``, one tensor path)
against the reference's ``validate_epoch_detailed`` in both its modes
(``python``, ``numpy``) on the CPU: random contended epochs with forced
``(epoch, seq, node)`` collisions, with and without a snapshot whose
versions make reads stale, shuffled; the forced-collision regression; the
batch's host forms.  Neither side imports JAX here.
"""

import numpy as np
import pytest
import torch

from repro.core import crdt as rcrdt
from repro.core import occ as rocc
from repro_torch.core import crdt as pcrdt
from repro_torch.core import occ as pocc

N_KEYS, VB = 12, 4


def random_epoch(rng, *, n_txns: int = 60, n_keys: int = N_KEYS, collisions: bool = True,
                 epochs: int = 1, values: int = 256) -> list:
    """Reference ``Txn``\\ s with heavy key contention, reads at versions
    around the snapshot's, and (optionally) forced version collisions (a
    small seq range).  Values come from a pool of ``values`` so that equal
    ``(key, value)`` content recurs."""
    txns = []
    pool = [bytes([i % 256]) * VB for i in range(values)]
    for tid in range(n_txns):
        node = int(rng.integers(3))
        seq = int(rng.integers(8 if collisions else 10_000))
        writes = [(f"k{int(rng.integers(n_keys))}", pool[int(rng.integers(values))])
                  for _ in range(int(rng.integers(4)))]
        reads = [(f"k{int(rng.integers(n_keys))}",
                  rcrdt.Version(int(rng.integers(2)), int(rng.integers(8)), node))
                 for _ in range(int(rng.integers(4)))]
        txns.append(rocc.Txn(tid, node, 1 + int(rng.integers(epochs)), seq, tuple(reads),
                             tuple(dict(writes).items())))
    return txns


def snapshot_pair(rng, n_keys: int = N_KEYS, *, epoch: int = 1):
    """A reference store and a port table loaded with the same state."""
    ref = rcrdt.DeltaCRDTStore()
    for j in range(n_keys):
        if rng.random() < 0.8:
            ref.apply(rcrdt.Update(f"k{j}", bytes([j]) * VB,
                                   rcrdt.Version(epoch, int(rng.integers(8)), int(rng.integers(3)))))
    table = pcrdt.CRDTTable(n_keys, VB, device="cpu")
    pcrdt.load_entries(table, [(k, v, (ver.epoch, ver.seq, ver.node))
                               for k, (v, ver) in ref.full_state().items()])
    return ref, table


def port_txns(txns: list) -> list:
    return [pocc.Txn(t.txn_id, t.node, t.epoch, t.seq,
                     tuple((k, pcrdt.Version(v.epoch, v.seq, v.node)) for k, v in t.read_set),
                     t.write_set) for t in txns]


def as_sets(res) -> tuple:
    return res.committed, res.read_aborted, res.ww_aborted, res.aborted


@pytest.mark.parametrize("mode", ["python", "numpy"])
@pytest.mark.parametrize("collisions", [False, True])
def test_validation_matches_the_reference(mode, collisions):
    rng = np.random.default_rng(11 + collisions)
    ref_snap, table = snapshot_pair(rng)
    for trial in range(12):
        txns = random_epoch(rng, collisions=collisions)
        for snapshot, snap in ((None, None), (ref_snap, table)):
            want = rocc.validate_epoch_detailed(txns, snapshot, mode=mode)
            perm = [txns[i] for i in rng.permutation(len(txns))]
            for order in (txns, perm):
                batch = pocc.EpochBatch.from_txns(port_txns(order), snap)
                got = pocc.validate_epoch_detailed(batch, snap)
                assert as_sets(got) == as_sets(want), (trial, snapshot is None)
        assert want.read_aborted or snapshot is None


def test_forced_version_collision_single_winner():
    """Two transactions of one node sharing ``(epoch, seq, node)``: exactly
    one writer wins the key, broken by ``txn_id``, whichever comes first."""
    a = pocc.Txn(10, 0, 0, 7, (), (("k3", b"aaaa"),))
    b = pocc.Txn(11, 0, 0, 7, (), (("k3", b"bbbb"),))
    assert a.version == b.version
    for order in ([a, b], [b, a]):
        res = pocc.validate_epoch_detailed(pocc.EpochBatch.from_txns(order))
        assert res.committed == {10} and res.ww_aborted == {11} and not res.read_aborted
    ref = rocc.validate_epoch_detailed([rocc.Txn(10, 0, 0, 7, (), (("k3", b"aaaa"),)),
                                        rocc.Txn(11, 0, 0, 7, (), (("k3", b"bbbb"),))])
    assert as_sets(res) == as_sets(ref)


def test_winner_map_includes_read_aborted_writers():
    """No reinstatement: a writer aborted by a stale read still wins its
    key, so the later writer of that key aborts too."""
    table = pcrdt.CRDTTable(4, VB, device="cpu")
    pcrdt.load_entries(table, [("k1", b"1111", (0, 9, 0))])
    t1 = pocc.Txn(1, 0, 1, 0, (("k1", pcrdt.Version(0, 1, 0)),), (("k0", b"aaaa"),))
    t2 = pocc.Txn(2, 1, 1, 5, (), (("k0", b"bbbb"),))
    res = pocc.validate_epoch_detailed(pocc.EpochBatch.from_txns([t1, t2], table), table)
    assert res.read_aborted == {1} and res.ww_aborted == {2} and res.committed == frozenset()


def test_empty_epochs_and_empty_sets():
    assert as_sets(pocc.validate_epoch_detailed(pocc.EpochBatch.from_txns([]))) == \
        (frozenset(),) * 4
    txns = [pocc.Txn(i, i % 2, 0, i) for i in range(3)]
    res = pocc.validate_epoch_detailed(pocc.EpochBatch.from_txns(txns))
    assert res.committed == {0, 1, 2}


def test_batch_host_forms_round_trip():
    rng = np.random.default_rng(3)
    _, table = snapshot_pair(rng)
    txns = port_txns(random_epoch(rng, n_txns=30))
    batch = pocc.EpochBatch.from_txns(txns, table)
    assert batch.to_txns(table) == txns
    want = [u for t in txns for u in pocc.txn_updates(t)]
    assert batch.updates(table) == want
    assert batch.write_nbytes().tolist() == [u.nbytes for u in want]
    # a subset keeps its transactions' reads and writes, in the order given
    idx = torch.tensor([5, 2, 17, 3])
    assert batch.select(idx).to_txns(table) == [txns[i] for i in idx.tolist()]
    nodes = batch.node_txns([2, 0])
    assert [txns[i].node for i in nodes.tolist()] == sorted(
        (t.node for t in txns if t.node in (0, 2)), key=lambda n: n != 2)
