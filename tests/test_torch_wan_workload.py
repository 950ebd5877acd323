"""The port's YCSB generator (``repro_torch.core.workload``) against the
reference's on the CPU: the Zipfian draw from one cdf gives
``rng.choice(p=)``'s bits; for the same seed the same transactions epoch
after epoch (ids, nodes, versions, reads with the snapshot's versions,
writes with their values), with ``rewrite_frac > 0`` rewriting the
snapshot's values, hot sets shared or per region, a key written twice in a
transaction, and value widths that are no multiple of 8.  Both stores
evolve alike between epochs.  Neither side imports JAX here.
"""

import numpy as np
import pytest

from repro.core import crdt as rcrdt
from repro.core import occ as rocc
from repro.core import workload as rwl
from repro_torch.core import crdt as pcrdt
from repro_torch.core import workload as pwl

REGIONS = np.array([0, 0, 1, 1, 2])


def vtuple(v) -> tuple:
    return (v.epoch, v.seq, v.node)


def host_form(txns) -> list:
    return [(t.txn_id, t.node, t.epoch, t.seq, tuple((k, vtuple(v)) for k, v in t.read_set),
             t.write_set) for t in txns]


@pytest.mark.parametrize("n,theta", [(10, 0.0), (1000, 0.99), (100_000, 0.7)])
def test_zipf_draw_from_one_cdf_is_rng_choice_bit_for_bit(n, theta):
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    ref = rwl.ZipfianSampler(n, theta, a)
    got = pwl.ZipfianSampler(n, theta, b)
    assert np.array_equal(ref.perm, got.perm) and np.array_equal(ref.p, got.p)
    for size in (1, 4, 7):
        for _ in range(50):
            assert np.array_equal(ref.sample(a, size), got.sample(b, size))
    assert a.random() == b.random()
    assert got.top_mass(5) == ref.top_mass(5) and got.top_mass(0) == 0.0


CASES = {
    "rewrites": dict(n_keys=60, theta=0.9, read_ratio=0.4, rewrite_frac=0.5),
    "hot_locality": dict(n_keys=500, theta=0.8, read_ratio=0.3, hot_write_frac=0.4,
                         hot_locality=True, hot_set_size=3, rewrite_frac=0.2),
    "shared_hot_set": dict(n_keys=8, theta=0.5, read_ratio=0.2, hot_write_frac=0.5,
                           hot_set_size=12, rewrite_frac=0.3, value_bytes=13),
    "narrow_values": dict(n_keys=200, theta=0.99, read_ratio=0.5, rewrite_frac=0.1,
                          value_bytes=6, ops_per_txn=6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_draws_equal_for_seeds(case):
    cfg = CASES[case]
    ref_gen = rwl.YCSBGenerator(rwl.YCSBConfig(**cfg), 5, seed=7, node_region=REGIONS)
    gen = pwl.YCSBGenerator(pwl.YCSBConfig(**cfg), 5, seed=7, node_region=REGIONS)
    ref_store, table = rcrdt.DeltaCRDTStore(), gen.table("cpu")
    rewrites = 0
    for epoch in range(4):
        want = [t for ts in ref_gen.epoch_txns(epoch, 9, snapshot=ref_store).values() for t in ts]
        batch = gen.epoch_txns(epoch, 9, table)
        got = batch.to_txns(table)
        assert host_form(got) == host_form(want), epoch
        assert batch.write_nbytes().tolist() == [u.nbytes for t in want
                                                  for u in rocc.txn_updates(t)]
        rewrites += sum(ref_store.get(k) == v for t in want for k, v in t.write_set)
        # the epoch commits alike on both stores (every write, latest version)
        ups = [u for t in want for u in rocc.txn_updates(t)]
        ref_store.apply_many(ups)
        table.merge_rows(batch.write_row, batch.write_val, batch.versions()[batch.write_txn])
        assert table.digest() == ref_store.digest()
    assert rewrites > 0


def test_a_key_written_twice_keeps_its_first_place_and_last_value():
    """``dict(writes)``: with 8 ops over 3 keys most transactions write a
    key twice."""
    cfg = dict(n_keys=3, theta=0.0, read_ratio=0.1, ops_per_txn=8, value_bytes=16)
    ref_gen = rwl.YCSBGenerator(rwl.YCSBConfig(**cfg), 2, seed=1)
    gen = pwl.YCSBGenerator(pwl.YCSBConfig(**cfg), 2, seed=1)
    table = gen.table("cpu")
    want = [t for ts in ref_gen.epoch_txns(0, 20, snapshot=rcrdt.DeltaCRDTStore()).values()
            for t in ts]
    assert host_form(gen.epoch_txns(0, 20, table).to_txns(table)) == host_form(want)


def test_generator_checks_the_store_layout():
    gen = pwl.YCSBGenerator(pwl.YCSBConfig(n_keys=50, hot_write_frac=0.2, hot_locality=True),
                            5, node_region=REGIONS)
    table = gen.table("cpu")
    assert (table.n_keys, table.n_regions, table.value_bytes) == (50, 3, 96)
    with pytest.raises(ValueError, match="layout"):
        gen.epoch_txns(0, 2, pcrdt.CRDTTable(50, 96, device="cpu"))
