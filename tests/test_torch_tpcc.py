"""The port's TPC-C workload (``repro_torch.core.workload.TPCCGenerator``,
``DiurnalLoad``) against the reference's on the CPU: the same transactions
for the paper's four mixes and several seeds (ids, nodes, versions, reads
versioned against a partly loaded store, write sets with their 80-, 100-
and 120-byte values, the NewOrder accounting); the diurnal load's factor
and scaled counts; ``GeoCluster.run`` on TPC-C field for field and digest
for digest under flat and geococo, the event and barrier engines, from an
empty and from a loaded store; and the YCSB runs of
``test_torch_geo_cluster.py`` from a loaded store.  The reference's WAN
plane is numpy only: neither side imports JAX here.
"""

import numpy as np
import pytest

import repro.core as ref
from repro.core import crdt as rcrdt
from repro.core import occ as rocc
from repro.core import workload as rwl
from repro_torch.core import crdt as pcrdt
from repro_torch.core import latency as plat
from repro_torch.core import workload as pwl
from repro_torch.core.replication import EngineConfig, GeoCluster

from test_torch_geo_cluster import BASE, REGIONS, check_runs, engines

SMALL = dict(n_warehouses=12, items_per_warehouse=20, remote_prob=0.25)


def vtuple(v) -> tuple:
    return (v.epoch, v.seq, v.node)


def host_form(txns) -> list:
    return [(t.txn_id, t.node, t.epoch, t.seq, tuple((k, vtuple(v)) for k, v in t.read_set),
             t.write_set) for t in txns]


def ref_store_of(table) -> rcrdt.DeltaCRDTStore:
    store = rcrdt.DeltaCRDTStore()
    store.apply_many([rcrdt.Update(k, v, rcrdt.Version(*vtuple(ver)))
                      for k, (v, ver) in table.full_state().items()])
    return store


def partly_loaded(gen, seed: int = 1):
    """A TPC-C store with every other row loaded."""
    table = gen.table("cpu")
    gen.load(table, seed=seed)
    table.present[::2] = False
    table.versions[::2] = -1
    table.lengths[::2] = 0
    return table


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("mix", sorted(pwl.TPCC_MIXES))
def test_transactions_equal_the_reference(mix, seed):
    cfg = dict(SMALL, mix=mix)
    ref_gen = rwl.TPCCGenerator(rwl.TPCCConfig(**cfg), 5, seed=seed)
    gen = pwl.TPCCGenerator(pwl.TPCCConfig(**cfg), 5, seed=seed)
    table = partly_loaded(gen)
    store = ref_store_of(table)
    assert len(table) == table.n_rows // 2
    for epoch in range(3):
        want = [t for ts in ref_gen.epoch_txns(epoch, 9, snapshot=store).values() for t in ts]
        batch = gen.epoch_txns(epoch, 9, table)
        assert host_form(batch.to_txns(table)) == host_form(want), epoch
        assert gen.neworder_ids == ref_gen.neworder_ids
        assert gen.neworder_count == ref_gen.neworder_count
        ups = [u for t in want for u in rocc.txn_updates(t)]
        assert batch.write_nbytes().tolist() == [u.nbytes for u in ups]
        # the epoch commits alike on both stores
        store.apply_many(ups)
        table.merge_rows(batch.write_row, batch.write_val, batch.versions()[batch.write_txn],
                         batch.write_len)
        assert table.digests() == (store.digest(), store.digest(values_only=True))
    assert ref_gen.rng.random() == gen.rng.random()


def test_a_key_written_twice_keeps_its_first_place_and_last_value():
    """``dict(writes)`` over 2 warehouses x 3 items: NewOrder's 10 writes
    repeat keys, with values of two widths on one key across types."""
    cfg = dict(n_warehouses=2, items_per_warehouse=3, mix="TPCC-C")
    ref_gen = rwl.TPCCGenerator(rwl.TPCCConfig(**cfg), 2, seed=4)
    gen = pwl.TPCCGenerator(pwl.TPCCConfig(**cfg), 2, seed=4)
    table = gen.table("cpu")
    want = [t for ts in ref_gen.epoch_txns(0, 30, snapshot=rcrdt.DeltaCRDTStore()).values()
            for t in ts]
    assert any(len(t.write_set) < 10 and len(t.write_set) > 3 for t in want)
    assert host_form(gen.epoch_txns(0, 30, table).to_txns(table)) == host_form(want)


def test_generator_checks_mix_and_layout():
    with pytest.raises(ValueError, match="unknown mix"):
        pwl.TPCCGenerator(pwl.TPCCConfig(mix="TPCC-E"), 3)
    gen = pwl.TPCCGenerator(pwl.TPCCConfig(**SMALL), 5)
    table = gen.table("cpu")
    assert (table.n_rows, table.value_bytes, table.words) == (240, 120, 30)
    with pytest.raises(ValueError, match="layout"):
        gen.epoch_txns(0, 2, pcrdt.CRDTTable(240, 120, device="cpu"))
    with pytest.raises(ValueError, match="layout"):
        gen.load(pcrdt.CRDTTable(240, 120, device="cpu"))
    assert pwl.TPCC_MIXES == rwl.TPCC_MIXES


@pytest.mark.parametrize("kw", [dict(period_epochs=4), dict(period_epochs=7, amplitude=0.9,
                                                            phase=1.3)])
def test_diurnal_load_scales_as_the_reference(kw):
    ref_load = rwl.DiurnalLoad(rwl.TPCCGenerator(rwl.TPCCConfig(**SMALL), 3, seed=2), **kw)
    load = pwl.DiurnalLoad(pwl.TPCCGenerator(pwl.TPCCConfig(**SMALL), 3, seed=2), **kw)
    table = load.table("cpu")
    store = rcrdt.DeltaCRDTStore()
    for epoch in range(9):
        assert load.load_factor(epoch) == ref_load.load_factor(epoch)
        want = ref_load.epoch_txns(epoch, 5, snapshot=store)
        batch = load.epoch_txns(epoch, 5, table)
        assert load.scaled(epoch, 5) == len(want[0])
        assert host_form(batch.to_txns(table)) == host_form(
            [t for ts in want.values() for t in ts])
    for bad in (dict(period_epochs=0), dict(period_epochs=3, amplitude=1.0)):
        with pytest.raises(ValueError):
            pwl.DiurnalLoad(load.inner, **bad)


def tpcc_engines(strategy: str, barrier: bool, *, mix: str = "TPCC-A", loaded: bool,
                 diurnal: bool = False):
    """The reference's and the port's engine and generator on TPC-C at the
    benchmark's LAN/WAN bandwidth, built alike, each store loaded alike
    when asked."""
    same = REGIONS[:, None] == REGIONS[None, :]
    bw = np.where(same, 10_000.0, 15.0)
    np.fill_diagonal(bw, np.inf)
    cfg = dict(n_nodes=5, sync_strategy=strategy, planner="kcenter", barrier=barrier,
               modeled_cpu=True)
    kw = dict(bandwidth_mbps=bw, seed=3, wan_mask=~same)
    eng = GeoCluster(EngineConfig(**cfg), device="cpu", **kw)
    gen = pwl.TPCCGenerator(pwl.TPCCConfig(**SMALL, mix=mix), 5, seed=3)
    re = ref.GeoCluster(ref.EngineConfig(**cfg), **kw)
    rg = rwl.TPCCGenerator(rwl.TPCCConfig(**SMALL, mix=mix), 5, seed=3)
    if diurnal:
        gen = pwl.DiurnalLoad(gen, period_epochs=4)
        rg = rwl.DiurnalLoad(rg, period_epochs=4)
    if loaded:
        eng.store = gen.table("cpu")
        gen.load(eng.store, seed=9)
        re.store = ref_store_of(eng.store)
    trace = plat.jitter_trace(BASE, 6, np.random.default_rng(0))
    return (re, rg, ref.jitter_trace(BASE, 6, np.random.default_rng(0))), (eng, gen, trace)


@pytest.mark.parametrize("loaded", [False, True])
@pytest.mark.parametrize("barrier", [False, True])
@pytest.mark.parametrize("strategy", ["flat", "geococo"])
def test_run_on_tpcc_matches_the_reference(strategy, barrier, loaded):
    (re, rg, rt), (pe, pg, pt) = tpcc_engines(strategy, barrier, loaded=loaded)
    want = re.run(rg, rt, txns_per_node=12)
    got = pe.run(pg, pt, txns_per_node=12)
    check_runs(want, got)
    assert pg.neworder_count == rg.neworder_count and pg.neworder_ids == rg.neworder_ids
    assert pe.store.merges == len(got.epochs)
    if strategy == "geococo":
        s = got.white_stats
        assert s.aborted_updates
        # rewrites of a loaded key with its own bytes never happen on TPC-C
        # (fresh random values), so the null rule stays silent
        assert s.null_updates == 0


@pytest.mark.parametrize("mix", ["TPCC-B", "TPCC-C", "TPCC-D"])
def test_the_other_mixes_under_a_diurnal_load(mix):
    (re, rg, rt), (pe, pg, pt) = tpcc_engines("geococo", False, mix=mix, loaded=True,
                                              diurnal=True)
    check_runs(re.run(rg, rt, txns_per_node=10), pe.run(pg, pt, txns_per_node=10))


@pytest.mark.parametrize("strategy", ["flat", "geococo"])
def test_ycsb_runs_from_a_loaded_store(strategy):
    """``test_torch_geo_cluster.py``'s YCSB runs with every key present
    before epoch 0: rewrites now find values, so the null rule fires."""
    (re, rg, rt), (pe, pg, pt) = engines(strategy, False)
    pe.store = pg.table("cpu")
    pg.load(pe.store, seed=11)
    re.store = ref_store_of(pe.store)
    got = pe.run(pg, pt, txns_per_node=8)
    check_runs(re.run(rg, rt, txns_per_node=8), got)
    if strategy == "geococo":
        assert got.white_stats.null_updates > 0


def test_filter_tells_values_apart_by_length():
    """An 80-byte value and a 100-byte value whose last 20 bytes are zero
    share their words: the null and dedup rules must still tell them apart,
    as the reference's byte comparisons do."""
    import dataclasses

    from repro.core import whitedata as rwd
    from repro_torch.core import occ as pocc
    from repro_torch.core import whitedata as pwd

    short = bytes(range(1, 81))
    long = short + b"\0" * 20
    table = pcrdt.CRDTTable(0, 120, n_warehouses=2, items_per_warehouse=4, device="cpu")
    pcrdt.load_entries(table, [("w0:i0", long, (0, 0, 0)), ("w0:i1", short, (0, 0, 0))])
    store = ref_store_of(table)
    txns = [rocc.Txn(1, 0, 1, 0, (), (("w0:i0", short),)),        # not null: shorter
            rocc.Txn(2, 1, 1, 0, (), (("w0:i1", long),)),         # not null: longer
            rocc.Txn(3, 2, 1, 0, (), (("w1:i0", short),)),
            rocc.Txn(4, 3, 1, 0, (), (("w1:i0", long),)),         # no duplicate of 3
            rocc.Txn(5, 4, 1, 0, (), (("w1:i1", long),)),
            rocc.Txn(6, 0, 1, 1, (), (("w1:i1", long),)),         # a duplicate of 5
            rocc.Txn(7, 1, 1, 1, (), (("w0:i1", short),))]        # null
    want = rwd.filter_group_batch(txns, store, enable_abort=False)
    batch = pocc.EpochBatch.from_txns(
        [pocc.Txn(t.txn_id, t.node, t.epoch, t.seq, (), t.write_set) for t in txns], table)
    got = pwd.filter_group_batch(batch, table, enable_abort=False)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert (got.stats.null_updates, got.stats.duplicate_updates) == (1, 1)
    assert [u.txn_id for u in batch.updates(table, got.kept)] == [u.txn_id for u in want.kept]
