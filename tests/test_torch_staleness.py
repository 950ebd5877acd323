"""The port's per-node snapshot views (``EngineConfig(staleness_feedback=
True)``) against the reference's on the CPU, with exact equality: the
feedback runs field for field (read and write-write aborts, view lags,
``FilterStats``, the message matrix, both digests) under flat, hier and
geococo on YCSB (with rewrites) and TPC-C, and along the abort curve's
cadences; write-write aborts invariant under the feedback; each
aggregator filtering against its own view, aggregator for aggregator;
``advance_views`` view for view; the generators versioning each node's
reads (and YCSB's rewrites) against its own view; a stale view's filter
dropping less.  A view is a device table (``CRDTTable``), joined a whole
committed epoch at a time: the epoch's rows reduced once at the commit
(``top_rows``), then joined into each view (``join_rows``).  The
reference's WAN plane is numpy only: neither side imports JAX here.
"""

import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core import crdt as rcrdt
from repro.core import replication as rrep
from repro.core import strategies as rstrat
from repro.core import whitedata as rwhite
from repro_torch.core import crdt as pcrdt
from repro_torch.core import occ as pocc
from repro_torch.core import replication as prep
from repro_torch.core import strategies as pstrat
from repro_torch.core import whitedata as pwhite
from repro_torch.core import workload as pwl

from test_torch_geo_cluster import check_runs
from test_torch_streaming import run_both, streaming_engines
from test_torch_tpcc import host_form, ref_store_of


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
@pytest.mark.parametrize("strategy", ["flat", "hier", "geococo"])
def test_feedback_run_equals_the_reference(strategy, workload):
    want, got, pe = run_both(workload, sync_strategy=strategy, staleness_feedback=True,
                             bw=20.0, epoch_ms=40.0)
    check_runs(want, got)
    assert [(e.read_aborts, e.view_lag_mean, e.view_lag_max) for e in got.epochs] == \
        [(e.read_aborts, e.view_lag_mean, e.view_lag_max) for e in want.epochs]
    assert got.read_aborts > 0 and max(e.view_lag_max for e in got.epochs) > 0
    # one join a commit into the store; the views' joins apart
    assert pe.store.merges == len(got.epochs) and pe.view_merges > 0
    assert any(t["views_s"] > 0.0 for t in pe.epoch_times)


@pytest.mark.parametrize("epoch_ms", [2.0, 20.0, 2_000.0])
def test_the_abort_curve_equals_the_reference(epoch_ms):
    """``tests/test_staleness.py``'s TPC-C runs at 20 Mbps across the
    regions, at a cadence far below the sync makespan, near it and far
    above it."""
    want, got, pe = run_both("tpcc", staleness_feedback=True, bw=20.0, epoch_ms=epoch_ms,
                             txns=10)
    check_runs(want, got)
    if epoch_ms == 2_000.0:
        # every view fresh at each arrival: nothing stale to read
        assert got.read_aborts == 0 and all(e.view_lag_max == 0 for e in got.epochs)
        assert pe.view_merges == 5 * (len(got.epochs) - 1)
    else:
        assert got.read_aborts > 0


def test_read_abort_rate_falls_with_cadence_and_slack_equals_no_feedback():
    rates = []
    for epoch_ms in (2.0, 20.0, 2_000.0):
        _, rs, _ = run_both("tpcc", staleness_feedback=True, bw=20.0, epoch_ms=epoch_ms)
        rates.append(rs.read_abort_rate)
    assert all(a >= b for a, b in zip(rates, rates[1:])) and rates[0] > rates[-1] == 0.0
    _, slack, _ = run_both("tpcc", staleness_feedback=True, bw=20.0, epoch_ms=2_000.0)
    _, off, _ = run_both("tpcc", bw=20.0, epoch_ms=2_000.0)
    assert (slack.state_digest, slack.value_digest) == (off.state_digest, off.value_digest)


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
def test_feedback_only_adds_read_aborts(workload):
    """The draws never depend on a view (YCSB's rewrite coin falls
    whatever the view holds), so the same transactions run with and without
    the feedback: write-write aborts equal epoch for epoch, the read rule
    only adds aborts."""
    _, off, _ = run_both(workload, bw=20.0, epoch_ms=20.0)
    _, on, _ = run_both(workload, staleness_feedback=True, bw=20.0, epoch_ms=20.0)
    assert on.total_txns == off.total_txns
    for a, b in zip(off.epochs, on.epochs):
        assert b.ww_aborts == a.ww_aborts and a.read_aborts == 0 and b.aborted >= a.aborted
    assert on.read_aborts > 0 and on.committed < off.committed


def test_each_aggregator_filters_against_its_own_view(monkeypatch):
    """A spy filter on each side records the table it is handed: under the
    feedback the port's is the view of the same aggregator, call for call,
    as the reference's (``node_id``); without it, the store."""
    seen_ref, seen_port, views = [], [], []

    def ref_spy(txns, snapshot):
        seen_ref.append(snapshot.node_id)
        return rwhite.filter_group_batch(txns, snapshot)

    def port_spy(batch, snapshot):
        seen_port.append(snapshot)
        return pwhite.filter_group_batch(batch, snapshot)

    rstrat.register("filter", "spy-view", ref_spy)
    pstrat.register("filter", "spy-view", port_spy)
    start = prep.GeoCluster._start_views

    def noting(self):
        out = start(self)
        views.extend(out[0] or ())
        return out

    monkeypatch.setattr(prep.GeoCluster, "_start_views", noting)
    for feedback in (False, True):
        seen_ref.clear()
        seen_port.clear()
        views.clear()
        (re, rg, rt), (pe, pg, pt) = streaming_engines(
            "tpcc", filter_name="spy-view", staleness_feedback=feedback, bw=20.0, epoch_ms=20.0)
        check_runs(re.run(rg, rt, txns_per_node=8, n_epochs=8),
                   pe.run(pg, pt, txns_per_node=8, n_epochs=8))
        assert seen_port and len(seen_port) == len(seen_ref)
        if feedback:
            assert [next(i for i, v in enumerate(views) if v is t) for t in seen_port] == seen_ref
            assert len(set(seen_ref)) > 1
        else:
            assert all(t is pe.store for t in seen_port) and set(seen_ref) == {-1}


def random_epochs(rng, n_epochs: int, table: pcrdt.CRDTTable):
    """Committed epochs of distinct keys each, as host updates and as the
    device rows a view joins."""
    out = []
    for k in range(n_epochs):
        keys = rng.choice(40, size=int(rng.integers(1, 12)), replace=False)
        ups = [rcrdt.Update(f"k{int(key)}", bytes(rng.integers(0, 256, 6, dtype=np.uint8)),
                            rcrdt.Version(k, int(s), int(rng.integers(4))))
               for s, key in enumerate(keys)]
        rows = torch.tensor([table.row_of(u.key) for u in ups])
        vers = torch.tensor([(u.version.epoch, u.version.seq, u.version.node) for u in ups])
        out.append((ups, table.top_rows(rows, table.pack([u.value for u in ups]), vers,
                                        torch.tensor([len(u.value) for u in ups]))))
    return out


def test_advance_views_equals_the_reference():
    rng = np.random.default_rng(4)
    n, n_epochs = 4, 7
    base = pcrdt.CRDTTable(40, 8, device="cpu")
    epochs = random_epochs(rng, n_epochs, base)
    commits = np.maximum.accumulate(rng.uniform(0.0, 30.0, size=(n_epochs, n)) +
                                    np.arange(n_epochs)[:, None] * 10.0, axis=0)
    rviews = [rcrdt.DeltaCRDTStore(i) for i in range(n)]
    pviews = [base.snapshot() for _ in range(n)]
    rnext, pnext = np.zeros(n, dtype=int), np.zeros(n, dtype=int)
    rpend, ppend = {}, {}
    done, apart = 0, False
    for step, now in enumerate(np.linspace(0.0, 110.0, 12)):
        # the epochs committed so far wait for the views
        for k in range(done, min(step, n_epochs)):
            rpend[k], ppend[k] = epochs[k]
        done = min(step, n_epochs)
        rrep.advance_views(n, rviews, rnext, rpend, lambda k, i: float(commits[k, i]), done, now)
        prep.advance_views(n, pviews, pnext, ppend, lambda k, i: float(commits[k, i]), done, now)
        assert np.array_equal(pnext, rnext) and sorted(ppend) == sorted(rpend)
        apart |= len(set(pnext.tolist())) > 1
        for a, b in zip(rviews, pviews):
            assert b.full_state() == {k: (v, pcrdt.Version(*ver.__dict__.values()))
                                      for k, (v, ver) in a.full_state().items()}
    # the views stood at different epochs on the way; at the end every
    # epoch is merged everywhere and released
    assert apart and pnext.min() == n_epochs and not ppend
    assert sum(v.merges for v in pviews) == int(pnext.sum())


def random_updates(rng, n: int, n_keys: int, epochs: int) -> list:
    """Host updates with repeated keys and equal versions."""
    return [rcrdt.Update(f"k{int(rng.integers(n_keys))}",
                         bytes(rng.integers(0, 256, int(rng.integers(1, 9)), dtype=np.uint8)),
                         rcrdt.Version(int(rng.integers(epochs)), int(rng.integers(3)),
                                       int(rng.integers(2))))
            for _ in range(n)]


def device_rows(table: pcrdt.CRDTTable, ups: list) -> tuple:
    return (torch.tensor([table.row_of(u.key) for u in ups]), table.pack([u.value for u in ups]),
            torch.tensor([(u.version.epoch, u.version.seq, u.version.node) for u in ups]),
            torch.tensor([len(u.value) for u in ups]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_reduced_commit_joins_as_its_raw_rows(seed):
    """An epoch's rows reduced once (``top_rows``: distinct rows) and joined
    by ``join_rows`` leave a table as ``merge_rows`` of the raw rows does,
    and as the reference's ``apply_many`` does (repeated keys, equal
    versions, rows the table keeps); the rows taken are those
    ``merge_rows`` counts."""
    rng = np.random.default_rng(seed)
    base = pcrdt.CRDTTable(30, 8, device="cpu")
    rstore = rcrdt.DeltaCRDTStore(0)
    first, batch = random_updates(rng, 20, 30, 3), random_updates(rng, 60, 30, 3)
    base.merge_rows(*device_rows(base, first))
    rstore.apply_many(first)
    rstore.apply_many(batch)
    raw, joined = base.snapshot(), base.snapshot()
    taken = raw.merge_rows(*device_rows(raw, batch))
    reduced = joined.top_rows(*device_rows(joined, batch))
    took = joined.join_rows(*reduced)
    assert reduced[0].unique().numel() == reduced[0].numel() < len(batch)
    assert int(took.sum()) == taken > 0
    for name in ("values", "versions", "lengths", "present"):
        assert torch.equal(getattr(joined, name), getattr(raw, name)), name
    assert joined.full_state() == {k: (v, pcrdt.Version(*ver.__dict__.values()))
                                   for k, (v, ver) in rstore.full_state().items()}


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
def test_generators_version_reads_against_each_nodes_view(workload):
    """``to_batch`` with one table a node: each node's read versions, and
    YCSB's rewrite values, from its own table, as the reference's
    ``epoch_txns`` with a store a node; one table still serves every node."""
    if workload == "ycsb":
        cfg = dict(n_keys=60, theta=0.5, read_ratio=0.5, rewrite_frac=0.5)
        gens = (ref.YCSBGenerator(ref.YCSBConfig(**cfg), 3, seed=1),
                pwl.YCSBGenerator(pwl.YCSBConfig(**cfg), 3, seed=1))
    else:
        cfg = dict(n_warehouses=6, items_per_warehouse=10, mix="TPCC-C")
        gens = (ref.TPCCGenerator(ref.TPCCConfig(**cfg), 3, seed=1),
                pwl.TPCCGenerator(pwl.TPCCConfig(**cfg), 3, seed=1))
    rgen, pgen = gens
    tables = [pgen.table("cpu") for _ in range(3)]
    pgen.load(tables[1], seed=2)           # node 1 holds every key at its load
    pgen.load(tables[2], seed=3)           # node 2 holds every other key, newer
    tables[2].present[::2] = False
    tables[2].versions[::2] = -1
    tables[2].versions[1::2, 0] = 5
    stores = [ref_store_of(t) for t in tables]
    for epoch, snap in ((0, tables), (1, tables[2])):
        want = [t for ts in rgen.epoch_txns(epoch, 12, snapshot=stores if snap is tables
                                            else stores[2]).values() for t in ts]
        got = pgen.epoch_txns(epoch, 12, snap).to_txns(tables[0])
        assert host_form(got) == host_form(want)
    vers = {t.node: {v.epoch for _, v in t.read_set} for t in want}
    assert vers[0] and vers[0] <= {5, -1}


def test_a_stale_view_filters_fewer_updates():
    """A stale view holds smaller versions, so the stale and null rules
    fire less: the filter under-detects white data, it never drops a live
    update.  The reference's case, on device tables."""
    fresh, stale = pcrdt.CRDTTable(4, 4, device="cpu"), pcrdt.CRDTTable(4, 4, device="cpu")
    pcrdt.load_entries(fresh, [("k0", b"x", (2, 5, 0)), ("k1", b"y", (2, 6, 0))])
    txns = [pocc.Txn(0, 1, 1, 9, (), (("k0", b"old"),)),
            pocc.Txn(1, 1, 3, 1, (), (("k1", b"y"),))]
    out = {}
    for name, table in (("fresh", fresh), ("stale", stale)):
        out[name] = pwhite.filter_group_batch(pocc.EpochBatch.from_txns(txns, table), table).stats
        rtable = ref_store_of(table)
        want = rwhite.filter_group_batch(
            [ref.Txn(t.txn_id, t.node, t.epoch, t.seq, t.read_set, t.write_set) for t in txns],
            rtable).stats
        assert out[name].__dict__ == want.__dict__
    assert (out["fresh"].stale_updates, out["fresh"].null_updates) == (1, 1)
    assert (out["stale"].stale_updates, out["stale"].null_updates) == (0, 0)
    assert out["stale"].kept_bytes > out["fresh"].kept_bytes
