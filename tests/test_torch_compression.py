"""The port's WAN compression (``EngineConfig(compression=True)``,
``sync_strategy="geococo-zlib"``) against the reference's on the CPU, with
exact equality: the records' stream built by ``CRDTTable.record_bytes``
equal to a host ``b"".join(key + value)`` of the same updates (YCSB's,
the hot set's and TPC-C's key families, every value length); each node's
and each group's compressed size equal to the reference's
``_compressed_size``; runs field for field (WAN bytes, modeled makespans,
every ``EpochStats`` field, both digests) with the node and group payloads
the schedule builders are handed, under flat, hier and geococo, the event
and barrier engines, streaming and with per-node views, on YCSB and TPC-C;
measured compression CPU charged to the groups.  Fig 16 is in
``test_torch_compression_fig16.py``.  The reference's WAN plane is numpy
only: neither side imports JAX here.
"""

import zlib

import numpy as np
import pytest
import torch

from repro.core import replication as rrep
from repro_torch.core import strategies as pstrat
from repro_torch.core.crdt import CRDTTable
from repro_torch.core.replication import EngineConfig, GeoCluster
from repro_torch.core.workload import YCSBConfig, YCSBGenerator

from test_torch_geo_cluster import check_runs
from test_torch_streaming import streaming_engines

TABLES = {
    "ycsb": dict(n_keys=1200, value_bytes=100, n_regions=3, hot_set_size=16),
    "tpcc": dict(n_keys=0, value_bytes=120, n_warehouses=12, items_per_warehouse=1000),
    "mixed": dict(n_keys=10, value_bytes=7, n_regions=11, hot_set_size=3, n_warehouses=2,
                  items_per_warehouse=5),
}


@pytest.mark.parametrize("layout", sorted(TABLES))
def test_record_stream_is_the_host_join(layout):
    """Each record's key bytes and its value's bytes cut to its length, in
    the records' order, rows repeated, lengths 0 to ``value_bytes``."""
    table = CRDTTable(**TABLES[layout], device="cpu")
    rng = np.random.default_rng(3)
    n = 400
    rows = torch.from_numpy(rng.integers(0, table.n_rows, n))
    lens = torch.from_numpy(rng.integers(0, table.value_bytes + 1, n))
    vals = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8)) for k in lens]
    stream, reclen = table.record_bytes(rows, table.pack(vals), lens)
    want = [table.key_of(r).encode() + v for r, v in zip(rows.tolist(), vals)]
    assert stream.dtype == torch.uint8 and stream.numpy().tobytes() == b"".join(want)
    assert reclen.tolist() == [len(w) for w in want]
    empty, none = table.record_bytes(rows[:0], table.pack([]), lens[:0])
    assert empty.numel() == none.numel() == 0


def test_compressed_sizes_equal_the_reference():
    """A YCSB epoch's batch: each node's payload, and each group's kept
    updates (members in the group's order, each member's in batch order),
    sized as the reference's ``_compressed_size`` at its level 6, cut from
    one stream; zlib's bytes in are the parts' joins, and its bytes out
    their sizes less 24 a record."""
    gen = YCSBGenerator(YCSBConfig(n_keys=3000, theta=0.9, read_ratio=0.3, rewrite_frac=0.2,
                                   value_bytes=300, hot_locality=True), 5, seed=5,
                        node_region=np.array([0, 0, 1, 1, 2]))
    table = gen.table("cpu")
    gen.load(table, seed=2)
    batch = gen.to_batch(gen.draw(0, 30), table)
    ups = batch.updates(table)
    node = batch.node[batch.write_txn].tolist()
    eng = GeoCluster(EngineConfig(n_nodes=5, compression=True), device="cpu")
    eng.store = table
    groups = [[3, 1], [2], [0, 4], []]
    members = [[u for i in g for u, k in zip(ups, node) if k == i] for g in groups]
    rng = np.random.default_rng(7)
    masks = [rng.random(len(m)) < 0.6 for m in members]
    masks[1][:] = False
    kept = [[u for u, m in zip(ms, mask) if m] for ms, mask in zip(members, masks)]
    got, sizes, nbytes, secs = eng._compressed_payloads(
        batch, groups, [torch.from_numpy(m) for m in masks])
    parts = [[u for u, k in zip(ups, node) if k == i] for i in range(5)]
    assert got.tolist() == [rrep._compressed_size(p, 6) for p in parts]
    assert sizes == [rrep._compressed_size(p, 6) for p in kept] and sizes[1] == sizes[3] == 0
    assert nbytes == [sum(u.nbytes for u in p) for p in kept]
    assert len(secs) == len(groups) and all(t >= 0 for t in secs)
    # zlib's input is the stream as the reference joins it
    blobs = [b"".join(u.key.encode() + u.value for u in p) for p in parts + kept]
    assert eng._zlib["stream_bytes"] == sum(map(len, blobs[:5]))
    assert eng._zlib["zlib_in_bytes"] == sum(map(len, blobs))
    assert eng._zlib["zlib_out_bytes"] == sum(len(zlib.compress(b, 6)) for b in blobs if b)


def spy_payloads(eng) -> list:
    """Wrap the engine's schedule builders: each call's node payloads and
    group payloads (and group CPU) are noted."""
    seen, grouped, flat = [], eng._schedule_fn, eng._flat_schedule_fn

    def grouped_spy(plan, node_payload, **kw):
        seen.append((np.asarray(node_payload).tolist(),
                     np.asarray(kw["group_payload_bytes"]).tolist(),
                     np.asarray(kw.get("group_compute_ms", [])).tolist()))
        return grouped(plan, node_payload, **kw)

    def flat_spy(n, payload):
        seen.append((np.asarray(payload).tolist(),))
        return flat(n, payload)

    eng._schedule_fn, eng._flat_schedule_fn = grouped_spy, flat_spy
    return seen


STRATEGIES = {
    "flat": dict(sync_strategy=None, grouping=False, filtering=False, tiv=False,
                 compression=True),
    "hier": dict(sync_strategy=None, grouping=True, filtering=False, tiv=False,
                 compression=True),
    "geococo-zlib": dict(sync_strategy="geococo-zlib"),
}


def run_pair(workload: str, **kw):
    (re, rg, rt), (pe, pg, pt) = streaming_engines(workload, **kw)
    seen = [spy_payloads(re), spy_payloads(pe)]
    want = re.run(rg, rt, txns_per_node=8, n_epochs=8)
    got = pe.run(pg, pt, txns_per_node=8, n_epochs=8)
    check_runs(want, got)
    assert seen[1] == seen[0] and len(seen[1]) == 8
    return want, got, pe


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
@pytest.mark.parametrize("strategy,engine", [(s, "event") for s in sorted(STRATEGIES)]
                         + [("geococo-zlib", "barrier")])
def test_compressed_run_equals_the_reference(strategy, engine, workload):
    _, got, pe = run_pair(workload, streaming=False, barrier=engine == "barrier", bw=20.0,
                          **STRATEGIES[strategy])
    assert pe.cfg.compression and pe.cfg.resolved_sync_strategy == \
        pstrat.wan_strategy_name(grouping=pe.cfg.grouping, filtering=pe.cfg.filtering,
                                 tiv=pe.cfg.tiv, compression=True)
    parts = ("copy_s", "device_s", "draw_s", "host_s", "stream_bytes", "stream_copy_s",
             "stream_s", "zlib_in_bytes", "zlib_out_bytes", "zlib_s")
    assert [sorted(t) for t in pe.epoch_times] == [list(parts)] * 8


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
@pytest.mark.parametrize("feedback", [False, True])
def test_compressed_streaming_run_equals_the_reference(workload, feedback):
    """The streaming engine, and per-node views: the compressed payloads
    ride the stitched stream, each aggregator filtering against its own
    view."""
    _, got, pe = run_pair(workload, sync_strategy="geococo-zlib", staleness_feedback=feedback,
                          bw=20.0, epoch_ms=40.0)
    if feedback:
        assert got.read_aborts > 0 and pe.view_merges > 0


def test_measured_compression_cpu_is_charged_to_the_groups():
    """Measured CPU: each group's compression wall (its cut and zlib, and
    the share of its kept bytes in the stream's build and copy) is charged
    on its exchange edges, as the filter's is; the epoch's split holds the
    three parts."""
    (_, _, _), (pe, pg, pt) = streaming_engines("ycsb", streaming=False,
                                                sync_strategy="geococo-zlib", modeled_cpu=False)
    seen = spy_payloads(pe)
    pe.run(pg, pt, txns_per_node=8, n_epochs=3)
    for t in pe.epoch_times:
        assert t["stream_s"] > 0 and t["stream_copy_s"] >= 0 and t["zlib_s"] > 0
        assert t["host_s"] >= 0
    assert all(sum(cpu) > 0 for _, _, cpu in seen)
