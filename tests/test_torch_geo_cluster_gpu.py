"""The WAN sync plane on the card against its CPU run: the same seeded YCSB
epochs through ``GeoCluster`` on ``cuda`` and on the CPU give every
``EpochStats`` field, the message matrix and both digests equal, for
``flat``, ``hier`` and ``geococo`` under both engines (and TPC-C epochs from
a loaded store under ``flat`` and ``geococo``), with every commit
joined through the CUDA join kernel (``crdt_join_rows``); a streaming run
with per-node views (``staleness_feedback``, both stream modes), each view
joining its epochs through the same kernel, and with the serving plane on
(``ServeStats`` field for field); ``geococo-zlib`` and flat with
compression (the records' stream built on the card equal to the CPU's and
to a host join); the store's join, the validation and the filter alone on
random batches, card against CPU.

The merge kernel has no CPU or interpret mode, so these tests skip without
a card; each decides that when it runs.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_geo_cluster_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import crdt, occ, whitedata
from repro_torch.core.latency import jitter_trace
from repro_torch.core.replication import EngineConfig, GeoCluster
from repro_torch.core.workload import YCSBConfig, YCSBGenerator
from repro_torch.kernels.crdt_merge import ops as merge_ops

BASE = np.array([[0.0, 1.5, 8.0, 8.5, 42.0], [1.5, 0.0, 8.2, 8.0, 43.0],
                 [8.0, 8.2, 0.0, 1.8, 38.0], [8.5, 8.0, 1.8, 0.0, 39.0],
                 [42.0, 43.0, 38.0, 39.0, 0.0]])
REGIONS = np.array([0, 0, 1, 1, 2])
YCSB = dict(n_keys=20_000, theta=0.99, read_ratio=0.5, rewrite_frac=0.1, value_bytes=1000,
            hot_write_frac=0.1, hot_locality=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the merge kernel has no CPU or interpret mode")
    return torch.device("cuda")


def run(device, strategy: str, barrier: bool, epochs: int = 4):
    eng = GeoCluster(EngineConfig(n_nodes=5, sync_strategy=strategy, planner="kcenter",
                                  barrier=barrier, modeled_cpu=True),
                     bandwidth_mbps=120.0, seed=3, device=device)
    gen = YCSBGenerator(YCSBConfig(**YCSB), 5, seed=5, node_region=REGIONS)
    trace = jitter_trace(BASE, epochs, np.random.default_rng(0))
    return eng, eng.run(gen, trace, txns_per_node=200)


@pytest.mark.gpu
@pytest.mark.parametrize("barrier", [False, True])
@pytest.mark.parametrize("strategy", ["flat", "hier", "geococo"])
def test_cluster_on_the_card_equals_its_cpu_run(card, strategy, barrier):
    before = merge_ops.crdt_join_rows.launches
    eng, got = run(card, strategy, barrier)
    launches = merge_ops.crdt_join_rows.launches - before
    _, want = run("cpu", strategy, barrier)
    for a, b in zip(want.epochs, got.epochs):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.epoch
    assert (got.state_digest, got.value_digest) == (want.state_digest, want.value_digest)
    assert np.array_equal(got.msg_matrix, want.msg_matrix)
    assert launches == eng.store.merges == len(got.epochs)


def random_batch(table, rng, n_txns=400, n_keys=300):
    txns = []
    for tid in range(n_txns):
        node = int(rng.integers(5))
        ws = {f"k{int(rng.integers(n_keys))}": bytes([int(rng.integers(4))]) * table.value_bytes
              for _ in range(int(rng.integers(4)))}
        rs = tuple((f"k{int(rng.integers(n_keys))}",
                    crdt.Version(int(rng.integers(3)), int(rng.integers(50)), node))
                   for _ in range(int(rng.integers(3))))
        txns.append(occ.Txn(tid, node, 1 + int(rng.integers(2)), int(rng.integers(50)), rs,
                            tuple(ws.items())))
    return txns


@pytest.mark.gpu
def test_join_validation_and_filter_on_the_card(card):
    rng = np.random.default_rng(0)
    tables = {d: crdt.CRDTTable(300, 64, device=d) for d in ("cpu", card)}
    base = random_batch(tables["cpu"], rng)
    for table in tables.values():
        b = occ.EpochBatch.from_txns(base, table)
        table.merge_rows(b.write_row, b.write_val, b.versions()[b.write_txn])
    assert tables[card].digest() == tables["cpu"].digest()
    txns = random_batch(tables["cpu"], rng)
    out = {}
    for dev, table in tables.items():
        b = occ.EpochBatch.from_txns(txns, table)
        v = occ.validate_epoch_detailed(b, table)
        f = whitedata.filter_group_batch(b, table, enable_abort=False)
        out[dev] = (v.committed, v.read_aborted, v.ww_aborted, dataclasses.asdict(f.stats),
                    f.kept.cpu().tolist(), f.null.cpu().tolist())
    assert out[card] == out["cpu"]
    assert out["cpu"][1] and out["cpu"][3]["duplicate_updates"] and out["cpu"][3]["stale_updates"]


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["flat", "geococo"])
def test_tpcc_from_a_loaded_store_on_the_card_equals_its_cpu_run(card, strategy):
    from repro_torch.core.workload import TPCCConfig, TPCCGenerator

    out = {}
    for device in (card, "cpu"):
        eng = GeoCluster(EngineConfig(n_nodes=5, sync_strategy=strategy, planner="kcenter",
                                      modeled_cpu=True),
                         bandwidth_mbps=120.0, seed=3, device=device)
        gen = TPCCGenerator(TPCCConfig(n_warehouses=100, items_per_warehouse=2000,
                                       mix="TPCC-A"), 5, seed=3)
        eng.store = gen.table(device)
        gen.load(eng.store, seed=5)
        before = merge_ops.crdt_join_rows.launches
        rs = eng.run(gen, jitter_trace(BASE, 4, np.random.default_rng(0)), txns_per_node=200)
        out[str(device)] = ([dataclasses.asdict(e) for e in rs.epochs], rs.state_digest,
                            rs.value_digest, rs.msg_matrix.tolist(), gen.neworder_count,
                            merge_ops.crdt_join_rows.launches - before)
    got, want = out[str(card)], out["cpu"]
    assert got[:5] == want[:5]
    assert got[5] == 4


def feedback_run(device, mode: str, **cfg):
    """A small streaming run with per-node views (``staleness_feedback``)
    from a loaded YCSB store, on two clusters joined at 120 Mbps, at a
    cadence that lets the views lag; ``cfg``: more engine settings."""
    from repro_torch.core.latency import GeoClusterSpec, geo_clustered_matrix

    lat, regions = geo_clustered_matrix(GeoClusterSpec(n_nodes=5, n_clusters=2),
                                        np.random.default_rng(1))
    wan = np.asarray(regions)[:, None] != np.asarray(regions)[None, :]
    bw = np.where(wan, 120.0, 10_000.0)
    np.fill_diagonal(bw, np.inf)
    cfg = dict(dict(sync_strategy="geococo"), **cfg)
    eng = GeoCluster(EngineConfig(n_nodes=5, planner="kcenter", streaming=True,
                                  staleness_feedback=True, epoch_ms=40.0, modeled_cpu=True,
                                  stream_mode=mode, **cfg),
                     bandwidth_mbps=bw, wan_mask=wan, seed=7, device=device)
    gen = YCSBGenerator(YCSBConfig(**YCSB), 5, seed=5, node_region=regions)
    eng.store = gen.table(device)
    gen.load(eng.store, seed=5)
    rs = eng.run(gen, jitter_trace(lat, 6, np.random.default_rng(2)), txns_per_node=200)
    return eng, rs


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["incremental", "resim"])
def test_feedback_run_on_the_card_equals_its_cpu_run(card, mode):
    before = merge_ops.crdt_join_rows.launches
    eng, got = feedback_run(card, mode)
    launches = merge_ops.crdt_join_rows.launches - before
    cpu, want = feedback_run("cpu", mode)
    for a, b in zip(want.epochs, got.epochs):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.epoch
    assert (got.state_digest, got.value_digest) == (want.state_digest, want.value_digest)
    assert np.array_equal(got.msg_matrix, want.msg_matrix)
    assert eng.view_merges == cpu.view_merges > 0 and got.read_aborts > 0
    # one join a commit, one a view and epoch merged
    assert launches == eng.store.merges + eng.view_merges == len(got.epochs) + eng.view_merges


def serve_fields(s) -> tuple:
    return ([dataclasses.asdict(e) for e in s.epochs], dataclasses.asdict(s.totals),
            s.latency_values_ms.tolist(), s.latency_weights.tolist(), s.wall_ms, s.summary())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["incremental", "resim"])
def test_serving_run_on_the_card_equals_its_cpu_run(card, mode):
    """The serving plane over the card's views: its report equal to the CPU
    run's, and the run's the same as without serving."""
    from repro_torch.serve import ServeConfig

    serve = ServeConfig(clients_per_node=1e6, max_staleness_ms=50.0, cache_keys=200,
                        n_keys=YCSB["n_keys"])
    _, got = feedback_run(card, mode, serve=serve)
    _, want = feedback_run("cpu", mode, serve=serve)
    _, off = feedback_run(card, mode)
    assert serve_fields(got.serve) == serve_fields(want.serve)
    assert got.serve.reads_total > 0 and got.serve.redirected + got.serve.stale_served > 0
    for a, b in zip(off.epochs, got.epochs):
        assert dataclasses.asdict(b) == dataclasses.asdict(a), a.epoch
    assert (got.state_digest, got.value_digest) == (off.state_digest, off.value_digest)


@pytest.mark.gpu
def test_record_stream_on_the_card_is_the_cpu_one(card):
    rng = np.random.default_rng(1)
    table = crdt.CRDTTable(1000, 120, n_regions=3, n_warehouses=4, items_per_warehouse=50,
                           device="cpu")
    rows = torch.from_numpy(rng.integers(0, table.n_rows, 3000))
    lens = torch.from_numpy(rng.integers(0, 121, 3000))
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (3000, table.words), dtype=np.int32))
    out = []
    for dev in ("cpu", card):
        t = crdt.CRDTTable(**table.layout(), device=dev)
        stream, reclen = t.record_bytes(rows.to(dev), vals.to(dev), lens.to(dev))
        out.append((stream.cpu().numpy().tobytes(), reclen.tolist()))
    assert out[1] == out[0]
    host = [table.key_of(r).encode() + v for r, v in
            zip(rows.tolist(), table.unpack(vals, lens))]
    assert out[1][0] == b"".join(host)


@pytest.mark.gpu
@pytest.mark.parametrize("strategy", ["flat", "geococo-zlib"])
def test_compressed_run_on_the_card_equals_its_cpu_run(card, strategy):
    """WAN payloads compressed from streams built on the card: every field
    of the run, the WAN bytes and both digests as the CPU's, in the formula
    engine and streamed with views."""
    cfg = dict(sync_strategy="geococo-zlib") if strategy != "flat" else \
        dict(sync_strategy=None, grouping=False, filtering=False, tiv=False, compression=True)
    for streamed in (False, True):
        out = []
        for device in (card, "cpu"):
            if streamed:
                eng, rs = feedback_run(device, "incremental", **cfg)
            else:
                eng = GeoCluster(EngineConfig(n_nodes=5, planner="kcenter", modeled_cpu=True,
                                              **cfg),
                                 bandwidth_mbps=120.0, seed=3, device=device)
                gen = YCSBGenerator(YCSBConfig(**YCSB), 5, seed=5, node_region=REGIONS)
                rs = eng.run(gen, jitter_trace(BASE, 4, np.random.default_rng(0)),
                             txns_per_node=200)
            out.append(([dataclasses.asdict(e) for e in rs.epochs], rs.state_digest,
                         rs.value_digest, rs.msg_matrix.tolist(), rs.wan_bytes))
            assert all(t["stream_s"] > 0 for t in eng.epoch_times)
        assert out[0] == out[1]
