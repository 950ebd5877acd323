"""Fig 16 (``benchmarks/bench_compression.py`` in quick mode) on the port
against the reference on the CPU: baseline, zlib, GeoCoCo and
GeoCoCo+zlib, every ``EpochStats`` field and the digest equal, and the
four normalized makespans 1.0 / 0.99005 / 0.47124 / 0.46476, as the
reference's.  The reference's WAN plane is numpy only: neither side
imports JAX here.
"""

import dataclasses

import numpy as np

import repro.core as ref
from repro_torch.core import latency as plat
from repro_torch.core.replication import EngineConfig, GeoCluster
from repro_torch.core.workload import YCSBConfig, YCSBGenerator

FIG16 = {
    "baseline": dict(grouping=False, filtering=False, tiv=False),
    "zlib": dict(grouping=False, filtering=False, tiv=False, compression=True),
    "geococo": dict(grouping=True, filtering=True),
    "geococo+zlib": dict(grouping=True, filtering=True, compression=True),
}


def fig16_run(lib, regions, trace, *, grouping, filtering, tiv=True, compression=False):
    """``benchmarks/common.py``'s ``run_engine`` at Fig 16's quick settings:
    8 nodes, 40 Mbps WAN under a 10 Gbps LAN, YCSB over 20,000 keys
    (theta 0.7, hot writes 0.35, rewrites 0.10, 100-byte values), 15
    transactions a node, MILP, modeled CPU."""
    n = 8
    cfg = dict(n_nodes=n, grouping=grouping, filtering=filtering, tiv=tiv,
               compression=compression, planner="milp", modeled_cpu=True)
    wan = regions[:, None] != regions[None, :]
    bw = np.where(wan, 40.0, 10_000.0)
    np.fill_diagonal(bw, np.inf)
    ycsb = dict(n_keys=20_000, theta=0.7, read_ratio=0.5, hot_write_frac=0.35, hot_locality=True,
                rewrite_frac=0.10, value_bytes=100)
    if lib is ref:
        eng = ref.GeoCluster(ref.EngineConfig(**cfg), bandwidth_mbps=bw, wan_mask=wan, seed=7)
        gen = ref.YCSBGenerator(ref.YCSBConfig(**ycsb), n, seed=8, node_region=regions)
    else:
        eng = GeoCluster(EngineConfig(**cfg), bandwidth_mbps=bw, wan_mask=wan, seed=7,
                         device="cpu")
        gen = YCSBGenerator(YCSBConfig(**ycsb), n, seed=8, node_region=regions)
    return eng.run(gen, trace, txns_per_node=15)


def test_fig16_normalized_makespans_equal_the_reference():
    spec = plat.GeoClusterSpec(n_nodes=8, n_clusters=2)
    rng = np.random.default_rng(41)
    lat, regions = plat.geo_clustered_matrix(spec, rng)
    plat.bandwidth_matrix(regions, 8, rng)      # wan_cluster's draw, as it makes it
    trace = plat.jitter_trace(lat, 20, np.random.default_rng(42))
    runs = {}
    for name, kw in FIG16.items():
        want = fig16_run(ref, np.asarray(regions), trace, **kw)
        got = fig16_run(plat, np.asarray(regions), trace, **kw)
        for a, b in zip(want.epochs, got.epochs):
            assert dataclasses.asdict(b) == dataclasses.asdict(a)
        assert got.state_digest == want.state_digest
        runs[name] = got
    base = runs["baseline"].makespans_ms.mean()
    norm = {k: float(v.makespans_ms.mean() / base) for k, v in runs.items()}
    assert {k: round(v, 5) for k, v in norm.items()} == \
        {"baseline": 1.0, "zlib": 0.99005, "geococo": 0.47124, "geococo+zlib": 0.46476}
    assert len({r.state_digest for r in runs.values()}) == 1
    assert norm["geococo+zlib"] <= min(norm["zlib"], norm["geococo"])
