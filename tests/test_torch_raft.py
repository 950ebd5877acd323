"""The port's Raft / CockroachDB plane (``repro_torch.core.replication.
RaftCluster``) against the reference's on the CPU, with exact equality:
``tests/test_replication.py``'s Raft cases on both sides (commit latency
and its memo, the event engine against the closed form at infinite
bandwidth and under NIC contention, the pipelined stream against its resim
oracle, throughput with and without bandwidth, at one batch and on
contention-free matrices) and Fig 11b's four payloads
(``benchmarks/bench_throughput.py:102-115``) on ``wan_cluster(9, 30,
seed=11)``, without bandwidth as the benchmark runs them and with the
bandwidth matrix ``wan_cluster`` returns.  The Raft plane is host numpy on
both sides: neither imports JAX here.
"""

import numpy as np
import pytest

import repro.core as ref
from repro_torch.core import latency as plat
from repro_torch.core.replication import RaftCluster

SIDES = (ref.RaftCluster, RaftCluster)


def trace(n, rounds=15, seed=1):
    """``tests/test_replication.py``'s ``_trace`` from the port's latency
    module, checked against the reference's."""
    out = []
    for lib in (ref, plat):
        lat, _ = lib.geo_clustered_matrix(lib.GeoClusterSpec(n_nodes=n, n_clusters=max(2, n // 3)),
                                          np.random.default_rng(seed))
        out.append(lib.jitter_trace(lat, rounds, np.random.default_rng(seed + 1)))
    assert all(np.array_equal(a, b) for a, b in zip(*out))
    return out[1]


def wan_cluster(n, rounds, seed):
    """``benchmarks/common.py``'s ``wan_cluster`` from the port's latency
    module, checked against the reference's."""
    out = []
    for lib in (ref, plat):
        spec = lib.GeoClusterSpec(n_nodes=n, n_clusters=max(2, min(5, n // 3)))
        rng = np.random.default_rng(seed)
        lat, regions = lib.geo_clustered_matrix(spec, rng)
        bw = lib.bandwidth_matrix(regions, n, rng)
        out.append((bw, lib.jitter_trace(lat, rounds, np.random.default_rng(seed + 1))))
    (rbw, rt), (bw, tr) = out
    assert np.array_equal(bw, rbw) and all(np.array_equal(a, b) for a, b in zip(rt, tr))
    return bw, tr


def both(method: str, *args, init=None, **kw):
    """``RaftCluster(**init).method(*args, **kw)`` on both sides, equal."""
    init = init or {}
    want, got = (getattr(cls(**init), method)(*args, **kw) for cls in SIDES)
    assert got == want
    return got


def test_grouping_is_not_slower_and_commits_in_quorum():
    tr = trace(9, 6, seed=11)
    t_flat = both("throughput", tr, payload_bytes=16_000.0,
                  init=dict(n_nodes=9, grouping=False, tiv=False))
    t_geo = both("throughput", tr, payload_bytes=16_000.0,
                 init=dict(n_nodes=9, grouping=True, tiv=True))
    assert t_geo > t_flat * 0.95
    assert 0 < both("commit_latency_ms", tr[0], 0, 16_000.0, init=dict(n_nodes=9)) < 10_000


def test_commit_latency_is_memoized():
    lat = trace(7, 4, seed=13)[0]
    vals = []
    for cls in SIDES:
        geo = cls(7, grouping=True, tiv=True)
        first = geo.commit_latency_ms(lat, 2, 16_000.0)
        assert geo.commit_cache_hits == 0
        assert geo.commit_latency_ms(lat, 2, 16_000.0) == first and geo.commit_cache_hits == 1
        vals.append((first, geo.commit_latency_ms(lat, 3, 16_000.0),
                     geo.commit_latency_ms(lat, 2, 32_000.0)))
        assert geo.commit_cache_hits == 1
    assert vals[1] == vals[0]


@pytest.mark.parametrize("seed", [5, 11, 23])
def test_event_engine_is_the_closed_form_without_contention(seed):
    for grouping, tiv in ((False, False), (True, True), (True, False)):
        init = dict(n_nodes=9, grouping=grouping, tiv=tiv)
        for lat in trace(9, 2, seed=seed):
            for leader in (0, 4):
                ev = both("commit_latency_ms", lat, leader, 16_000.0, init=init)
                cf = both("_closed_form_commit_latency_ms", lat, leader, 16_000.0, init=init)
                assert ev == pytest.approx(cf, rel=1e-9)


def test_event_engine_charges_nic_contention():
    lat = trace(9, 2, seed=11)[0]
    init = dict(n_nodes=9, grouping=False, tiv=False, bandwidth_mbps=50.0)
    ev = both("commit_latency_ms", lat, 0, 256_000.0, init=init)
    assert ev > both("_closed_form_commit_latency_ms", lat, 0, 256_000.0, init=init)


def linear_model(cls, n, tr, *, payload_bytes, batches_in_flight, bandwidth_mbps=np.inf,
                 grouping, tiv):
    """The pre-stream throughput model, ``ops * batches / mean single-batch
    commit``, on the same leader draws (``tests/test_replication.py``'s
    ``_linear_model_throughput``)."""
    rc = cls(n, grouping=grouping, tiv=tiv, bandwidth_mbps=bandwidth_mbps)
    lats = [rc.commit_latency_ms(lat, int(rc.rng.integers(0, n)), payload_bytes) for lat in tr]
    return 100 * batches_in_flight / (float(np.mean(lats)) / 1e3)


def test_throughput_is_not_linear_in_batches_under_bandwidth():
    tr = trace(9, 4, seed=11)
    init = dict(n_nodes=9, grouping=False, tiv=False, bandwidth_mbps=50.0)
    measured = both("throughput", tr, payload_bytes=256_000.0, batches_in_flight=8, init=init)
    linear = linear_model(RaftCluster, 9, tr, payload_bytes=256_000.0, batches_in_flight=8,
                          bandwidth_mbps=50.0, grouping=False, tiv=False)
    assert measured < linear * 0.9
    single = both("throughput", tr, payload_bytes=256_000.0, batches_in_flight=1, init=init)
    assert single <= measured * (1.0 + 1e-9) and measured < single * 8


@pytest.mark.parametrize("batches,payload,seed,cases", [
    (1, 64_000.0, 13, ((False, False, 50.0), (True, True, np.inf))),
    (8, 256_000.0, 17, ((False, False, np.inf), (True, True, np.inf))),
])
def test_throughput_is_the_linear_model_where_nothing_contends(batches, payload, seed, cases):
    """At one batch in flight, or on infinite-bandwidth matrices, the
    stitched stream reduces to the single-batch model."""
    tr = trace(9, 4 if batches == 1 else 3, seed=seed)
    for grouping, tiv, bw in cases:
        init = dict(n_nodes=9, grouping=grouping, tiv=tiv, bandwidth_mbps=bw)
        measured = both("throughput", tr, payload_bytes=payload, batches_in_flight=batches,
                        init=init)
        linear = linear_model(RaftCluster, 9, tr, payload_bytes=payload,
                              batches_in_flight=batches, bandwidth_mbps=bw, grouping=grouping,
                              tiv=tiv)
        assert linear == linear_model(ref.RaftCluster, 9, tr, payload_bytes=payload,
                                      batches_in_flight=batches, bandwidth_mbps=bw,
                                      grouping=grouping, tiv=tiv)
        assert measured == pytest.approx(linear, rel=1e-9)


def test_pipelined_commit_equals_the_resim_oracle():
    lat = trace(7, 2, seed=11)[0]
    for grouping in (False, True):
        for bw in (np.inf, 60.0):
            init = dict(n_nodes=7, grouping=grouping, tiv=grouping, bandwidth_mbps=bw)
            for batches in (2, 4, 9):
                for leader in (0, 3):
                    inc = both("pipelined_commit_ms", lat, leader, 64_000.0, batches, init=init)
                    assert inc == both("_pipelined_commit_ms_resim", lat, leader, 64_000.0,
                                       batches, init=init)


FIG11B = {"YCSB-A": 64_000.0, "YCSB-B": 24_000.0, "YCSB-C": 12_000.0, "YCSB-D": 24_000.0}


@pytest.mark.parametrize("bandwidth", [False, True])
def test_fig11b_equals_the_reference(bandwidth):
    """``bench_throughput.py:102-115``: flat against GeoCoCo's relay over
    four payloads.  The benchmark passes no bandwidth, so its four payloads
    give one gain (+12.0%); with ``wan_cluster``'s own bandwidth matrix
    YCSB-A gains +25.1% and YCSB-C +14.8%."""
    bw, tr = wan_cluster(9, 30, seed=11)
    gains = {}
    for wl, payload in FIG11B.items():
        kw = dict(bandwidth_mbps=bw) if bandwidth else {}
        base = both("throughput", tr, payload_bytes=payload,
                    init=dict(n_nodes=9, grouping=False, tiv=False, **kw))
        geo = both("throughput", tr, payload_bytes=payload,
                   init=dict(n_nodes=9, grouping=True, tiv=True, **kw))
        gains[wl] = (base, geo, round(geo / base - 1.0, 3))
    if bandwidth:
        assert gains["YCSB-A"][2] == 0.251 and gains["YCSB-C"][2] == 0.148
        assert (round(gains["YCSB-A"][0], 2), round(gains["YCSB-A"][1], 2)) == (5541.19, 6933.15)
    else:
        assert len({g for g in gains.values()}) == 1
        assert (round(gains["YCSB-A"][0], 2), round(gains["YCSB-A"][1], 2)) == (7260.67, 8131.76)
        assert gains["YCSB-A"][2] == 0.120
