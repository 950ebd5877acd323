"""The port's read serving plane (``repro_torch.serve``) against the
reference's (``repro.serve``) on the CPU, with exact equality: the cases of
``tests/test_serve.py`` and the serving cases of ``tests/test_sinks.py``,
each run on both sides and held field for field (``ServeStats``' totals,
latency values and weights, per-epoch lists, ``summary()``); the config
rules' messages byte for byte; ``GeoCluster(serve=...)`` on the
incremental and the resim stream, with and without ``staleness_feedback``,
with ``keep_epochs`` on and off, its digests, WAN bytes and times the same
as with serving off.  The reference's serving plane is numpy only: neither
side imports JAX here.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro.serve as rserve
from repro.core.workload import ZipfianSampler as RZipf
from repro_torch import serve as pserve
from repro_torch.analysis import check_config
from repro_torch.core.replication import EngineConfig
from repro_torch.core.workload import ZipfianSampler

from test_torch_geo_cluster import check_runs
from test_torch_streaming import run_both, streaming_engines

LIBS = (rserve, pserve)


def serve_fields(s) -> dict:
    """Every field of a ``ServeStats``, its properties and ``summary()``."""
    return {"epochs": [dataclasses.asdict(e) for e in s.epochs],
            "values": s.latency_values_ms.tolist(), "weights": s.latency_weights.tolist(),
            "wall_ms": s.wall_ms, "bound": s.max_staleness_ms, "policy": s.policy,
            "totals": None if s.totals is None else dataclasses.asdict(s.totals),
            "summary": s.summary(),
            "props": [getattr(s, p) for p in (
                "reads_total", "writes_total", "served_reads", "served_local", "stale_served",
                "redirected", "rejected", "cache_hits", "cache_misses", "redirect_rate",
                "reject_rate", "stale_serve_rate", "cache_hit_rate", "throughput_rps",
                "read_latency_p50_ms", "read_latency_p99_ms")]}


def raises_alike(fn_ref, fn_port, exc):
    """Both calls raise ``exc`` with the same message; returns it."""
    with pytest.raises(exc) as want:
        fn_ref()
    with pytest.raises(exc) as got:
        fn_port()
    assert str(got.value) == str(want.value)
    return str(got.value)


# -- config and wiring --------------------------------------------------------


def test_serve_requires_streaming_as_the_reference():
    msg = raises_alike(lambda: ref.EngineConfig(n_nodes=4, serve=rserve.ServeConfig()),
                       lambda: EngineConfig(n_nodes=4, serve=pserve.ServeConfig()), ValueError)
    assert "streaming" in msg
    cfg = EngineConfig(n_nodes=4, streaming=True, serve=pserve.ServeConfig())
    assert check_config(cfg) == [] and cfg.serve.policy == "redirect"


def test_unknown_policy_fails_fast_as_the_reference():
    msg = raises_alike(lambda: rserve.ServeConfig(policy="nope"),
                       lambda: pserve.ServeConfig(policy="nope"), KeyError)
    assert "serve_policy" in msg


@pytest.mark.parametrize("kw", [
    dict(read_ratio=1.5),
    dict(read_ratio=-0.1),
    dict(max_staleness_ms=-1.0),
    dict(ops_per_client_s=0.0),
    dict(clients_per_node=-5.0),
    dict(clients_per_node=[1.0, -1.0]),
    dict(cache_keys=200, n_keys=100),
    dict(cache_keys=-1),
])
def test_config_rules_as_the_reference(kw):
    raises_alike(lambda: rserve.ServeConfig(**kw), lambda: pserve.ServeConfig(**kw), ValueError)


def test_bounded_run_rule_as_the_reference():
    """``tests/test_sinks.py::test_config_rules_for_bounded_runs``."""
    msg = raises_alike(
        lambda: ref.EngineConfig(n_nodes=3, streaming=True, serve=rserve.ServeConfig(),
                                 keep_epochs=False),
        lambda: EngineConfig(n_nodes=3, streaming=True, serve=pserve.ServeConfig(),
                             keep_epochs=False), ValueError)
    assert "keep_epochs" in msg
    ok = EngineConfig(n_nodes=3, streaming=True, serve=pserve.ServeConfig(keep_epochs=False),
                      keep_epochs=False)
    assert check_config(ok) == []


def test_rule_table_is_the_reference():
    """Every rule of the port's table, in the reference's order, with its
    class, kind and stage: ``EngineConfig``'s and ``ServeConfig``'s."""
    from repro.analysis import config_check as rcheck
    from repro_torch.analysis import config_check as pcheck

    def rows(rules):
        return [(r.name, r.applies_to, r.kind, r.stage) for r in rules]

    assert rows(pcheck.RULES) == rows(rcheck.RULES)
    assert {r.applies_to for r in pcheck.RULES} == {"EngineConfig", "ServeConfig"}


def test_per_node_client_populations_as_the_reference():
    out = []
    for lib in LIBS:
        cfg = lib.ServeConfig(clients_per_node=[1e6, 2e6, 0.0], ops_per_client_s=2.0,
                              read_ratio=0.75)
        out.append((cfg.reads_per_epoch(3, epoch_ms=10.0).tolist(),
                    cfg.writes_per_epoch(3, 10.0).tolist(), cfg.clients(3).tolist()))
    assert out[1] == out[0]
    assert np.allclose(out[1][0], [15_000.0, 30_000.0, 0.0])
    raises_alike(lambda: rserve.ServeConfig(clients_per_node=[1.0, 2.0]).clients(4),
                 lambda: pserve.ServeConfig(clients_per_node=[1.0, 2.0]).clients(4), ValueError)


@pytest.mark.parametrize("values,weights,q", [
    ([1.0, 10.0, 100.0], [98.0, 1.0, 1.0], 50.0),
    ([1.0, 10.0, 100.0], [98.0, 1.0, 1.0], 99.0),
    ([1.0, 10.0, 100.0], [98.0, 1.0, 1.0], 100.0),
    ([], [], 50.0),
    ([3.0, 1.0, 2.0, 5.0], [0.0, 2.5, 1e6, 3.0], 99.9),
])
def test_weighted_percentile_as_the_reference(values, weights, q):
    v, w = np.array(values), np.array(weights)
    assert pserve.weighted_percentile(v, w, q) == rserve.weighted_percentile(v, w, q)


# -- simulate_serving on synthetic commit matrices ----------------------------

# tests/test_serve.py's: node 0 commits at once, node 1 lags ~1 epoch,
# node 2 several: a WAN-backlogged tail
COMMIT = np.array([[1.0, 12.0, 40.0], [11.0, 22.0, 80.0], [21.0, 32.0, 120.0],
                   [31.0, 42.0, 160.0]])
LAT = np.array([[0.0, 20.0, 80.0], [20.0, 0.0, 60.0], [80.0, 60.0, 0.0]])
FRESH = np.array([[1.0, 2.0, 3.0], [11.0, 12.0, 13.0], [21.0, 22.0, 23.0]])


def serve_both(bound, *, policy="redirect", cache_keys=0, epoch_ms=10.0, commit=COMMIT):
    out = []
    for lib in LIBS:
        cfg = lib.ServeConfig(clients_per_node=1e6, max_staleness_ms=bound, policy=policy,
                              cache_keys=cache_keys)
        out.append(lib.simulate_serving(cfg, commit, [LAT] * commit.shape[0], epoch_ms,
                                        wall_ms=commit.max()))
    assert serve_fields(out[1]) == serve_fields(out[0])
    return out[1]


def test_view_staleness_from_commit_matrix_as_the_reference():
    for now in (0.0, 5.0, 30.0, 41.0, 200.0):
        assert pserve.view_epochs(COMMIT, now).tolist() == rserve.view_epochs(COMMIT, now).tolist()
        assert pserve.view_staleness_ms(COMMIT, now, 10.0).tolist() == \
            rserve.view_staleness_ms(COMMIT, now, 10.0).tolist()
    assert pserve.view_epochs(COMMIT, 30.0).tolist() == [3, 2, 0]
    assert pserve.view_epochs(np.array([[5.0]]), 5.0).tolist() == [1]


def test_redirect_routes_to_the_freshest_replica():
    s = serve_both(5.0)
    assert s.rejected == 0.0 and s.redirected == pytest.approx(3 * 2 * 9500.0)
    assert s.served_reads == s.reads_total
    assert s.read_latency_p99_ms > s.read_latency_p50_ms and s.read_latency_p99_ms >= 120.0


def test_redirect_rejects_when_no_replica_is_fresh_enough():
    s = serve_both(0.0, commit=COMMIT + 1000.0)
    assert s.epochs[0].rejected == 0.0
    assert all(e.rejected == e.reads > 0 for e in s.epochs[1:])
    assert s.rejected == s.redirected


def test_reject_policy_never_redirects():
    s = serve_both(5.0, policy="reject")
    assert s.redirected == 0.0 and s.rejected == pytest.approx(3 * 2 * 9500.0)
    assert s.read_latency_p99_ms == pytest.approx(pserve.ServeConfig().local_read_ms)


def test_zero_bound_zero_lag_serves_everything_locally():
    s = serve_both(0.0, commit=FRESH)
    assert s.redirected == s.rejected == s.stale_served == 0.0
    assert s.served_local == s.reads_total == s.served_reads


def test_cache_hit_rate_is_the_zipf_top_mass_as_the_reference():
    s = serve_both(1e9, cache_keys=100)
    cfg = pserve.ServeConfig()
    for k in (0, 1, 100, cfg.n_keys, cfg.n_keys + 5):
        a = RZipf(cfg.n_keys, cfg.zipf_theta, np.random.default_rng(0)).top_mass(k)
        assert ZipfianSampler(cfg.n_keys, cfg.zipf_theta, np.random.default_rng(0)).top_mass(k) == a
    assert s.cache_hit_rate == pytest.approx(
        ZipfianSampler(cfg.n_keys, cfg.zipf_theta, np.random.default_rng(0)).top_mass(100))
    assert s.read_latency_p50_ms == cfg.cache_hit_ms
    assert serve_both(1e9).read_latency_p50_ms == cfg.local_read_ms


@pytest.mark.parametrize("policy", ["redirect", "reject"])
def test_bound_monotonicity_exact(policy):
    runs = [serve_both(b, policy=policy) for b in (0.0, 5.0, 10.0, 15.0, 25.0, 40.0, 1e9)]
    for a, b in zip(runs, runs[1:]):
        assert b.served_reads >= a.served_reads and b.stale_served >= a.stale_served
        assert b.redirected <= a.redirected and b.rejected <= a.rejected
    for r in runs:
        assert r.served_reads + r.rejected == pytest.approx(r.reads_total)


# -- ServingSink (tests/test_sinks.py) ----------------------------------------


@pytest.mark.parametrize("seed,epochs", [(0, 1), (1, 4), (2, 7), (3, 12), (4, 9), (5, 2)])
def test_serving_sink_matches_batch_replay_and_the_reference(seed, epochs):
    rng = np.random.default_rng(seed)
    n, epoch_ms = 3, 2.0
    commit = np.cumsum(rng.uniform(0.0, 2.5 * epoch_ms, size=(epochs, n)), axis=0)
    lats = [rng.uniform(1.0, 30.0, size=(n, n)) for _ in range(epochs)]
    out = []
    for lib in LIBS:
        cfg = lib.ServeConfig(clients_per_node=10_000.0, max_staleness_ms=5.0, cache_keys=20)
        batch = lib.simulate_serving(cfg, commit, lats, epoch_ms, wall_ms=epochs * epoch_ms)
        sink = lib.ServingSink(cfg, n, epoch_ms)
        for e in range(epochs):
            sink.push(e, commit[e], lats[e])
        inc = sink.finish(wall_ms=epochs * epoch_ms)
        assert serve_fields(inc) == serve_fields(batch)
        out.append(inc)
    assert serve_fields(out[1]) == serve_fields(out[0])
    # prefix sufficiency: the sink, which saw rows [0, e] only, equals the
    # batch form over the whole matrix
    for e, se in enumerate(out[1].epochs):
        full = pserve.view_staleness_ms(commit, e * epoch_ms, epoch_ms)
        assert (se.view_staleness_ms_mean, se.view_staleness_ms_max) == \
            (float(full.mean()), float(full.max()))


def test_serving_sink_refusals_as_the_reference():
    sinks = [lib.ServingSink(lib.ServeConfig(clients_per_node=1_000.0), 2, 1.0) for lib in LIBS]
    for s in sinks:
        s.push(0, np.zeros(2), np.zeros((2, 2)))
    for e in (0, 2):
        raises_alike(lambda: sinks[0].push(e, np.zeros(2), np.zeros((2, 2))),
                     lambda: sinks[1].push(e, np.zeros(2), np.zeros((2, 2))), ValueError)
    fresh = [lib.ServingSink(lib.ServeConfig(clients_per_node=1_000.0), 2, 1.0) for lib in LIBS]
    raises_alike(lambda: fresh[0].on_epoch(None, None), lambda: fresh[1].on_epoch(None, None),
                 ValueError)


# -- the engine ---------------------------------------------------------------

SERVE = dict(clients_per_node=1e6, max_staleness_ms=50.0, cache_keys=100)


def serve_run(serve, **kw):
    """``tests/test_serve.py``'s ``_run_engine`` on both sides: TPC-C, five
    nodes, 20 Mbps across the regions, 8 epochs of 10 transactions a node."""
    kw = dict(dict(bw=20.0, epoch_ms=2.0, txns=10), **kw)
    want, got, pe = run_both("tpcc", serve=serve, **kw)
    check_runs(dataclasses.replace(want, serve=None), dataclasses.replace(got, serve=None))
    if serve is None:
        assert got.serve is want.serve is None
    else:
        assert serve_fields(got.serve) == serve_fields(want.serve)
    return got


def test_engine_serves_and_stays_digest_neutral():
    off = serve_run(None)
    on = serve_run(SERVE)
    assert on.serve.reads_total > 0 and len(on.serve.epochs) == 8
    assert (on.state_digest, on.value_digest, on.committed, on.wan_bytes) == \
        (off.state_digest, off.value_digest, off.committed, off.wan_bytes)
    assert [e.wall_ms for e in on.epochs] == [e.wall_ms for e in off.epochs]


def test_engine_serves_under_staleness_feedback():
    rs = serve_run(dict(clients_per_node=1e6, max_staleness_ms=50.0), staleness_feedback=True)
    s = rs.serve
    assert s.stale_served + s.redirected + s.rejected > 0
    assert max(e.view_staleness_ms_max for e in s.epochs) > 0
    off = serve_run(None, staleness_feedback=True)
    assert (rs.state_digest, rs.read_aborts) == (off.state_digest, off.read_aborts)


def test_engine_slack_cadence_serves_fresh():
    s = serve_run(dict(clients_per_node=1e6, max_staleness_ms=0.0), epoch_ms=2_000.0).serve
    assert s.redirected == s.rejected == s.stale_served == 0.0
    assert s.served_local == s.reads_total


def test_non_streaming_engines_never_serve():
    (re, rg, rt), (pe, pg, pt) = streaming_engines("tpcc", streaming=False, bw=20.0)
    want = re.run(rg, rt, txns_per_node=10, n_epochs=8)
    got = pe.run(pg, pt, txns_per_node=10, n_epochs=8)
    check_runs(want, got)


@pytest.mark.parametrize("feedback", [False, True])
def test_incremental_serves_as_resim(feedback):
    """The incremental stream's ``ServingSink`` against the resim oracle's
    ``simulate_serving`` over its whole commit matrix, each against the
    reference's same mode."""
    runs = [serve_run(SERVE, stream_mode=mode, staleness_feedback=feedback, bw=20.0,
                      epoch_ms=40.0) for mode in ("incremental", "resim")]
    assert serve_fields(runs[0].serve) == serve_fields(runs[1].serve)
    assert runs[0].serve.redirected + runs[0].serve.stale_served > 0


@pytest.mark.parametrize("stream_mode", ["incremental", "resim"])
@pytest.mark.parametrize("feedback,window", [(False, 1), (True, 2)])
def test_bounded_run_serves_as_the_retained_one(feedback, stream_mode, window):
    """``tests/test_sinks.py::test_bounded_run_equivalent_to_retained`` on
    both sides: with ``keep_epochs=False`` (both configs) the serving
    plane's totals, latency classes and ``summary()`` equal the retained
    run's, and its per-epoch list is empty."""
    serve = dict(clients_per_node=50_000.0, max_staleness_ms=6.0, cache_keys=50)
    common = dict(staleness_feedback=feedback, stream_mode=stream_mode, epochs=6, txns=4)
    retained = serve_run(dict(serve, keep_epochs=True), **common)
    bounded = serve_run(dict(serve, keep_epochs=False), keep_epochs=False,
                        stats_window=window, **common)
    b, r = serve_fields(bounded.serve), serve_fields(retained.serve)
    assert b.pop("epochs") == [] and len(r.pop("epochs")) == 6
    assert b == r
    assert bounded.summary == retained.summary
    assert bounded.epochs == retained.epochs[len(retained.epochs) - window:]
