"""The port's replication engine (``repro_torch.core.replication``) against
the reference's ``GeoCluster`` on the CPU: ``run`` field for field (every
``EpochStats`` field, ``FilterStats``, the run's totals, the message matrix
and both digests; integers and digests exact, the simulator's floats
exact) for ``flat``, ``hier`` and ``geococo`` under the event and barrier
engines, with ``kcenter`` and ``modeled_cpu``; a WAN mask and a bounded
stats window; the aggregator failover at mid-run (the second run restarts
its epochs, so the stale rule fires); the config's rule table; the flag
once refused (``verify_schedules``, W7) accepted; the device default; the example at
a small size; reference fault 15 (views that start empty on a loaded store)
not copied.
The serving plane, compression and the Raft plane have their own files
(``test_torch_serve*.py``, ``test_torch_compression*.py``,
``test_torch_raft.py``).
The reference's engine is numpy only: neither side imports JAX here.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as ref
from repro_torch.core import latency as plat
from repro_torch.core import planner as pplan
from repro_torch.core import strategies as pstrat
from repro_torch.core.replication import EngineConfig, GeoCluster
from repro_torch.core.workload import YCSBConfig, YCSBGenerator

REPO = Path(__file__).resolve().parents[1]
BASE = np.array([[0.0, 1.5, 8.0, 8.5, 42.0], [1.5, 0.0, 8.2, 8.0, 43.0],
                 [8.0, 8.2, 0.0, 1.8, 38.0], [8.5, 8.0, 1.8, 0.0, 39.0],
                 [42.0, 43.0, 38.0, 39.0, 0.0]])
REGIONS = np.array([0, 0, 1, 1, 2])
YCSB = dict(n_keys=400, theta=0.9, read_ratio=0.3, hot_write_frac=0.3, rewrite_frac=0.2,
            hot_locality=True)


def engines(strategy: str, barrier: bool, *, epochs: int = 5, ycsb=YCSB, **cfg_kw):
    """The reference's and the port's engine and generator, built alike."""
    out = []
    cfg = dict(n_nodes=5, sync_strategy=strategy, planner="kcenter", barrier=barrier,
               modeled_cpu=True, **cfg_kw)
    kw = dict(bandwidth_mbps=120.0, seed=3, wan_mask=REGIONS[:, None] != REGIONS[None, :])
    for side in ("ref", "port"):
        if side == "ref":
            eng = ref.GeoCluster(ref.EngineConfig(**cfg), **kw)
            gen = ref.YCSBGenerator(ref.YCSBConfig(**ycsb), 5, seed=5, node_region=REGIONS)
            trace = ref.jitter_trace(BASE, epochs, np.random.default_rng(0))
        else:
            eng = GeoCluster(EngineConfig(**cfg), device="cpu", **kw)
            gen = YCSBGenerator(YCSBConfig(**ycsb), 5, seed=5, node_region=REGIONS)
            trace = plat.jitter_trace(BASE, epochs, np.random.default_rng(0))
        out.append((eng, gen, trace))
    return out


def fields(obj) -> dict:
    return dataclasses.asdict(obj)


def check_runs(want, got) -> None:
    assert len(got.epochs) == len(want.epochs)
    for a, b in zip(want.epochs, got.epochs):
        assert fields(b) == fields(a), a.epoch
    assert (got.state_digest, got.value_digest) == (want.state_digest, want.value_digest)
    assert np.array_equal(got.msg_matrix, want.msg_matrix)
    assert fields(got.summary) == fields(want.summary)
    for name in ("committed", "aborted", "read_aborts", "ww_aborts", "wall_s", "wan_bytes",
                 "throughput_tps", "overlap_ms", "p99_sync_ms"):
        assert getattr(got, name) == getattr(want, name), name
    assert fields(got.white_stats) == fields(want.white_stats)
    assert got.serve is want.serve is None


@pytest.mark.parametrize("barrier", [False, True])
@pytest.mark.parametrize("strategy", ["flat", "hier", "geococo"])
def test_run_matches_the_reference_field_for_field(strategy, barrier):
    (re, rg, rt), (pe, pg, pt) = engines(strategy, barrier)
    want = re.run(rg, rt, txns_per_node=8)
    got = pe.run(pg, pt, txns_per_node=8)
    check_runs(want, got)
    assert pe.store.merges == len(got.epochs)
    if strategy == "geococo":
        s = got.white_stats
        assert s.aborted_updates and s.null_updates
    assert [sorted(t) for t in pe.epoch_times] == [["copy_s", "device_s", "draw_s", "host_s"]] * 5


def test_bounded_window_and_wide_values():
    (re, rg, rt), (pe, pg, pt) = engines(
        "geococo", False, epochs=4, keep_epochs=False, stats_window=2,
        ycsb=dict(n_keys=3000, theta=0.99, read_ratio=0.5, rewrite_frac=0.1, value_bytes=1000))
    want, got = re.run(rg, rt, txns_per_node=10), pe.run(pg, pt, txns_per_node=10)
    assert len(got.epochs) == len(pe.epoch_times) == 2
    check_runs(want, got)


@pytest.mark.parametrize("strategy", ["hier", "geococo"])
def test_aggregator_failover_matches_the_reference(strategy):
    sides = engines(strategy, False, epochs=8)
    results = []
    for eng, gen, trace in sides:
        first = eng.run(gen, trace, txns_per_node=8, n_epochs=4)
        victim = eng.control.plan.aggregators[0]
        eng.control.on_node_failure(victim)
        results.append((first, eng.run(gen, trace, txns_per_node=8, n_epochs=4), victim))
    (want1, want2, want_victim), (got1, got2, got_victim) = results
    assert got_victim == want_victim
    check_runs(want1, got1)
    check_runs(want2, got2)
    (re, _, _), (pe, _, _) = sides
    assert pe.control.replan_count == re.control.replan_count
    assert pe.control.event_counts() == re.control.event_counts()
    if strategy == "geococo":
        # the second run restarts at epoch 0 under the first's versions
        assert got2.white_stats.stale_updates > 0


def test_best_plan_ranks_by_the_simulated_makespan_as_the_reference():
    lat = ref.jitter_trace(BASE, 4, np.random.default_rng(1))[3]
    for barrier in (False, True):
        kw = dict(tiv=True, method="kcenter", payload_bytes=2e5, bandwidth_mbps=120.0,
                  filter_keep=0.6, barrier=barrier)
        a, b = ref.best_plan(lat, **kw), pplan.best_plan(lat, **kw)
        assert (a.groups, a.aggregators, a.method) == (b.groups, b.aggregators, b.method)


def test_config_rules_and_presets_as_the_reference():
    for name in ("flat", "hier", "geococo", "geococo-zlib"):
        assert dataclasses.asdict(pstrat.get("wan_sync", name)) == \
            dataclasses.asdict(ref.strategies.get("wan_sync", name))
    for kw in (dict(grouping=True, filtering=True, tiv=False, compression=False),
               dict(grouping=False, filtering=True, tiv=True, compression=True)):
        assert pstrat.wan_strategy_name(**kw) == ref.strategies.wan_strategy_name(**kw)
    for kw in (dict(streaming=True, barrier=True), dict(staleness_feedback=True),
               dict(serve=object()), dict(stats_window=-1)):
        with pytest.raises(ValueError) as want:
            ref.EngineConfig(n_nodes=3, **kw)
        with pytest.raises(ValueError) as got:
            EngineConfig(n_nodes=3, **kw)
        assert str(got.value) == str(want.value)
    cfg = EngineConfig(n_nodes=3, grouping=False, schedule_name="hierarchical")
    with pytest.raises(ValueError, match="requires grouping=True"):
        GeoCluster(cfg, device="cpu")
    with pytest.raises(KeyError, match="registered"):
        EngineConfig(n_nodes=3, sync_strategy="geococo-lz4")


@pytest.mark.parametrize("kw,item", [
    (dict(verify_schedules=True), "W7"),
])
def test_refused_flags_name_their_roadmap_item(kw, item):
    """The flags once refused by their ROADMAP item are accepted now that
    the item is ported (``verify_schedules``: W7), as the reference's."""
    got = EngineConfig(n_nodes=3, **kw)
    want = ref.EngineConfig(n_nodes=3, **kw)
    assert all(getattr(got, k) == getattr(want, k) for k in kw)


def test_views_start_as_copies_of_a_loaded_store():
    """Reference fault 15: the reference starts each node's view empty even
    on a store loaded before ``run()``, so every read of a loaded key is
    stale in its first epochs.  The port's views start as copies of the
    store: its first epoch reads fresh state and aborts no read, while the
    same transactions (equal write-write aborts) read-abort in the
    reference."""
    cfg = dict(streaming=True, staleness_feedback=True, epoch_ms=2.0)
    (re, rg, rt), (pe, pg, pt) = engines("geococo", False, epochs=4, **cfg)
    pe.store = pg.table("cpu")
    pg.load(pe.store, seed=11)
    re.store = ref.DeltaCRDTStore()
    re.store.apply_many([ref.Update(k, v, ref.Version(ver.epoch, ver.seq, ver.node))
                         for k, (v, ver) in pe.store.full_state().items()])
    want, got = re.run(rg, rt, txns_per_node=8), pe.run(pg, pt, txns_per_node=8)
    assert got.epochs[0].read_aborts == 0 < want.epochs[0].read_aborts
    assert [e.ww_aborts for e in got.epochs] == [e.ww_aborts for e in want.epochs]
    assert got.read_aborts < want.read_aborts


def test_refused_parts_outside_the_config():
    """The verifier's parts outside the config, once refused (W7), run:
    ``TransmissionSchedule.verify`` as the reference's, and
    ``WANSimulator(verify=True)`` times a round as the unverified one."""
    from repro_torch.analysis import reset_verified_schedule_count, verified_schedule_count
    from repro_torch.core.schedule import all_to_all_schedule
    from repro_torch.core.simulator import WANSimulator

    assert all_to_all_schedule(3, 1.0).verify(n_nodes=3) == \
        ref.all_to_all_schedule(3, 1.0).verify(n_nodes=3) == []
    sched = all_to_all_schedule(5, 250_000.0)
    reset_verified_schedule_count()
    got = WANSimulator(BASE, 120.0, verify=True).run(sched)
    want = WANSimulator(BASE, 120.0).run(sched)
    assert verified_schedule_count() == 1
    assert got.makespan_ms == want.makespan_ms and np.array_equal(got.finish_ms, want.finish_ms)


def test_a_dropped_engine_frees_its_store_at_once():
    """The control plane holds the engine's planner weakly: with the
    garbage collector off, dropping the engine frees its store, and the
    shared plane plans with its default again."""
    import gc
    import weakref

    from repro_torch.control.plane import ControlPlane

    plane = ControlPlane(tiv=True)
    eng = GeoCluster(EngineConfig(n_nodes=5, sync_strategy="geococo", planner="kcenter",
                                  modeled_cpu=True),
                     control=plane, bandwidth_mbps=120.0, device="cpu")
    gen = YCSBGenerator(YCSBConfig(**YCSB), 5, seed=5, node_region=REGIONS)
    eng.run(gen, plat.jitter_trace(BASE, 2, np.random.default_rng(0)), txns_per_node=8)
    assert eng.control is plane and not plane.bind_planner(lambda lat: None)
    values = weakref.ref(eng.store.values)
    gc.disable()
    try:
        del eng
        assert values() is None
    finally:
        gc.enable()
    want = ControlPlane(tiv=True).replanner.plan_fn(BASE)
    got = plane.replanner.plan_fn(BASE)
    assert (got.groups, got.aggregators) == (want.groups, want.aggregators)


def test_the_engine_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GeoCluster(EngineConfig(n_nodes=5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YCSBGenerator(YCSBConfig(n_keys=10), 5).table()


def test_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "geo_database_sim_torch.py"), "--device", "cpu",
         "--epochs", "6", "--keys", "500", "--planner", "kcenter"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "state identical: True" in out.stdout
    assert "injected failure of aggregator node" in out.stdout
    assert "run completed on cpu with consistent state" in out.stdout
