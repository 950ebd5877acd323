"""The port's streaming engine against the reference's on the CPU, with
exact equality (no tolerances): ``stitch_schedules`` and ``StitchState``
transfer for transfer; the event engine's ``run(lats=)``,
``node_commit_ms``, ``simulate_segment`` and ``StreamingTimeline`` finish
time for finish time; ``GeoCluster(streaming=True)`` under flat, hier and
geococo on YCSB and TPC-C, every ``EpochStats`` and ``RunSummary`` field,
``FilterStats``, the message matrix and both digests (``kcenter``,
``modeled_cpu``); the incremental timeline against the resim oracle; the
streaming digests against the formula engine's; ``best_plan(streaming=)``,
``ControlPlane(rank_streaming=)`` and the ``stream_mode`` rule with the
reference's messages.  The reference's WAN plane is numpy only: neither side
imports JAX here.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro.serve as rserve
import repro_torch.serve as pserve
from repro.core import schedule as rsched
from repro.core import simulator as rsim
from repro.core import stream as rstream
from repro_torch.core import latency as plat
from repro_torch.core import planner as pplan
from repro_torch.core import schedule as psched
from repro_torch.core import simulator as psim
from repro_torch.core import stream as pstream
from repro_torch.core.replication import EngineConfig, GeoCluster
from repro_torch.core.workload import TPCCConfig, TPCCGenerator, YCSBConfig, YCSBGenerator

from test_torch_geo_cluster import check_runs

YCSB = dict(n_keys=400, theta=0.9, read_ratio=0.3, hot_write_frac=0.3, rewrite_frac=0.2,
            hot_locality=True)
TPCC = dict(n_warehouses=20, mix="TPCC-A", remote_prob=0.25, items_per_warehouse=20)


def topology(n=5, epochs=8, seed=1):
    """``tests/test_streaming.py``'s two-cluster topology, its jittered trace
    and its WAN mask, from the port's and the reference's latency modules."""
    out = []
    for lib in (ref, plat):
        lat, regions = lib.geo_clustered_matrix(lib.GeoClusterSpec(n_nodes=n, n_clusters=2),
                                                np.random.default_rng(seed))
        trace = lib.jitter_trace(lat, epochs, np.random.default_rng(seed + 1))
        out.append((lat, np.asarray(regions), trace))
    (rl, rr, rt), (pl, pr, pt) = out
    assert np.array_equal(rl, pl) and np.array_equal(rr, pr)
    assert all(np.array_equal(a, b) for a, b in zip(rt, pt))
    wan = pr[:, None] != pr[None, :]
    return pl, pr, (rt, pt), wan


def streaming_engines(workload: str, *, epochs=8, bw=200.0, epoch_ms=2.0, serve=None,
                      **cfg_kw):
    """The reference's and the port's streaming engines, generators and
    traces, built alike (``tests/test_streaming.py``'s and
    ``tests/test_staleness.py``'s settings, with ``kcenter`` and
    ``modeled_cpu``); ``serve``: the keywords of a ``ServeConfig`` each
    side makes from its own package."""
    _, regions, (rt, pt), wan = topology(epochs=epochs)
    bwm = np.where(wan, bw, 10_000.0)
    np.fill_diagonal(bwm, np.inf)
    cfg = dict(dict(n_nodes=5, streaming=True, planner="kcenter", epoch_ms=epoch_ms,
                    modeled_cpu=True, sync_strategy="geococo"), **cfg_kw)
    kw = dict(bandwidth_mbps=bwm, wan_mask=wan, seed=7)
    sides = [None, None] if serve is None else \
        [rserve.ServeConfig(**serve), pserve.ServeConfig(**serve)]
    re = ref.GeoCluster(ref.EngineConfig(**cfg, serve=sides[0]), **kw)
    pe = GeoCluster(EngineConfig(**cfg, serve=sides[1]), device="cpu", **kw)
    if workload == "ycsb":
        rg = ref.YCSBGenerator(ref.YCSBConfig(**YCSB), 5, seed=3, node_region=regions)
        pg = YCSBGenerator(YCSBConfig(**YCSB), 5, seed=3, node_region=regions)
    else:
        rg = ref.TPCCGenerator(ref.TPCCConfig(**TPCC), 5, seed=3)
        pg = TPCCGenerator(TPCCConfig(**TPCC), 5, seed=3)
    return (re, rg, rt), (pe, pg, pt)


def run_both(workload, *, txns=8, epochs=8, **kw):
    (re, rg, rt), (pe, pg, pt) = streaming_engines(workload, epochs=epochs, **kw)
    want = re.run(rg, rt, txns_per_node=txns, n_epochs=epochs)
    got = pe.run(pg, pt, txns_per_node=txns, n_epochs=epochs)
    return want, got, pe


def transfer_form(sched) -> list:
    return [dataclasses.astuple(t) for t in sched.transfers]


def schedules(lib_sched, lat, plan):
    return [
        lib_sched.all_to_all_schedule(6, 120_000.0),
        lib_sched.hierarchical_schedule(plan, 120_000.0),
        lib_sched.leader_schedule(6, 2, 300_000.0),
        lib_sched.hierarchical_schedule(plan, 40_000.0, lat=lat, tiv=True),
        lib_sched.all_to_all_schedule(6, 500_000.0),
    ]


def stream_inputs():
    """``tests/test_streaming.py``'s timeline case: five epochs of mixed
    builders on a 6-node two-cluster matrix, scaled per epoch, with random
    execution rows; the same objects for both sides but the schedules."""
    lat, _ = plat.geo_clustered_matrix(plat.GeoClusterSpec(n_nodes=6, n_clusters=2),
                                       np.random.default_rng(1))
    plan = pplan.kcenter_grouping(lat, 2)
    rplan = ref.GroupPlan(groups=plan.groups, aggregators=plan.aggregators)
    rng = np.random.default_rng(9)
    lats = []
    for _ in range(5):
        m = lat * float(rng.uniform(0.8, 1.3))
        np.fill_diagonal(m, 0.0)
        lats.append(m)
    rows = [rng.uniform(0.0, 4.0, size=6) for _ in range(5)]
    return lat, lats, rows, schedules(rsched, lat, rplan), schedules(psched, lat, plan)


@pytest.mark.parametrize("epoch_ms", [0.0, 25.0])
def test_stitch_schedules_and_stitch_state_equal_the_reference(epoch_ms):
    _, _, rows, rs, ps = stream_inputs()
    for a, b in zip(rs, ps):
        assert transfer_form(a) == transfer_form(b)
    want = rsched.stitch_schedules(rs, node_exec_ms=np.array(rows), epoch_ms=epoch_ms, n=6)
    got = psched.stitch_schedules(ps, node_exec_ms=np.array(rows), epoch_ms=epoch_ms, n=6)
    assert transfer_form(got) == transfer_form(want)
    assert got.phase_of == want.phase_of and got.label == want.label
    rstate, pstate = rsched.StitchState(6, epoch_ms=epoch_ms), psched.StitchState(6, epoch_ms=epoch_ms)
    flat = []
    for k, (a, b) in enumerate(zip(rs, ps)):
        (wseg, wranks), (gseg, granks) = rstate.append(a, rows[k]), pstate.append(b, rows[k])
        assert [dataclasses.astuple(t) for t in gseg] == [dataclasses.astuple(t) for t in wseg]
        assert granks == wranks and pstate.frontier() == rstate.frontier()
        flat.extend(gseg)
    # concatenating the appends is the one-shot stitch
    assert [dataclasses.astuple(t) for t in flat] == transfer_form(got)
    with pytest.raises(ValueError, match="node count"):
        psched.StitchState(0)
    with pytest.raises(ValueError, match="cannot infer"):
        psched.stitch_schedules([])


@pytest.mark.parametrize("bw", [np.inf, 200.0, 8.0])
@pytest.mark.parametrize("epoch_ms", [0.0, 25.0])
def test_stitched_run_commits_and_timeline_equal_the_reference(bw, epoch_ms):
    """``run(stitched, lats=)``, ``node_commit_ms`` (whole and windowed) and
    the appendable timeline, finish time for finish time against the
    reference's, and the timeline against the full run (the incremental
    identity) on the port's side too."""
    lat, lats, rows, rs, ps = stream_inputs()
    rst = rsched.stitch_schedules(rs, node_exec_ms=np.array(rows), epoch_ms=epoch_ms, n=6)
    pst = psched.stitch_schedules(ps, node_exec_ms=np.array(rows), epoch_ms=epoch_ms, n=6)
    want = rsim.WANSimulator(lat, bw).run(rst, lats=lats)
    got = psim.WANSimulator(lat, bw).run(pst, lats=psim.EpochLatencyCycle(lats, 5))
    for name in ("makespan_ms", "phase_ms", "start_ms", "finish_ms", "msg_matrix",
                 "link_bytes", "bytes_out", "bytes_in", "critical_path"):
        assert np.array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(want, name))), name
    commits = psim.node_commit_ms(pst, got, 6, 5)
    assert np.array_equal(commits, rsim.node_commit_ms(rst, want, 6, 5))
    window = psim.node_commit_ms(pst, got, 6, 5, start_epoch=2, base_row=commits[1])
    assert np.array_equal(window, commits[2:])
    row = psim.epoch_commit_row(pst.transfers, got.finish_ms, 6)
    assert np.array_equal(row, rsim.epoch_commit_row(rst.transfers, want.finish_ms, 6))
    rtl = rstream.StreamingTimeline(6, bandwidth_mbps=bw, epoch_ms=epoch_ms)
    ptl = pstream.StreamingTimeline(6, bandwidth_mbps=bw, epoch_ms=epoch_ms)
    fins = []
    for k, (a, b) in enumerate(zip(rs, ps)):
        wt = rtl.append_epoch(a, lats[k], node_exec_ms=rows[k])
        gt = ptl.append_epoch(b, lats[k], node_exec_ms=rows[k])
        assert np.array_equal(gt.finish_ms, wt.finish_ms)
        assert np.array_equal(gt.start_ms, wt.start_ms)
        assert np.array_equal(gt.commit_ms, wt.commit_ms)
        assert (gt.epoch, gt.offset, gt.finish_max_ms) == (wt.epoch, wt.offset, wt.finish_max_ms)
        fins.append(gt.finish_ms)
    assert np.array_equal(np.concatenate(fins), got.finish_ms)
    assert np.array_equal(ptl.commit_ms, commits)
    assert ptl.finish_max_ms == rtl.finish_max_ms
    ptl.evict_commit_rows(3)
    assert ptl.evicted_epochs == 3 and np.array_equal(ptl.commit_ms, commits[3:])
    assert ptl.commit_at(4, 2) == commits[4, 2]
    assert np.array_equal(ptl.commit_row(3), commits[3])
    with pytest.raises(IndexError, match="evicted"):
        ptl.commit_at(2, 0)
    with pytest.raises(IndexError, match="not yet appended"):
        ptl.commit_at(5, 0)


def test_epoch_latency_cycle_and_the_barrier_refusal():
    trace = [np.full((3, 3), float(k)) for k in range(3)]
    cyc = psim.EpochLatencyCycle(trace, 7)
    assert len(cyc) == 7 and [float(cyc[k][0, 1]) for k in range(7)] == [0, 1, 2, 0, 1, 2, 0]
    with pytest.raises(IndexError):
        cyc[7]
    with pytest.raises(ValueError, match="non-empty"):
        psim.EpochLatencyCycle([], 3)
    lat = plat.aws_latency_matrix()
    plan = pplan.kcenter_grouping(lat, 3)
    sched = psched.hierarchical_schedule(plan, 250_000.0)
    stitched = psched.stitch_schedules([sched, sched], n=10)
    with pytest.raises(ValueError, match="event engine"):
        psim.WANSimulator(lat, 500.0).run(stitched, barrier=True, lats=[lat, lat])


def test_simulate_segment_equals_the_reference_and_refuses_unsound_modes():
    lat = plat.aws_latency_matrix()[:4, :4]
    out = []
    for sim_mod, sched_mod in ((rsim, rsched), (psim, psched)):
        sched = sched_mod.all_to_all_schedule(4, 1e5)
        n = sched.n_transfers
        nic = sim_mod.NicState.zeros(4)
        nic.clear_out[1], nic.clear_in[2] = 30.0, 55.0
        ready = [float(i % 3) * 10.0 for i in range(n)]
        start, finish, pred = sim_mod.WANSimulator(lat, 100.0).simulate_segment(
            sched.transfers, rank=np.zeros(n, dtype=int), deps=[()] * n, ext_ready=ready,
            nic=nic, lat=lat * 1.1, tid_base=40)
        out.append((np.asarray(start), np.asarray(finish), list(pred), nic.clear_out.copy(),
                    nic.clear_in.copy()))
    for a, b in zip(*out):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    sched = psched.all_to_all_schedule(4, 1e5)
    n = sched.n_transfers
    for kw, msg in ((dict(barrier=True), "event engine"),
                    (dict(admission=False), "bandwidth admission"),
                    (dict(stochastic_loss=True, loss=0.01), "stochastic_loss")):
        with pytest.raises(ValueError, match=msg):
            psim.WANSimulator(lat, 100.0, **kw).simulate_segment(
                sched.transfers, rank=np.zeros(n, dtype=int), deps=[()] * n,
                ext_ready=[0.0] * n, nic=psim.NicState.zeros(4))
    # verify=True (once refused, W7) checks each appended segment and only
    # observes: the same times as an unverified timeline, one clean segment
    # counted an epoch
    from repro_torch.analysis import reset_verified_schedule_count, verified_schedule_count

    reset_verified_schedule_count()
    plain, checked = pstream.StreamingTimeline(4, epoch_ms=2.0), \
        pstream.StreamingTimeline(4, epoch_ms=2.0, verify=True)
    for e in range(3):
        a, b = (t.append_epoch(sched, lat * (1.0 + 0.1 * e), [1.0, 0.5, 2.0, 0.0])
                for t in (plain, checked))
        for x, y in ((a.commit_ms, b.commit_ms), (a.start_ms, b.start_ms),
                     (a.finish_ms, b.finish_ms)):
            assert np.array_equal(x, y)
    assert verified_schedule_count() == 3


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
@pytest.mark.parametrize("strategy", ["flat", "hier", "geococo"])
def test_streaming_cluster_equals_the_reference(strategy, workload):
    want, got, pe = run_both(workload, sync_strategy=strategy)
    check_runs(want, got)
    assert got.pipeline_overlap_ms == want.pipeline_overlap_ms
    assert [e.stream_commit_ms for e in got.epochs] == [e.stream_commit_ms for e in want.epochs]
    assert got.read_aborts == 0 and pe.store.merges == len(got.epochs)
    assert [sorted(t) for t in pe.epoch_times] == \
        [["copy_s", "device_s", "draw_s", "host_s", "views_s"]] * len(got.epochs)
    assert all(t["views_s"] == 0.0 for t in pe.epoch_times)


def test_bounded_streaming_run_equals_the_reference():
    want, got, pe = run_both("ycsb", epochs=6, keep_epochs=False, stats_window=2)
    assert len(got.epochs) == len(pe.epoch_times) == 2
    check_runs(want, got)


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
def test_incremental_equals_resim(workload, feedback):
    """``stream_mode="incremental"`` (the default) against the O(E²) oracle,
    and each against the reference's same mode."""
    runs = {}
    for mode in ("incremental", "resim"):
        runs[mode] = run_both(workload, stream_mode=mode, staleness_feedback=feedback, bw=20.0,
                              epoch_ms=40.0)
        check_runs(*runs[mode][:2])
    (_, inc, pe_inc), (_, res, pe_res) = runs["incremental"], runs["resim"]
    for a, b in zip(inc.epochs, res.epochs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (inc.state_digest, inc.value_digest) == (res.state_digest, res.value_digest)
    assert pe_inc.view_merges == pe_res.view_merges
    if feedback:
        assert inc.read_aborts > 0 and pe_inc.view_merges > 0
        assert max(e.view_lag_max for e in inc.epochs) > 0


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
def test_streaming_digests_equal_the_formula_engine(workload):
    """Streaming changes when epochs commit, never what: with the feedback
    off, its digests, commits and WAN bytes are the formula engine's."""
    _, streaming, _ = run_both(workload)
    (_, _, _), (pe, pg, pt) = streaming_engines(workload, streaming=False)
    formula = pe.run(pg, pt, txns_per_node=8, n_epochs=8)
    assert (streaming.state_digest, streaming.value_digest) == \
        (formula.state_digest, formula.value_digest)
    assert (streaming.committed, streaming.aborted, streaming.wan_bytes) == \
        (formula.committed, formula.aborted, formula.wan_bytes)
    assert [e.sync_ms for e in streaming.epochs] == [e.sync_ms for e in formula.epochs]


def test_streaming_overlap_bounds_and_cadence():
    """The reference's bounds on the port: the stream's total lies between
    the slowest isolated epoch and the formula's sum plus the summed
    execution, each epoch's overlap is the formula's charge less its wall,
    the commits rise, and the last one comes no earlier than the cadence."""
    for epoch_ms in (2.0, 50.0):
        _, st, _ = run_both("ycsb", epoch_ms=epoch_ms)
        formula = np.array([max(epoch_ms, e.exec_ms, e.sync_ms) for e in st.epochs])
        total = sum(e.wall_ms for e in st.epochs)
        assert formula.max() - 1e-6 <= total <= formula.sum() + sum(e.exec_ms for e in st.epochs)
        for e, f in zip(st.epochs, formula):
            assert e.pipeline_overlap_ms == pytest.approx(f - e.wall_ms, abs=1e-9)
        commits = [e.stream_commit_ms for e in st.epochs]
        assert all(b >= a - 1e-9 for a, b in zip(commits, commits[1:]))
        assert commits[-1] == pytest.approx(total)
        assert commits[-1] >= (len(commits) - 1) * epoch_ms - 1e-6


def test_best_plan_streaming_ranks_as_the_reference():
    lat = plat.aws_latency_matrix()
    for bw in (500.0, 40.0):
        kw = dict(payload_bytes=250_000.0, bandwidth_mbps=bw, streaming=True, method="kcenter",
                  filter_keep=0.7)
        a, b = ref.best_plan(lat, **kw), pplan.best_plan(lat, **kw)
        assert (a.groups, a.aggregators, a.method) == (b.groups, b.aggregators, b.method)
        b.validate(lat.shape[0])
    for mod in (ref, pplan):
        with pytest.raises(ValueError) as err:
            mod.best_plan(lat, payload_bytes=1e5, streaming=True, barrier=True,
                          method="kcenter")
        assert "event engine" in str(err.value)


def test_control_plane_rank_streaming_as_the_reference():
    from repro.control.plane import ControlPlane as RefPlane
    from repro_torch.control.plane import ControlPlane

    lat = plat.aws_latency_matrix()
    kw = dict(rank_payload_bytes=250_000.0, rank_bandwidth_mbps=60.0, rank_streaming=True)
    a, b = RefPlane(**kw).replanner.plan_fn(lat), ControlPlane(**kw).replanner.plan_fn(lat)
    assert (a.groups, a.aggregators) == (b.groups, b.aggregators)
    with pytest.raises(ValueError) as want:
        RefPlane(rank_streaming=True, barrier=True)
    with pytest.raises(ValueError) as got:
        ControlPlane(rank_streaming=True, barrier=True)
    assert str(got.value) == str(want.value)


def test_stream_mode_rule_as_the_reference():
    for kw in (dict(streaming=True, stream_mode="eager"),
               dict(streaming=True, staleness_feedback=True, barrier=True)):
        with pytest.raises(ValueError) as want:
            ref.EngineConfig(n_nodes=4, **kw)
        with pytest.raises(ValueError) as got:
            EngineConfig(n_nodes=4, **kw)
        assert str(got.value) == str(want.value)
    EngineConfig(n_nodes=4, streaming=True, stream_mode="resim")
