"""The port's control plane (``repro_torch.core.latency``, ``.monitor``,
``.planner``, ``repro_torch.control``) against the reference's numpy
modules on the same seeded inputs, on the CPU, bit for bit: the latency
models and traces, the monitors' estimates, every planner's plan,
``best_plan`` and the damped ``Replanner`` over a jittered trace, the relay
ring search, and ``ControlPlane`` event sequences field by field.  Neither
side imports JAX here: the reference's control plane is numpy only.
"""

import dataclasses

import numpy as np
import pytest

import repro.control as rctl
from repro.core import latency as rlat
from repro.core import monitor as rmon
from repro.core import planner as rplan
from repro.core import strategies as rstrat
import repro_torch.control as pctl
from repro_torch.core import latency as plat
from repro_torch.core import monitor as pmon
from repro_torch.core import planner as pplan
from repro_torch.core import strategies as pstrat

# the reference test's 4-node square (tests/test_control_plane.py:33-49):
# perimeter 10 ms, diagonals 14 ms; spiking (0, 1) and (2, 3) moves the
# best relay ring from (0, 1, 2, 3) to (0, 2, 1, 3)
SQUARE = np.array([[0.0, 10.0, 14.0, 10.0],
                   [10.0, 0.0, 10.0, 14.0],
                   [14.0, 10.0, 0.0, 10.0],
                   [10.0, 14.0, 10.0, 0.0]])


def spiked_square() -> np.ndarray:
    spk = SQUARE.copy()
    spk[0, 1] = spk[1, 0] = 100.0
    spk[2, 3] = spk[3, 2] = 100.0
    return spk


def clustered(mod, n: int, seed: int) -> np.ndarray:
    lat, _ = mod.geo_clustered_matrix(mod.GeoClusterSpec(n_nodes=n, n_clusters=max(2, n // 3)),
                                      np.random.default_rng(seed))
    return lat


def same_array(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def plan_fields(plan) -> tuple | None:
    """A plan's groups, aggregators, method and objective (its search time is
    a wall-clock reading and differs run to run)."""
    if plan is None:
        return None
    return plan.groups, plan.aggregators, plan.method, repr(plan.objective)


def event_fields(event) -> dict:
    out = {"type": type(event).__name__}
    for f in dataclasses.fields(event):
        v = getattr(event, f.name)
        out[f.name] = plan_fields(v) if f.name in ("plan", "previous") and (
            v is None or hasattr(v, "groups")) else v
    return out


def same_events(got: list, want: list) -> None:
    assert [event_fields(e) for e in got] == [event_fields(e) for e in want]


# ---------------------------------------------------------------------------
# latency models and traces
# ---------------------------------------------------------------------------


def test_aws_matrix_and_regions():
    same_array(plat.aws_latency_matrix(), rlat.aws_latency_matrix())
    assert plat.AWS_REGIONS == rlat.AWS_REGIONS


@pytest.mark.parametrize("n,seed", [(6, 0), (12, 1), (24, 2)])
def test_geo_clustered_matrix_and_bandwidth(n, seed):
    for a, b in zip(plat.geo_clustered_matrix(plat.GeoClusterSpec(n_nodes=n),
                                              np.random.default_rng(seed)),
                    rlat.geo_clustered_matrix(rlat.GeoClusterSpec(n_nodes=n),
                                              np.random.default_rng(seed))):
        same_array(a, b)
    lat, ids = rlat.geo_clustered_matrix(rlat.GeoClusterSpec(n_nodes=n),
                                         np.random.default_rng(seed))
    same_array(plat.bandwidth_matrix(ids, n, np.random.default_rng(seed)),
               rlat.bandwidth_matrix(ids, n, np.random.default_rng(seed)))


@pytest.mark.parametrize("n,rounds,seed", [(4, 8, 0), (10, 64, 3)])
def test_jitter_trace(n, rounds, seed):
    base = rlat.aws_latency_matrix()[:n, :n]
    got = plat.jitter_trace(base, rounds, np.random.default_rng(seed), spike_prob=0.05)
    want = rlat.jitter_trace(base, rounds, np.random.default_rng(seed), spike_prob=0.05)
    same_array(got.frames, want.frames)
    same_array(got.base, want.base)
    assert len(got) == len(want) == rounds


@pytest.mark.parametrize("margin", [0.0, 0.05])
def test_tiv_analysis(margin):
    lat = clustered(rlat, 12, 4)
    for a, b in zip(plat.one_relay_effective(lat, margin=margin),
                    rlat.one_relay_effective(lat, margin=margin)):
        same_array(a, b)
    same_array(plat.tiv_pairs(lat, margin=margin), rlat.tiv_pairs(lat, margin=margin))
    assert plat.tiv_fraction(lat, margin=margin) == rlat.tiv_fraction(lat, margin=margin)
    same_array(plat.all_pairs_shortest(lat), rlat.all_pairs_shortest(lat))


# ---------------------------------------------------------------------------
# monitors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_latency_monitor_estimates(noise):
    trace = rlat.jitter_trace(rlat.aws_latency_matrix()[:6, :6], 12, np.random.default_rng(5))
    got, want = pmon.LatencyMonitor(6, alpha=0.3), rmon.LatencyMonitor(6, alpha=0.3)
    rg, rw = np.random.default_rng(7), np.random.default_rng(7)
    for frame in trace.frames:
        same_array(got.probe_all(frame, rg, noise), want.probe_all(frame, rw, noise))
        same_array(got.estimate(), want.estimate())
    assert got.probe_bytes == want.probe_bytes > 0
    assert pmon.PROBE_BYTES == rmon.PROBE_BYTES


@pytest.mark.parametrize("seeded", [False, True])
def test_vivaldi_estimates(seeded):
    truth = clustered(rlat, 16, 6)
    got = pmon.VivaldiSystem(16, pmon.VivaldiConfig(), seed=3)
    want = rmon.VivaldiSystem(16, rmon.VivaldiConfig(), seed=3)
    if seeded:
        got.seed_from_matrix(truth)
        want.seed_from_matrix(truth)
    same_array(got.fit(truth, rounds=5, rng=np.random.default_rng(1)),
               want.fit(truth, rounds=5, rng=np.random.default_rng(1)))
    same_array(got.verify_and_correct(truth, sample_frac=0.2, rng=np.random.default_rng(2)),
               want.verify_and_correct(truth, sample_frac=0.2, rng=np.random.default_rng(2)))
    assert got.median_rel_error(truth) == want.median_rel_error(truth)
    assert got.probe_bytes == want.probe_bytes


# ---------------------------------------------------------------------------
# planners
# ---------------------------------------------------------------------------


def test_planner_registry_names():
    assert pstrat.names("planner") == rstrat.names("planner")


@pytest.mark.parametrize("method", ["milp", "kcenter", "agglomerative", "kmeans", "random",
                                    "none"])
@pytest.mark.parametrize("n,k", [(6, 2), (9, 3)])
def test_each_planner_gives_the_reference_plan(method, n, k):
    lat = clustered(rlat, n, n)
    kw = dict(tiv=True, tiv_margin=0.05, time_limit_s=5.0)
    got = pstrat.get("planner", method)(lat, k, rng=np.random.default_rng(0), **kw)
    want = rstrat.get("planner", method)(lat, k, rng=np.random.default_rng(0), **kw)
    assert plan_fields(got) == plan_fields(want)
    got.validate(n)


def test_plan_cost_and_k_band():
    lat = clustered(rlat, 10, 1)
    plan = rplan.kcenter_grouping(lat, 3)
    mine = pplan.GroupPlan(**dataclasses.asdict(plan))
    for tiv in (False, True):
        assert pplan.plan_cost(lat, mine, tiv=tiv) == rplan.plan_cost(lat, plan, tiv=tiv)
    for n in (3, 8, 32, 100):
        assert pplan.k_search_band(n) == rplan.k_search_band(n)
        assert pplan.optimal_k(n) == rplan.optimal_k(n)
        assert pplan.hierarchical_comm_cost(n, 2) == rplan.hierarchical_comm_cost(n, 2)
    assert plan_fields(mine.drop_node(plan.aggregators[0])) == plan_fields(
        plan.drop_node(plan.aggregators[0]))
    assert plan_fields(mine.replace_aggregator(0, plan.groups[0][-1])) == plan_fields(
        plan.replace_aggregator(0, plan.groups[0][-1]))


@pytest.mark.parametrize("method", ["milp", "kcenter"])
def test_best_plan_and_replanner_over_a_jittered_trace(method):
    trace = rlat.jitter_trace(rlat.aws_latency_matrix()[:8, :8], 24, np.random.default_rng(2),
                              spike_prob=0.05)
    kw = dict(tiv=True, method=method)
    got = pplan.Replanner(lambda lat: pplan.best_plan(lat, **kw), threshold=0.05, sustain=2)
    want = rplan.Replanner(lambda lat: rplan.best_plan(lat, **kw), threshold=0.05, sustain=2)
    for t, frame in enumerate(trace.frames):
        assert plan_fields(got.observe(frame)) == plan_fields(want.observe(frame)), t
        assert got.deviation(frame) == want.deviation(frame)
        if t == 10:
            assert plan_fields(got.force(frame)) == plan_fields(want.force(frame))
        if t == 15:
            assert plan_fields(got.on_node_failure(3)) == plan_fields(want.on_node_failure(3))
    assert got.replan_count == want.replan_count >= 3


def test_best_plan_refuses_the_wan_simulator_ranking():
    """The ranking by a simulated round makespan (``payload_bytes``) runs
    the port's WAN simulator: the reference's plans under both engines,
    with and without a bandwidth limit, and by two stitched epochs (the
    streaming engine's ranking); that ranking refuses the barrier engine
    as the reference's does."""
    for kw in (dict(), dict(barrier=True), dict(bandwidth_mbps=50.0),
               dict(barrier=True, bandwidth_mbps=50.0, filter_keep=0.5),
               dict(streaming=True), dict(streaming=True, bandwidth_mbps=50.0)):
        want = rplan.best_plan(SQUARE, method="kcenter", payload_bytes=1e6, **kw)
        got = pplan.best_plan(SQUARE, method="kcenter", payload_bytes=1e6, **kw)
        assert plan_fields(got) == plan_fields(want)
    with pytest.raises(ValueError, match="event engine"):
        pplan.best_plan(SQUARE, payload_bytes=1e6, streaming=True, barrier=True)


# ---------------------------------------------------------------------------
# relay ring and the control plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiv", [False, True])
@pytest.mark.parametrize("n,seed", [(4, 0), (7, 1), (12, 2)])
def test_relay_ring_order_and_cost(n, seed, tiv):
    lat = clustered(rlat, n, seed)
    order = pctl.relay_ring_order(lat, tiv=tiv)
    assert order == rctl.relay_ring_order(lat, tiv=tiv)
    assert pctl.ring_cost(lat, order) == rctl.ring_cost(lat, order)


def test_relay_ring_of_the_spiked_square():
    assert pctl.relay_ring_order(SQUARE) == rctl.relay_ring_order(SQUARE) == (0, 1, 2, 3)
    assert pctl.relay_ring_order(spiked_square()) == rctl.relay_ring_order(spiked_square()) \
        == (0, 2, 1, 3)


def run_plane(ctl, view_of, rounds: int, **kw):
    plane = ctl.ControlPlane(view_of(ctl), **kw)
    for _ in range(rounds):
        plane.step()
    return plane


def square_frames(ctl):
    return ctl.TraceView([SQUARE] * 2 + [spiked_square()] * 8, loop=False)


def noisy_aws(ctl):
    lat = rlat.aws_latency_matrix()[:6, :6]
    trace = rlat.jitter_trace(lat, 16, np.random.default_rng(0), spike_prob=0.05)
    return ctl.MonitorView(ctl.TraceView(trace.frames), noise=0.2, rng=np.random.default_rng(1))


def vivaldi_clustered(ctl):
    truth = clustered(rlat, 10, 3)
    return ctl.VivaldiView(truth, samples_per_node=4, verify_every=3, warmup_rounds=2, seed=4)


@pytest.mark.parametrize("view_of,rounds,kw", [
    (square_frames, 6, dict(replan_sustain=2, degrade_sustain=2)),
    (noisy_aws, 16, dict(replan_sustain=2, replan_threshold=0.05)),
    (vivaldi_clustered, 12, dict(ring_tiv=True)),
], ids=["square-to-spiked", "monitor-noise", "vivaldi"])
def test_control_plane_event_sequences(view_of, rounds, kw):
    got = run_plane(pctl, view_of, rounds, **kw)
    want = run_plane(rctl, view_of, rounds, **kw)
    same_events(got.events, want.events)
    assert got.event_counts() == want.event_counts()
    assert (got.round, got.replan_count, got.relay_order, got.probe_bytes) == \
        (want.round, want.replan_count, want.relay_order, want.probe_bytes)
    assert (got.relay_full_searches, got.relay_incremental_searches,
            got.relay_incremental_evals) == (want.relay_full_searches,
                                             want.relay_incremental_searches,
                                             want.relay_incremental_evals)
    same_array(got.last_latency, want.last_latency)


def test_square_to_spiked_changes_the_ring():
    plane = run_plane(pctl, square_frames, 6, replan_sustain=2, degrade_sustain=2)
    orders = [e.order for e in plane.events if isinstance(e, pctl.RelayOrderChanged)]
    assert orders == [(0, 1, 2, 3), (0, 2, 1, 3)]


@pytest.mark.parametrize("observed", [0, 3])
def test_force_replan(observed):
    planes = [run_plane(ctl, square_frames, observed, replan_sustain=3) for ctl in (pctl, rctl)]
    got, want = (p.force_replan(reason="straggler@step3") for p in planes)
    assert plan_fields(got) == plan_fields(want)
    same_events(planes[0].events, planes[1].events)
    assert planes[0].events[-2].reason == "straggler@step3"


def test_on_node_failure():
    planes = [run_plane(ctl, noisy_aws, 4, replan_sustain=2) for ctl in (pctl, rctl)]
    for node in (2, 0):
        got, want = (p.on_node_failure(node) for p in planes)
        assert plan_fields(got) == plan_fields(want)
    for p in planes:
        p.step()
    same_events(planes[0].events, planes[1].events)
    assert [e.reason for e in planes[0].events if isinstance(e, pctl.PlanChanged)][-3:] == [
        "node-failure:2", "node-failure:0", "sustained-deviation"]
