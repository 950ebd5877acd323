"""The port's static passes (``repro_torch.analysis``) against the
reference's on the CPU: the schedule verifier and its per-epoch form
violation for violation (rule, transfer index, message) over every builder
on the trace topologies and over stitched streams; each mutator's output
transfer for transfer from the same seed, with the reference's 100% catch
rate; verification through the engines (event, barrier, streaming
incremental and resim, with per-node views) only observing: a verified run
equals the unverified one and the reference's verified run, field for field
and digest for digest, with the reference's count of verified schedules;
every mutator rejected by ``WANSimulator(verify=True)``; the determinism
lint on the reference's fixtures as the reference, on the port's torch
fixtures, over ``src/repro_torch`` (clean) and through its CLI.  The
reference's verifier, mutators and lint are numpy or stdlib only: neither
side imports JAX here.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.analysis as ranalysis
import repro.core as ref
from repro.analysis import lint as rlint
from repro.analysis import mutate as rmutate
from repro.core import planner as rplan
from repro_torch.analysis import lint as plint
from repro_torch.analysis import mutate as pmutate
from repro_torch.analysis import schedule_check as pcheck
from repro_torch.core import latency as plat
from repro_torch.core import planner as pplan
from repro_torch.core import schedule as psched
from repro_torch.core import simulator as psim
from repro_torch.core.replication import EngineConfig, GeoCluster

from test_torch_geo_cluster import check_runs, engines
from test_torch_streaming import streaming_engines

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "lint"
TORCH_FIXTURES = REPO / "tests" / "fixtures" / "lint_torch"
PAYLOAD = 250_000.0


def topologies(lib) -> dict[str, np.ndarray]:
    """``tests/test_analysis.py``'s three topologies (those of
    ``bench_makespan_regression``) from one side's latency module."""
    lat_w, _ = lib.geo_clustered_matrix(
        lib.GeoClusterSpec(n_nodes=20, n_clusters=6, congestion_frac=0.22,
                           congestion_mult=(1.4, 2.5)), np.random.default_rng(1))
    lat_a, _ = lib.geo_clustered_matrix(
        lib.GeoClusterSpec(n_nodes=12, n_clusters=3, congestion_frac=0.3,
                           congestion_mult=(1.3, 2.5)), np.random.default_rng(3))
    return {"aws": lib.aws_latency_matrix(), "wondernet_like": lat_w, "alibaba_like": lat_a}


TOPOLOGIES = topologies(plat)


def builders(sched_mod, plan_mod, lat: np.ndarray) -> dict:
    """Every builder variant on one topology, from one side's modules."""
    n = lat.shape[0]
    plan = plan_mod.kcenter_grouping(lat, max(2, int(round(plan_mod.optimal_k(n)))))
    gp = np.array([len(g) * PAYLOAD * 0.4 for g in plan.groups])
    return {
        "flat": sched_mod.all_to_all_schedule(n, PAYLOAD),
        "hier": sched_mod.hierarchical_schedule(plan, PAYLOAD),
        "geococo": sched_mod.hierarchical_schedule(plan, PAYLOAD, group_payload_bytes=gp,
                                                   lat=lat, tiv=True),
        "leader": sched_mod.leader_schedule(n, 0, PAYLOAD),
        "leader_planned": sched_mod.leader_schedule(n, 0, PAYLOAD, plan),
    }


def stitched(sched_mod, plan_mod, lat_mod, lat: np.ndarray, n_epochs: int = 8):
    """An ``n_epochs`` streaming stitch of geococo rounds with per-node exec
    stages and a cadence clock (``tests/test_analysis.py``'s)."""
    n = lat.shape[0]
    rng = np.random.default_rng(11)
    trace = lat_mod.jitter_trace(lat, n_epochs, rng)
    rounds = [builders(sched_mod, plan_mod, ep)["geococo"] for ep in trace]
    exec_ms = rng.uniform(0.05, 0.6, size=(n_epochs, n))
    return sched_mod.stitch_schedules(rounds, node_exec_ms=exec_ms.tolist(), epoch_ms=2.0, n=n)


def bases(topo: str, n_epochs: int = 8) -> tuple[dict, dict]:
    """The reference's and the port's base schedules on one topology."""
    lat = TOPOLOGIES[topo]
    out = []
    for s, p, l in ((ref, rplan, ref), (psched, pplan, plat)):
        b = builders(s, p, lat)
        b["stitched"] = stitched(s, p, l, lat, n_epochs)
        out.append(b)
    return tuple(out)


def form(sched) -> tuple:
    return ([dataclasses.astuple(t) for t in sched.transfers], sched.phase_of)


def same_violations(got, want) -> None:
    assert [(v.rule, v.index, v.message) for v in got] == \
        [(v.rule, v.index, v.message) for v in want]


# ---------------------------------------------------------------------------
# the one-shot verifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_builders_and_stitched_streams_verify_as_the_reference(topo):
    n = TOPOLOGIES[topo].shape[0]
    want, got = bases(topo)
    for name in want:
        assert form(got[name]) == form(want[name]), name
        assert pcheck.verify_schedule(got[name], n_nodes=n) == \
            ranalysis.verify_schedule(want[name], n_nodes=n) == [], name
    assert max(t.epoch for t in got["stitched"].transfers) == 7
    assert sum(t.tag == "clock" for t in got["stitched"].transfers) == 7


def test_legacy_phase_form_and_the_counter():
    sched = psched.TransmissionSchedule([
        [psched.Transfer(0, 1, 10.0), psched.Transfer(1, 2, 10.0)],
        [psched.Transfer(2, 0, 10.0)],
    ])
    assert pcheck.verify_schedule(sched, n_nodes=3) == []
    pcheck.reset_verified_schedule_count()
    assert pcheck.verify_schedule(psched.all_to_all_schedule(4, PAYLOAD), n_nodes=4) == []
    assert pcheck.verified_schedule_count() == 1
    bad = psched.all_to_all_schedule(4, PAYLOAD)
    bad.transfers[0] = dataclasses.replace(bad.transfers[0], nbytes=-1.0)
    assert [v.rule for v in pcheck.verify_schedule(bad, n_nodes=4)] == ["negative-payload"]
    assert pcheck.verified_schedule_count() == 1


def test_hand_seeded_mutations_report_as_the_reference():
    """``tests/test_analysis.py``'s hand-seeded defects, made alike on both
    sides: the same violations, rule, index and message."""
    def defects(lib):
        out = []
        s = lib.all_to_all_schedule(4, PAYLOAD)
        s.transfers[1] = dataclasses.replace(s.transfers[1], deps=(1, 5, -1))
        out.append(s)
        s = lib.all_to_all_schedule(4, PAYLOAD)
        s.transfers[0] = dataclasses.replace(s.transfers[0], nbytes=float("nan"),
                                             compute_ms=-1.0, via=0, dst=7)
        out.append(s)
        s = lib.all_to_all_schedule(3, PAYLOAD)
        s.transfers[2] = dataclasses.replace(s.transfers[2], dst=s.transfers[2].src)
        s.transfers[3] = dataclasses.replace(s.transfers[3], epoch=3)
        out.append(s)
        return out

    for got, want in zip(defects(psched), defects(ref)):
        same_violations(pcheck.verify_schedule(got, n_nodes=4),
                        ranalysis.verify_schedule(want, n_nodes=4))


# ---------------------------------------------------------------------------
# mutators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_mutants_equal_the_reference_and_are_all_caught(topo):
    """From one seed, each mutator's output equals the reference's transfer
    for transfer and reports the same violations; the port catches every
    mutant (the reference's 100% rate) and never flags a base; every rule
    applies somewhere."""
    n = TOPOLOGIES[topo].shape[0]
    want, got = bases(topo, n_epochs=4)
    rrng, prng = np.random.default_rng(20250807), np.random.default_rng(20250807)
    assert list(pmutate.MUTATORS) == list(rmutate.MUTATORS)
    applicable, caught, total = set(), 0, 0
    for name in sorted(got):
        for rule in sorted(pmutate.MUTATORS):
            for _ in range(3):
                r = rmutate.MUTATORS[rule](want[name], rrng, n_nodes=n)
                p = pmutate.MUTATORS[rule](got[name], prng, n_nodes=n)
                assert (p is None) == (r is None), (name, rule)
                if p is None:
                    continue
                assert form(p) == form(r), (name, rule)
                vs = pcheck.verify_schedule(p, n_nodes=n)
                same_violations(vs, ranalysis.verify_schedule(r, n_nodes=n))
                applicable.add(rule)
                total += 1
                caught += rule in {v.rule for v in vs}
        assert pcheck.verify_schedule(got[name], n_nodes=n) == []
    assert caught == total > 0
    assert applicable == set(pmutate.MUTATORS)


def test_mutate_schedule_rejects_unknown_rule():
    with pytest.raises(ValueError, match="unknown rule"):
        pmutate.mutate_schedule(psched.all_to_all_schedule(4, PAYLOAD), "no-such-rule",
                                np.random.default_rng(0))


def test_every_mutator_is_rejected_by_the_verified_simulator():
    """For each rule, a mutant of a geococo round or a stitched stream makes
    ``WANSimulator(verify=True).run`` raise ``ScheduleVerificationError``
    naming that rule; off by default, the corrupt schedule would run."""
    _, got = bases("alibaba_like", n_epochs=4)
    lat = TOPOLOGIES["alibaba_like"]
    n = lat.shape[0]
    rng = np.random.default_rng(3)
    for rule in sorted(pmutate.MUTATORS):
        mut = next(m for m in (pmutate.mutate_schedule(got[b], rule, rng, n_nodes=n)
                               for b in ("geococo", "stitched")) if m is not None)
        with pytest.raises(pcheck.ScheduleVerificationError) as err:
            psim.WANSimulator(lat, 500.0, verify=True).run(mut)
        assert rule in {v.rule for v in err.value.violations}
        assert isinstance(err.value, ValueError)
    bad = psched.all_to_all_schedule(n, PAYLOAD)
    bad.transfers[0] = dataclasses.replace(bad.transfers[0], nbytes=-1.0)
    psim.WANSimulator(lat, 500.0).run(bad)


# ---------------------------------------------------------------------------
# the per-epoch verifier
# ---------------------------------------------------------------------------


def append_epochs(lib_check, lib_sched, rounds, mutate=None):
    """Drive ``StitchState`` and ``StreamScheduleVerifier`` of one side over
    ``rounds``; ``mutate(k, seg, ranks, base)`` corrupts a segment first
    (``base``: the stream index of its first transfer)."""
    v = lib_check.StreamScheduleVerifier(n_nodes=4)
    st = lib_sched.StitchState(4, epoch_ms=2.0)
    out = []
    for k, sk in enumerate(rounds):
        seg, ranks = st.append(sk, [1.0] * st.n)
        ranks = list(ranks)
        if mutate is not None:
            seg = mutate(k, list(seg), ranks, st.size - len(seg))
        out.append(v.check_epoch(seg, ranks, frontier=st.frontier()))
    return out, v, st


def evicted_dep(k, seg, ranks, base):
    if k == 2:
        i = next(j for j, t in enumerate(seg) if t.tag == "exec")
        seg[i] = dataclasses.replace(seg[i], deps=seg[i].deps + (0,))
    return seg


def wrong_epoch(k, seg, ranks, base):
    if k == 1:
        seg[-1] = dataclasses.replace(seg[-1], epoch=7)
    return seg


def broken_clock(k, seg, ranks, base):
    if k == 2:
        i = next(j for j, t in enumerate(seg) if t.tag == "clock")
        seg[i] = dataclasses.replace(seg[i], deps=())
    return seg


def same_rank(k, seg, ranks, base):
    if k == 1:  # a wire depending on a same-rank wire
        seg[-1] = dataclasses.replace(seg[-1], deps=seg[-1].deps + (base + len(seg) - 2,))
        ranks[-1] = ranks[-2]
    return seg


@pytest.mark.parametrize("mutate", [None, evicted_dep, wrong_epoch, broken_clock, same_rank],
                         ids=["clean", "evicted-dep", "wrong-epoch", "broken-clock",
                              "same-rank"])
def test_stream_verifier_equals_the_reference(mutate):
    from repro.analysis import schedule_check as rcheck
    from repro.core import schedule as rsched

    rounds = {lib: [lib.all_to_all_schedule(4, PAYLOAD), lib.leader_schedule(4, 2, PAYLOAD),
                    lib.all_to_all_schedule(4, PAYLOAD)] for lib in (rsched, psched)}
    rcheck.reset_verified_schedule_count()
    pcheck.reset_verified_schedule_count()
    want, rv, _ = append_epochs(rcheck, rsched, rounds[rsched], mutate)
    got, pv, st = append_epochs(pcheck, psched, rounds[psched], mutate)
    for a, b in zip(got, want):
        same_violations(a, b)
    assert pcheck.verified_schedule_count() == rcheck.verified_schedule_count()
    assert (pv.epoch, pv.size) == (rv.epoch, rv.size) == (3, st.size)
    if mutate is None:
        assert got == [[], [], []] and pcheck.verified_schedule_count() == 3
    else:
        assert any(got)


# ---------------------------------------------------------------------------
# verification through the engines
# ---------------------------------------------------------------------------


def verified_runs(build, run):
    """``build(verify)`` gives the reference's and the port's engines,
    generators and traces; returns the reference's verified run, the port's
    verified and unverified runs, and each side's count of verified
    schedules."""
    from repro.analysis import schedule_check as rcheck

    (re, rg, rt), (pe, pg, pt) = build(True)
    rcheck.reset_verified_schedule_count()
    pcheck.reset_verified_schedule_count()
    want = run(re, rg, rt)
    got = run(pe, pg, pt)
    counts = (rcheck.verified_schedule_count(), pcheck.verified_schedule_count())
    _, (pe, pg, pt) = build(False)
    plain = run(pe, pg, pt)
    assert pcheck.verified_schedule_count() == counts[1]
    return want, got, plain, counts


@pytest.mark.parametrize("barrier", [False, True], ids=["event", "barrier"])
@pytest.mark.parametrize("strategy", ["flat", "geococo"])
def test_verified_engine_run_only_observes(strategy, barrier):
    want, got, plain, (rn, pn) = verified_runs(
        lambda v: engines(strategy, barrier, epochs=4, verify_schedules=v),
        lambda e, g, t: e.run(g, t, txns_per_node=8))
    check_runs(want, got)
    check_runs(plain, got)
    assert pn == rn == 4          # one round an epoch


@pytest.mark.parametrize("mode", ["incremental", "resim"])
@pytest.mark.parametrize("feedback", [False, True], ids=["streamed", "views"])
def test_verified_streaming_run_only_observes(mode, feedback):
    want, got, plain, (rn, pn) = verified_runs(
        lambda v: streaming_engines("ycsb", epochs=6, stream_mode=mode,
                                    staleness_feedback=feedback, verify_schedules=v),
        lambda e, g, t: e.run(g, t, txns_per_node=8, n_epochs=6))
    check_runs(want, got)
    check_runs(plain, got)
    assert pn == rn > 6
    if feedback:
        assert got.read_aborts == want.read_aborts > 0


def test_verified_streaming_run_with_the_reference_settings():
    """``tests/test_analysis.py``'s streaming engine case, both sides with
    verification: the same report and count."""
    lat = TOPOLOGIES["alibaba_like"]
    n = lat.shape[0]
    cfg = dict(n_nodes=n, streaming=True, grouping=True, filtering=True, tiv=True,
               planner="kcenter", epoch_ms=2.0, txn_exec_us=5.0, verify_schedules=True,
               modeled_cpu=True)
    ycsb = dict(n_keys=200, theta=0.9, read_ratio=0.3, hot_write_frac=0.3)
    from repro.analysis import schedule_check as rcheck
    from repro_torch.core.workload import YCSBConfig, YCSBGenerator

    rcheck.reset_verified_schedule_count()
    pcheck.reset_verified_schedule_count()
    want = ref.GeoCluster(ref.EngineConfig(**cfg), bandwidth_mbps=100.0, seed=7).run(
        ref.YCSBGenerator(ref.YCSBConfig(**ycsb), n, seed=3),
        ref.jitter_trace(lat, 4, np.random.default_rng(17)), txns_per_node=10, n_epochs=4)
    got = GeoCluster(EngineConfig(**cfg), bandwidth_mbps=100.0, seed=7, device="cpu").run(
        YCSBGenerator(YCSBConfig(**ycsb), n, seed=3),
        plat.jitter_trace(lat, 4, np.random.default_rng(17)), txns_per_node=10, n_epochs=4)
    check_runs(want, got)
    assert pcheck.verified_schedule_count() == rcheck.verified_schedule_count() == 8


# ---------------------------------------------------------------------------
# the determinism lint
# ---------------------------------------------------------------------------


def lint_form(violations) -> list:
    return [(v.rule, Path(v.file).name, v.line) for v in violations]


@pytest.mark.parametrize("fixture,rule", [
    ("wallclock.py", "wallclock"),
    ("module_rng.py", "module-rng"),
    ("unordered_set.py", "unordered-set-iter"),
    ("dict_iter.py", "unordered-dict-iter"),
    ("float_sum.py", "float-sum-unordered"),
    ("mutable_default.py", "mutable-default"),
    ("float_eq.py", "float-time-eq"),
    ("clean.py", None),
])
def test_lint_fixture_as_the_reference(fixture, rule):
    got = plint.lint_file(FIXTURES / fixture)
    assert lint_form(got) == lint_form(rlint.lint_file(FIXTURES / fixture))
    assert [v.rule for v in got] == ([rule] if rule else [])


@pytest.mark.parametrize("fixture", ["torch_rng.py", "torch_seed.py"])
def test_lint_torch_draws_trip_module_rng_once(fixture):
    """The port's ``module-rng`` also covers torch's global generator: each
    fixture trips it exactly once (its seeded-generator draws pass); the
    reference's lint, numpy's rule only, passes both."""
    got = plint.lint_file(TORCH_FIXTURES / fixture)
    assert [v.rule for v in got] == ["module-rng"], got
    assert rlint.lint_file(TORCH_FIXTURES / fixture) == []


def test_port_tree_is_lint_clean():
    violations = plint.lint_paths([REPO / "src" / "repro_torch"])
    assert violations == [], "\n".join(str(v) for v in violations)
    assert {"join_rows", "top_rows", "merge_rows", "digests", "_digests", "_changes"} <= \
        plint.CRITICAL_FUNCS and rlint.CRITICAL_FUNCS <= plint.CRITICAL_FUNCS


def test_lint_cli():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.analysis.lint"]
    dirty = subprocess.run(cmd + [str(TORCH_FIXTURES / "torch_rng.py")],
                           capture_output=True, text=True, env=env, cwd=REPO)
    assert dirty.returncode == 1 and "module-rng" in dirty.stdout
    clean = subprocess.run(cmd + [str(FIXTURES / "clean.py")],
                           capture_output=True, text=True, env=env, cwd=REPO)
    assert clean.returncode == 0, clean.stdout + clean.stderr
