"""The port's bounded model checker (``repro_torch.analysis.modelcheck``)
against the reference's on the CPU: at smoke scope every theorem's
instances, violations and info equal the reference's ``run_tier`` (the
table theorems run on the port's ``CRDTTable``\\ s, its tensor OCC pass and
its ``advance_views``, on the CPU here); the four seeded mutants are
rejected with the reference's count of violations each; the greedy corpus
rebuilds and replays; the checker's state equality agrees with the digest;
``CRDTTable.merge_store`` equals the reference store's; the CLI; and
``chip_smoke.py``'s phase 36 constants equal the reference's figures.  The
smoke tier and the self-test run once per module.  The reference's checker
is numpy only: neither side imports JAX here.
"""

import importlib.util
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.analysis.modelcheck as rmc
import repro.core as ref
import repro_torch.analysis.modelcheck as pmc
from repro_torch.core.crdt import CRDTTable, Update, Version

REPO = Path(__file__).resolve().parents[1]

# tests/test_modelcheck.py's pinned instance: greedy loses 42.6% to the barrier
PINNED_TRI_LOSS = [
    (0, 1, 250_000.0, ()),
    (1, 2, 25_000.0, ()),
    (0, 1, 250_000.0, (1,)),
    (2, 0, 25_000.0, (0,)),
]


@pytest.fixture(scope="module")
def smoke():
    """The reference's and the port's smoke tier (no self-test), and the
    port's per-theorem counters after its run."""
    want = rmc.run_tier(rmc.scope_for("smoke"), selftest=False)
    pmc.reset_model_checked_count()
    got = pmc.run_tier(pmc.scope_for("smoke"), selftest=False, device="cpu")
    counters = {t: pmc.model_checked_count(t) for t in pmc.THEOREMS}
    return want, got, counters


@pytest.fixture(scope="module")
def selftest():
    """Each seeded mutant's report, the reference's and the port's."""
    s = rmc._SELFTEST_SCOPE
    want = {
        "broken-admission-ranking": rmc.check_admission(
            s, simulator_factory=rmc._ZeroRankSimulator),
        "non-commutative-merge": rmc.check_confluence(s, store_factory=rmc._LastArrivalStore),
        "occ-reinstatement": rmc.check_abort_monotonicity(
            s, validate=rmc._reinstating_validate),
        "frontier-under-read": rmc.check_eviction(s, evict_floor=lambda vn: int(vn.min()) + 1),
    }
    return want, pmc.selftest_reports("cpu")


def chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("theorem", list(rmc.THEOREMS))
def test_smoke_theorem_equals_the_reference(smoke, theorem):
    want, got, counters = smoke
    a = next(t for t in want.theorems if t.name == theorem)
    b = next(t for t in got.theorems if t.name == theorem)
    assert b.instances == a.instances > 0
    assert b.violations == a.violations == []
    assert b.info == a.info
    assert counters[theorem] == b.instances


def test_smoke_figures_and_counters(smoke):
    _, got, counters = smoke
    assert got.ok and got.tier == "smoke"
    assert got.counts() == {"admission": 1840, "confluence": 14, "occ_atomicity": 7992,
                            "abort_monotonicity": 1024, "eviction_prefix": 196}
    info = {t.name: t.info for t in got.theorems}
    assert info["admission"]["mutants"] == "840/840"
    assert info["admission"]["corpus_size"] == 38
    assert info["occ_atomicity"]["write_skew_instances"] == 48
    assert sum(counters.values()) == sum(got.counts().values())
    pmc.reset_model_checked_count()
    assert pmc.model_checked_count() == 0


@pytest.mark.parametrize("mutant", ["broken-admission-ranking", "non-commutative-merge",
                                    "occ-reinstatement", "frontier-under-read"])
def test_seeded_mutant_rejected_as_the_reference(selftest, mutant):
    want, got = selftest
    assert len(got[mutant].violations) == len(want[mutant].violations) > 0
    assert got[mutant].instances == want[mutant].instances
    assert [v.rule for v in got[mutant].violations] == \
        [v.rule for v in want[mutant].violations]


def test_run_selftest_rejects_all_four(selftest, monkeypatch):
    _, got = selftest
    monkeypatch.setattr(pmc, "selftest_reports", lambda device=None: got)
    assert pmc.run_selftest("cpu") == {
        "broken-admission-ranking": True,
        "non-commutative-merge": True,
        "occ-reinstatement": True,
        "frontier-under-read": True,
    }
    assert any("frontier under-read" in v.message
               for v in got["frontier-under-read"].violations)


def test_pinned_counterexample_and_the_corpus_replay(smoke):
    sched = pmc.TransmissionSchedule(
        [pmc.Transfer(s, d, nb, deps=deps) for s, d, nb, deps in PINNED_TRI_LOSS],
        label="pinned")
    lat, bw = pmc._lat_matrix(3), pmc._bw_matrix(3, "tri")
    barrier = pmc.WANSimulator(lat, bw).barrier_makespan_ms(sched)
    assert pmc.WANSimulator(lat, bw).run(sched).makespan_ms <= barrier * (1 + 1e-9) + 1e-6
    greedy = pmc.WANSimulator(lat, bw, admission=False).run(sched).makespan_ms
    assert greedy / barrier - 1.0 == pytest.approx(0.4258, abs=5e-4)
    corpus = next(t for t in smoke[1].theorems if t.name == "admission").info["corpus"]
    assert len(corpus) == 38
    for entry in corpus:
        sched, lat, bw = pmc.rebuild_counterexample(entry)
        g = pmc.WANSimulator(lat, bw, admission=False).run(sched).makespan_ms
        b = pmc.WANSimulator(lat, bw).barrier_makespan_ms(sched)
        assert (g, b) == (entry["greedy_ms"], entry["barrier_ms"]) and g > b


def checker_tables() -> list[CRDTTable]:
    """Tables as the checker makes them: every subset of the confluence
    universe at the quick scope joined in, and values, lengths and versions
    that differ in one field only."""
    keys = ("k0", "k1")
    versions = [Version(0, s, nd) for s in range(2) for nd in range(2)]
    universe = [Update(k, pmc._uval(k, v), v) for k in keys for v in versions]
    out = []
    for r in range(0, 3):
        for combo in itertools.combinations(universe, r):
            t = CRDTTable(2, pmc._VALUE_BYTES, device="cpu")
            t.apply_many(combo)
            out.append(t)
    for value, ver in ((b"v", Version(1, 0, 0)), (b"v\0", Version(1, 0, 0)),
                       (b"w", Version(1, 0, 0)), (b"v", Version(1, 0, 1))):
        t = CRDTTable(2, pmc._VALUE_BYTES, device="cpu")
        t.apply_many([Update("k1", value, ver)])
        out.append(t)
    return out


def test_state_equality_agrees_with_the_digest():
    tables = checker_tables()
    digests = [t.digest() for t in tables]
    states = [t.full_state() for t in tables]
    same = 0
    for i, j in itertools.combinations_with_replacement(range(len(tables)), 2):
        got = pmc.same_state(tables[i], tables[j])
        assert got == (digests[i] == digests[j]) == (states[i] == states[j]), (i, j)
        same += got and i != j
    assert same > 0


def test_merge_store_equals_the_reference():
    """Random updates split over two replicas, one merged into the other: the port's
    ``merge_store`` (top_rows, join_rows, crdt_merge_rows' plain version
    here) ends where the reference store's does."""
    rng = np.random.default_rng(0)
    for trial in range(20):
        ups = [Update(f"k{int(rng.integers(0, 6))}", bytes(rng.integers(0, 256, 3).tolist()),
                      Version(int(rng.integers(0, 2)), int(rng.integers(0, 3)),
                              int(rng.integers(0, 2)))) for _ in range(8)]
        side = rng.integers(0, 2, len(ups))
        got = [CRDTTable(6, 8, device="cpu") for _ in range(2)]
        want = [ref.DeltaCRDTStore() for _ in range(2)]
        for u, s in zip(ups, side):
            got[s].apply_many([u])
            v = u.version
            want[s].apply(ref.Update(u.key, u.value, ref.Version(v.epoch, v.seq, v.node)))
        merges = got[0].merges
        got[0].merge_store(got[1])
        want[0].merge_store(want[1])
        assert got[0].digest() == want[0].digest(), trial
        assert got[0].merges == merges + bool(len(got[1]))
    with pytest.raises(ValueError, match="one layout"):
        CRDTTable(6, 8, device="cpu").merge_store(CRDTTable(5, 8, device="cpu"))


def test_modelcheck_cli():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.analysis.modelcheck", "--tier", "smoke",
           "--device", "cpu"]
    res = subprocess.run(cmd + ["--only", "confluence", "--no-selftest"],
                         capture_output=True, text=True, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "confluence" in res.stdout and "14 instances" in res.stdout
    assert "ok" in res.stderr
    bad = subprocess.run(cmd + ["--only", "no-such-theorem"], capture_output=True, text=True,
                         env=env, cwd=REPO)
    assert bad.returncode != 0


def test_chip_smoke_constants_equal_the_reference(smoke, selftest):
    """Phase 36 gates the card's checker on constants: the reference's smoke
    figures and its seeded mutants' violations."""
    cs = chip_smoke_module()
    want = {t.name: (t.instances, {k: v for k, v in t.info.items() if k != "corpus"})
            for t in smoke[0].theorems}
    assert cs.MODELCHECK_SMOKE == want
    assert cs.MODELCHECK_MUTANTS == {k: len(r.violations) for k, r in selftest[0].items()}


def test_table_theorems_default_to_the_card():
    """Without ``device`` the checker's tables go to the card, as every entry
    point of the port's does; with no card that raises."""
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmc.check_confluence(pmc.scope_for("smoke"))
