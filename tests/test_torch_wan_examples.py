"""The port's WAN-plane examples on the CPU against the reference's:
``examples/quickstart_torch.py`` against ``examples/quickstart.py`` (the
plan, the two single-round makespans, each run's epochs, throughput, WAN
bytes and digests) and the TPC-C half of
``examples/geo_database_sim_torch.py`` against
``examples/geo_database_sim.py``'s, field for field.  Each example runs as
it stands, the reference's results recorded from the names it calls; on
both sides the module's ``EngineConfig`` is bound to one that models the
filter's CPU time from its bytes, so that a run repeats exactly.  Neither
port example imports the reference.  Neither side imports JAX here.
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core as ref

from test_torch_geo_cluster import check_runs

REPO = Path(__file__).resolve().parents[1]


def load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_port(name: str):
    """A port example whose engine models its filter's CPU."""
    mod = load(name)
    mod.EngineConfig = functools.partial(mod.EngineConfig, modeled_cpu=True)
    return mod


def recording(mod, runs: list) -> None:
    """Bind the reference example's engine to one that models its filter's
    CPU and records every run."""
    mod.EngineConfig = functools.partial(ref.EngineConfig, modeled_cpu=True)

    class Cluster(ref.GeoCluster):
        def run(self, *a, **kw):
            out = super().run(*a, **kw)
            runs.append(out)
            return out

    mod.GeoCluster = Cluster


def test_quickstart_matches_the_reference():
    mod, runs, seen = load("quickstart"), [], {}
    recording(mod, runs)
    plan_fn, sim_cls = mod.best_plan, mod.WANSimulator
    mod.best_plan = lambda *a, **kw: seen.setdefault("plan", plan_fn(*a, **kw))

    class Sim(sim_cls):
        def run(self, schedule, *a, **kw):
            out = super().run(schedule, *a, **kw)
            seen.setdefault("makespans", []).append(out.makespan_ms)
            return out

    mod.WANSimulator = Sim
    mod.main()
    got = load_port("quickstart_torch").main(["--device", "cpu"])
    want_plan, plan = seen["plan"], got["plan"]
    assert (plan.groups, plan.aggregators, plan.k, plan.method, plan.objective) == \
        (want_plan.groups, want_plan.aggregators, want_plan.k, want_plan.method,
         want_plan.objective)
    assert list(got["makespans_ms"]) == seen["makespans"]
    assert len(runs) == 2
    for want, name in zip(runs, ("flat", "geococo")):
        check_runs(want, got["runs"][name])
    assert got["runs"]["flat"].state_digest == got["runs"]["geococo"].state_digest


def test_geo_database_sims_tpcc_half_matches_the_reference():
    """The reference example at 6 epochs of its trace (its TPC-C loop runs
    ``len(trace)`` epochs), stopped where its YCSB half begins."""
    mod, runs = load("geo_database_sim"), []
    recording(mod, runs)
    testbed = mod.paper_testbed
    mod.paper_testbed = lambda n_rounds, seed=0: testbed(6, seed)

    class Stop(Exception):
        pass

    def stop(*a, **kw):
        raise Stop

    mod.YCSBGenerator = stop
    with pytest.raises(Stop):
        mod.main()
    got = load_port("geo_database_sim_torch").main(
        ["--device", "cpu", "--epochs", "6", "--keys", "500"])
    assert len(runs) == 8
    mixes = [got["tpcc"][mix][name] for mix in ("TPCC-A", "TPCC-B", "TPCC-C", "TPCC-D")
             for name in ("GeoGauss", "+GeoCoCo")]
    for want, have in zip(runs, mixes):
        check_runs(want, have)
    for rows in got["tpcc"].values():
        assert rows["GeoGauss"].state_digest == rows["+GeoCoCo"].state_digest


@pytest.mark.parametrize("argv", [["quickstart_torch.py"],
                                  ["geo_database_sim_torch.py", "--epochs", "4", "--keys",
                                   "300", "--planner", "kcenter"]])
def test_the_examples_run_on_the_cpu_without_the_reference(argv):
    code = ("import runpy, sys\n"
            f"sys.argv = {argv + ['--device', 'cpu']!r}\n"
            f"runpy.run_path({str(REPO / 'examples' / argv[0])!r}, run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('repro', 'jax'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    if argv[0] == "quickstart_torch.py":
        assert "final replicated state identical across modes on cpu" in out.stdout
    else:
        assert out.stdout.count("state identical: True") == 5
        assert "run completed on cpu with consistent state" in out.stdout
