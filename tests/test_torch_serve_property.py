"""Hypothesis property tests of the port's serving plane
(``repro_torch.serve``): ``tests/test_property_serve.py``'s bound
monotonicity on the port, and the port's ``simulate_serving`` equal to the
reference's, field for field, on every drawn instance.  Neither side
imports JAX here.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="dev-only dependency; see requirements-dev.txt")

import hypothesis.strategies as st
from hypothesis import given, settings

import repro.serve as rserve
from repro_torch import serve as pserve


@st.composite
def serving_instance(draw):
    """A random (commit matrix, latency matrix, cadence, bound pair,
    policy, cache size): ``tests/test_property_serve.py``'s, with a cache."""
    n = draw(st.integers(2, 5))
    n_epochs = draw(st.integers(1, 6))
    epoch_ms = draw(st.floats(1.0, 50.0))
    # cumulative per-(epoch, node) delays: each node's commit column rises,
    # as node_commit_ms guarantees
    gaps = np.array([[draw(st.floats(0.0, 120.0)) for _ in range(n)] for _ in range(n_epochs)])
    commit = np.cumsum(gaps + 0.1, axis=0)
    lat = np.array([[0.0 if i == j else draw(st.floats(1.0, 100.0)) for j in range(n)]
                    for i in range(n)])
    lat = (lat + lat.T) / 2.0
    b1, b2 = draw(st.floats(0.0, 300.0)), draw(st.floats(0.0, 300.0))
    policy = draw(st.sampled_from(["redirect", "reject"]))
    cache = draw(st.sampled_from([0, 1, 50]))
    return commit, lat, epoch_ms, min(b1, b2), max(b1, b2), policy, cache


def serve(lib, commit, lat, epoch_ms, bound, policy, cache):
    cfg = lib.ServeConfig(clients_per_node=1e6, max_staleness_ms=bound, policy=policy,
                          cache_keys=cache, n_keys=1000)
    return lib.simulate_serving(cfg, commit, [lat] * commit.shape[0], epoch_ms,
                                wall_ms=float(commit.max()))


def fields(s) -> tuple:
    return ([dataclasses.asdict(e) for e in s.epochs], dataclasses.asdict(s.totals),
            s.latency_values_ms.tolist(), s.latency_weights.tolist(), s.summary())


@given(serving_instance())
@settings(max_examples=60, deadline=None)
def test_tightening_the_bound_is_monotone_and_equals_the_reference(inst):
    commit, lat, epoch_ms, s1, s2, policy, cache = inst
    runs = {}
    for bound in (s1, s2):
        got = serve(pserve, commit, lat, epoch_ms, bound, policy, cache)
        assert fields(got) == fields(serve(rserve, commit, lat, epoch_ms, bound, policy, cache))
        runs[bound] = got
    tight, loose = runs[s1], runs[s2]
    # tightening never increases stale serves, never decreases redirects or
    # rejects; served reads rise with the bound
    assert tight.stale_served <= loose.stale_served + 1e-6
    assert tight.redirected >= loose.redirected - 1e-6
    assert tight.rejected >= loose.rejected - 1e-6
    assert tight.served_reads <= loose.served_reads + 1e-6
    # conservation, and reject within redirect, each epoch
    for r in runs.values():
        for e in r.epochs:
            assert e.served + e.rejected == pytest.approx(e.reads)
            if policy == "redirect":
                assert e.rejected <= e.redirected + 1e-9
            else:
                assert e.redirected == 0.0
