"""The port's pod exchange (``repro_torch.dist``) against the reference's
``repro.dist.collectives`` on the CPU, on per-pod inputs.

The port runs as 2, 3 and 4 gloo ranks (``launch.mesh.run_local_ranks``,
a ``FileStore`` in a temporary directory, each world joined within
``RANK_TIMEOUT`` seconds).  The reference runs in a child process with 8
forced host devices, on a ``(P, 1, 1)`` mesh built with ``Auto`` axes
(fault 1), calling its collectives in a fully manual ``shard_map`` whose
inputs are stacked over a leading pod axis (``in_specs=P("pod")``; fault 2),
so each pod holds its own gradients and residuals.  Both sides draw the
inputs from one numpy seed; they come back as ``.npz``.

Tolerances: the relay ring adds, on every pod, in the order of the
reference's pod ``order[0]``, and is held to that pod's sum bit for bit
(the reference's other pods add in their own orders); the all-reduce sums in gloo's order, held
to the reference's ``psum`` within 1e-6 of the largest value.  Synced
values and residuals within 1e-6 relative to each leaf's largest value;
the geococo mask (the entries whose residual became 0) is the same set on
every leaf.  The inputs are random normal, so no two magnitudes in a
chunk tie and the reference's lower-index tie rule never decides
(``torch.topk`` promises no order on a tie).  ``estimate_sync_bytes`` is
held exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.control import events as ref_events
from repro_torch.configs.registry import get_smoke_config
from repro_torch.control import events as port_events
from repro_torch.core import strategies
from repro_torch.dist import collectives as col
from repro_torch.dist.grouping import group_like_reference
from repro_torch.dist.sharding import param_specs
from repro_torch.launch.mesh import run_local_ranks
from repro_torch.models.model import init_params
from repro_torch.tree import leaves

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
ORDERS = {2: (1, 0), 3: (2, 0, 1), 4: (3, 1, 0, 2)}
# leaves a pod holds: "s" does not fill its last chunk (600 = 9 x 64 + 24),
# "b" is below MIN_LEAF and goes dense under geococo
SHAPES = {"w": (5, 100), "b": (37,), "s": (3, 4, 50)}
CHUNK, MIN_LEAF = 64, 100
CASES = [(s, d, ring) for s in ("flat", "hier", "geococo") for d in (0.25, 1.0)
         for ring in (False, True)]
SYNC_PODS = (2, 3)
REL = 1e-6
# estimate_sync_bytes over the rwkv6-7b smoke tree: its norm and bias leaves
# hold 64 values a layer, 128 stacked over its 2 layers, so a min_leaf_size
# of 100 sends them densely per layer and filters them stacked; chunks of 48
# cross the layer boundary
EST_ARCH, EST_CHUNK, EST_MIN_LEAF, EST_DENSITY = "rwkv6-7b", 48, 100, 0.25
EST_CASES = [(s, n, f) for s in ("flat", "hier", "geococo") for n in (2, 4) for f in (1.0, 2.0)]
BAD_CONFIGS = {"strategy": dict(strategy="bogus"), "density0": dict(density=0.0),
               "density_high": dict(density=1.5), "chunk": dict(chunk=0),
               "min_leaf_size": dict(min_leaf_size=-1), "ring_order": dict(ring_order=(0, 2))}
SPEC_MESHES = [(2, 1, 1), (2, 2, 2), (1, 2, 4), (1, 4, 2)]


def pod_inputs(n: int) -> list[dict[str, tuple[np.ndarray, np.ndarray]]]:
    """Per pod, per leaf: (gradient, residual), f32 random normal."""
    rng = np.random.default_rng(100 + n)
    return [{k: (rng.normal(size=s).astype(np.float32), rng.normal(size=s).astype(np.float32))
             for k, s in SHAPES.items()} for _ in range(n)]


def sync_cfg_kwargs(strategy, density, ring, n):
    return dict(strategy=strategy, density=density, chunk=CHUNK, min_leaf_size=MIN_LEAF,
                ring_order=ORDERS[n] if ring else None)


def case_key(n, strategy, density, ring):
    return f"{n}/{strategy}/{density}/{int(ring)}"


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def reference_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P

    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.dist import collectives as rcol
    from repro.dist import sharding as rsharding
    from repro.models import model as jax_model

    def podmap(n, body):
        mesh = jax.make_mesh((n, 1, 1), ("pod", "data", "model"),
                             axis_types=(AxisType.Auto,) * 3, devices=jax.devices()[:n])
        return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("pod"), out_specs=P("pod"),
                                     check_vma=False))

    def stacked(inputs, leaf, i):
        return jnp.asarray(np.stack([pod[leaf][i] for pod in inputs]))

    arrays = {}
    for n in (2, 3, 4):
        inputs = pod_inputs(n)
        order = ORDERS[n]

        def ring(x, order=order):
            x = x[0]
            return jnp.stack([rcol.relay_psum(x, "pod", order=order),
                              jax.lax.psum(x, "pod")])[None]

        out = np.asarray(podmap(n, ring)(stacked(inputs, "w", 0)))
        arrays[f"relay/{n}"], arrays[f"psum/{n}"] = out[:, 0], out[:, 1]
        if n not in SYNC_PODS:
            continue
        for strategy, density, ring_ in CASES:
            cfg = rcol.SyncConfig(**sync_cfg_kwargs(strategy, density, ring_, n))

            def body(g, r, cfg=cfg, n=n):
                g = {k: v[0] for k, v in g.items()}
                r = {k: v[0] for k, v in r.items()} if cfg.needs_residuals else None
                out, res = rcol.sync_gradients(g, r, cfg, axis="pod", n_pods=n)
                res = res if res is not None else g
                return ({k: v[None] for k, v in out.items()}, {k: v[None] for k, v in res.items()})

            g = {k: stacked(inputs, k, 0) for k in SHAPES}
            r = {k: stacked(inputs, k, 1) for k in SHAPES}
            out, res = podmap(n, body)(g, r)
            key = case_key(n, strategy, density, ring_)
            for k in SHAPES:
                arrays[f"sync/{key}/{k}/out"] = np.asarray(out[k])
                arrays[f"sync/{key}/{k}/res"] = np.asarray(res[k])
            if strategy == "geococo":
                def topk(g, r, density=density, order=cfg.ring_order):
                    out, res = rcol.chunked_topk_exchange(g[0], r[0], axis="pod", density=density,
                                                          chunk=CHUNK, order=order)
                    return jnp.stack([out, res])[None]

                both = np.asarray(podmap(n, topk)(stacked(inputs, "s", 0), stacked(inputs, "s", 1)))
                arrays[f"topk/{key}/out"], arrays[f"topk/{key}/res"] = both[:, 0], both[:, 1]
    np.savez(os.path.join(out_dir, "reference.npz"), **arrays)

    jcfg = jax_smoke(EST_ARCH)
    tree = jax.eval_shape(lambda: jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    estimates = {}
    for strategy, n, factor in EST_CASES:
        cfg = rcol.SyncConfig(strategy, density=EST_DENSITY, chunk=EST_CHUNK,
                              min_leaf_size=EST_MIN_LEAF)
        estimates[f"{strategy}/{n}/{factor}"] = [
            rcol.estimate_sync_bytes(tree, cfg, n, shard_factor=factor),
            rcol.estimate_sync_bytes(123_457, cfg, n, shard_factor=factor)]
    messages = {}
    for name, kw in BAD_CONFIGS.items():
        try:
            rcol.SyncConfig(**kw)
        except ValueError as err:
            messages[name] = str(err)
    for n in SYNC_PODS:
        try:
            rcol.sync_gradients({"a": jnp.zeros(3)}, None,
                                rcol.SyncConfig("hier", ring_order=tuple(range(n + 1))), n_pods=n)
        except ValueError as err:
            messages[f"ring_cover/{n}"] = str(err)

    class FakeMesh:
        def __init__(self, shape):
            self.shape = dict(zip(("pod", "data", "model"), shape))

    specs = {}
    for arch in ("rwkv6-7b", "recurrentgemma-9b"):
        t = jax.eval_shape(lambda a=arch: jax_model.init_params(jax_smoke(a), jax.random.PRNGKey(0)))
        for shape in SPEC_MESHES:
            for strategy in ("hier", "flat"):
                got = rsharding.param_specs(t, FakeMesh(shape), strategy)
                flat = jax.tree_util.tree_flatten_with_path(
                    got, is_leaf=lambda x: isinstance(x, P))[0]
                specs[f"{arch}/{shape}/{strategy}"] = {
                    "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): list(spec)
                    for path, spec in flat}
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump({"estimates": estimates, "messages": messages, "specs": specs}, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, __file__, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    arrays = dict(np.load(out_dir / "reference.npz"))
    return arrays, json.loads((out_dir / "reference.json").read_text())


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------


def port_rank(rank: int, n: int) -> dict:
    """Everything one pod of an n-pod world computes, as numpy."""
    group = col.PodGroup()
    mine = pod_inputs(n)[rank]
    g = {k: torch.from_numpy(v[0]) for k, v in mine.items()}
    r = {k: torch.from_numpy(v[1]) for k, v in mine.items()}
    out = {"relay": col.relay_psum(g["w"], group, ORDERS[n]).numpy(),
           "all_reduce": group.all_reduce_sum(g["w"]).numpy()}
    if n not in SYNC_PODS:
        return out
    for strategy, density, ring in CASES:
        cfg = col.SyncConfig(**sync_cfg_kwargs(strategy, density, ring, n))
        key = case_key(n, strategy, density, ring)
        group.stats = col.WireStats()
        synced, res = col.sync_gradients(g, dict(r) if cfg.needs_residuals else None, cfg,
                                         group=group)
        for k in SHAPES:
            out[f"sync/{key}/{k}/out"] = synced[k].numpy()
            out[f"sync/{key}/{k}/res"] = (res if res is not None else g)[k].numpy()
        out[f"stats/{key}"] = np.array([group.stats.dense_values, group.stats.sparse_values])
        if strategy == "geococo":
            sent, new_res = col.chunked_topk_exchange(g["s"], r["s"], group, density=density,
                                                      chunk=CHUNK, order=cfg.ring_order)
            out[f"topk/{key}/out"], out[f"topk/{key}/res"] = sent.numpy(), new_res.numpy()
    try:
        col.sync_gradients(g, None, col.SyncConfig("hier", ring_order=tuple(range(n + 1))),
                           group=group)
    except ValueError as err:
        out["ring_cover"] = str(err)
    return out


@pytest.fixture(scope="module")
def port():
    return {n: run_local_ranks(port_rank, n, (n,), timeout=RANK_TIMEOUT) for n in (2, 3, 4)}


def stacked_port(port, n, key):
    return np.stack([pod[key] for pod in port[n]])


def assert_rel(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: max abs err {err:.3e}, scale {scale:.3e}"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_relay_psum_matches_reference_bit_for_bit(n, port, reference):
    arrays, _ = reference
    got = stacked_port(port, n, "relay")
    first = arrays[f"relay/{n}"][ORDERS[n][0]]       # the reference's pod order[0]
    for pod in got:
        np.testing.assert_array_equal(pod, first)
    assert_rel(got, arrays[f"psum/{n}"], "relay vs psum")


@pytest.mark.parametrize("n", [2, 3, 4])
def test_all_reduce_matches_psum(n, port, reference):
    arrays, _ = reference
    got = stacked_port(port, n, "all_reduce")
    assert_rel(got, arrays[f"psum/{n}"], "all-reduce vs psum")
    assert all((pod == got[0]).all() for pod in got), "the pods' sums differ"


@pytest.mark.parametrize("n", SYNC_PODS)
@pytest.mark.parametrize("strategy,density,ring", CASES)
def test_sync_gradients_matches_reference(n, strategy, density, ring, port, reference):
    arrays, _ = reference
    key = case_key(n, strategy, density, ring)
    for leaf in SHAPES:
        for part in ("out", "res"):
            name = f"sync/{key}/{leaf}/{part}"
            got, want = stacked_port(port, n, name), arrays[name]
            assert_rel(got, want, name)
            if part == "res" and strategy == "geococo":
                np.testing.assert_array_equal(got == 0, want == 0, err_msg=f"{name}: mask")
    for leaf in SHAPES:
        out = stacked_port(port, n, f"sync/{key}/{leaf}/out")
        assert all((pod == out[0]).all() for pod in out), f"{leaf}: the pods' synced gradients differ"


@pytest.mark.parametrize("n", SYNC_PODS)
@pytest.mark.parametrize("density,ring", [(0.25, False), (0.25, True), (1.0, False), (1.0, True)])
def test_chunked_topk_exchange_matches_reference(n, density, ring, port, reference):
    arrays, _ = reference
    key = case_key(n, "geococo", density, ring)
    for part in ("out", "res"):
        got, want = stacked_port(port, n, f"topk/{key}/{part}"), arrays[f"topk/{key}/{part}"]
        assert_rel(got, want, part)
    res = stacked_port(port, n, f"topk/{key}/res")
    k = max(1, round(density * CHUNK))
    # k kept per chunk; the last chunk's 40 padding zeros may be among them
    kept = (res.reshape(n, -1) == 0).sum(axis=1)
    assert ((kept >= 10 * k - 40) & (kept <= 10 * min(k, CHUNK))).all(), kept
    if density == 1.0:
        assert (res == 0).all()


@pytest.mark.parametrize("n", SYNC_PODS)
@pytest.mark.parametrize("strategy,density,ring", CASES)
def test_wire_counts_equal_estimate(n, strategy, density, ring, port):
    """The values a pod's exchange counted (dense leaves, mask selections)
    give estimate_sync_bytes over the same leaves exactly."""
    cfg = col.SyncConfig(**sync_cfg_kwargs(strategy, density, ring, n))
    leaves_ = [torch.empty(s) for s in SHAPES.values()]
    for pod in port[n]:
        dense, sparse = pod[f"stats/{case_key(n, strategy, density, ring)}"]
        ring_factor = 2.0 * (n - 1) / n
        assert ring_factor * (dense * 4 + sparse * 8) == col.estimate_sync_bytes(leaves_, cfg, n)


@pytest.mark.parametrize("n", SYNC_PODS)
def test_ring_order_must_cover_the_pods(n, port, reference):
    _, ref = reference
    want = ref["messages"][f"ring_cover/{n}"]
    assert [pod["ring_cover"] for pod in port[n]] == [want] * n


def test_one_pod_is_the_identity():
    g, r = {"a": torch.ones(3)}, {"a": torch.zeros(3)}
    for strategy in ("flat", "hier", "geococo"):
        out, res = col.sync_gradients(g, r, col.SyncConfig(strategy))
        assert out is g and res is r
        out, res = col.sync_gradients(g, None, col.SyncConfig(strategy), group=None)
        assert out is g and res is None


@pytest.mark.parametrize("strategy,n_pods,shard_factor", EST_CASES)
def test_estimate_over_grouped_tree_matches_reference(strategy, n_pods, shard_factor, reference):
    _, ref = reference
    want_tree, want_count = ref["estimates"][f"{strategy}/{n_pods}/{shard_factor}"]
    cfg = col.SyncConfig(strategy, density=EST_DENSITY, chunk=EST_CHUNK,
                         min_leaf_size=EST_MIN_LEAF)
    smoke = get_smoke_config(EST_ARCH)
    per_layer = leaves(init_params(smoke, None, "meta"))
    grouped = group_like_reference(smoke, per_layer)
    assert col.estimate_sync_bytes(grouped, cfg, n_pods, shard_factor=shard_factor) == want_tree
    assert col.estimate_sync_bytes(123_457, cfg, n_pods, shard_factor=shard_factor) == want_count
    if strategy == "geococo" and shard_factor == 1.0:
        # per layer the norms would go dense: another wire
        assert col.estimate_sync_bytes(per_layer, cfg, n_pods) != want_tree


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_sync_config_rejects_like_reference(name, reference):
    _, ref = reference
    with pytest.raises(ValueError) as err:
        col.SyncConfig(**BAD_CONFIGS[name])
    assert str(err.value) == ref["messages"][name]


def test_registry_holds_the_reference_names():
    assert strategies.names("device_sync") == ["flat", "geococo", "hier"]
    assert "device_sync" in strategies.kinds()
    assert [name for name, _ in strategies.items("device_sync")] == ["flat", "geococo", "hier"]
    assert strategies.get("device_sync", "geococo").needs_residuals
    with pytest.raises(KeyError, match="no 'device_sync' strategy named 'bogus'"):
        strategies.get("device_sync", "bogus")


@pytest.mark.parametrize("strategy,reacts", [("flat", False), ("hier", True), ("geococo", True)])
def test_react_to_relay_order_events_of_each_package(strategy, reacts):
    from repro.dist.collectives import SyncConfig as RefSyncConfig

    kw = dict(round=3, order=(1, 2, 0), previous=(0, 1, 2))
    cfg, ref_cfg = col.SyncConfig(strategy), RefSyncConfig(strategy)
    port_event, ref_event = port_events.RelayOrderChanged(**kw), ref_events.RelayOrderChanged(**kw)
    want = ref_cfg.spec.react(ref_cfg, ref_event) if ref_cfg.spec.react else None
    got = cfg.spec.react(cfg, port_event) if cfg.spec.react else None
    assert (got is not None) == reacts == (want is not None)
    if reacts:
        assert got.ring_order == want.ring_order == (1, 2, 0)
        assert cfg.spec.react(got, port_event) is None          # already on that ring
        # the port tests isinstance against its own class: the reference's event is not one
        assert cfg.spec.react(cfg, ref_event) is None
    other = port_events.LinkDegraded(round=1, i=0, j=1, baseline_ms=1.0, observed_ms=3.0)
    assert cfg.spec.react is None or cfg.spec.react(cfg, other) is None


def test_group_plan_validates_like_reference():
    from repro.core.planner import GroupPlan as RefPlan

    from repro_torch.core.planner import GroupPlan

    for groups, aggs, n in [(((0, 1), (2,)), (0, 2), 3), (((0, 1), (1,)), (0, 1), None),
                            (((0,), (2,)), (0, 2), 3), (((0, 1),), (2,), None)]:
        errs = []
        for cls in (RefPlan, GroupPlan):
            plan = cls(groups, aggs)
            try:
                plan.validate(n)
                errs.append(None)
            except ValueError as err:
                errs.append(str(err))
            assert (plan.k, plan.n) == (len(groups), sum(map(len, groups)))
        assert errs[0] == errs[1]
    assert list(GroupPlan(((0, 2), (1,)), (0, 1)).group_of()) == [0, 1, 0]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
@pytest.mark.parametrize("shape", SPEC_MESHES)
@pytest.mark.parametrize("strategy", ["hier", "flat"])
def test_param_specs_match_reference(arch, shape, strategy, reference):
    _, ref = reference
    cfg = get_smoke_config(arch)
    grouped = group_like_reference(cfg, leaves(init_params(cfg, None, "meta")))
    got = param_specs(grouped, dict(zip(("pod", "data", "model"), shape)), strategy)
    want = {k: tuple(v) for k, v in ref["specs"][f"{arch}/{shape}/{strategy}"].items()}
    assert got == want
    if shape[1:] == (1, 1):
        assert all(axis is None for spec in got.values() for axis in spec)


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
