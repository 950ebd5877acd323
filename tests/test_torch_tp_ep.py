"""Tensor- and expert-parallel compute (``repro_torch.dist.context``, the
``model``-parallel regions of ``models.layers`` and ``models.moe``)
against the reference on the CPU.

The reference runs in a child process with 8 forced host devices, its
meshes built with ``Auto`` axes (fault 1), under its
``dist.context.distribution(mesh)``, and writes:

* ``_attend_tp`` on (1, 1, 2) and (1, 1, 3), three head layouts (one with
  padded q heads, one with a single kv head and a local window);
* ``moe_apply``'s output and the gradients of ``sum(out * ct)`` on
  (1, 1, 2), (1, 2, 2) and (1, 1, 3) (its expert parallelism: padded
  experts on (1, 1, 3)) and on (1, 2, 1) (its dense dispatch over the rows
  GSPMD splits over ``data``), at capacity factor 1.25 with the router
  jittered to N(0, 0.5) so that routing is decisive and drops bite;
* the gradient of ``loss_fn`` of granite-moe-3b-a800m's smoke config at
  capacity factor 1.25 on (1, 1, 2), for each half of a global batch.

The port computes the same on gloo ranks (``launch.mesh.run_local_ranks``)
or, for ``_attend_tp``, per ``model`` coordinate.  Tolerances: the head
layout bit for bit; outputs and gradients within 1e-6 of each tensor's
largest value (f32; the sums run in other orders); the pod gradient within
1e-5 of each leaf's largest value (the losses of two layers).
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jax_layers
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.collectives import SyncConfig
from repro_torch.dist.context import DistContext, distribution
from repro_torch.dist.grouping import leaf_specs
from repro_torch.dist.sharding import batch_rows, local_shard
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import AXES, make_mesh, run_local_ranks
from repro_torch.models import layers, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import SyncGrads, TrainConfig
from repro_torch.tree import leaf_paths

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
REL, POD_REL = 1e-6, 1e-5
# (name, model ranks, batch, seq, q heads, kv heads, head dim, window)
ATTEND = [("2 ranks, 4 q and 2 kv heads", 2, 2, 16, 4, 2, 8, 0),
          ("3 ranks, padded: 4 q and 2 kv heads", 3, 2, 16, 4, 2, 8, 0),
          ("2 ranks, one kv head, window 8", 2, 2, 16, 4, 1, 8, 8)]
EP_MESHES = [(1, 1, 2), (1, 2, 2), (1, 1, 3)]
DENSE_MESH = (1, 2, 1)
D, E, D_EXPERT, TOP_K, CF = 64, 8, 32, 2, 1.25
X_SHAPE = (2, 16, D)
ARCH = "granite-moe-3b-a800m"
POD_BATCH, POD_SEQ = 4, 16


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def attend_inputs(b, s, h, kv, hd):
    rng = np.random.default_rng(h * 10 + kv)
    return tuple(rng.normal(0, 1, (b, s, n, hd)).astype(np.float32) for n in (h, kv, kv))


def moe_inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, X_SHAPE).astype(np.float32)
    ct = rng.normal(0, 1, X_SHAPE).astype(np.float32)
    return x, ct


def granite(cf: float = CF):
    cfg = get_smoke_config(ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def pod_batch():
    cfg = get_smoke_config(ARCH)
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=POD_SEQ,
                                  global_batch=POD_BATCH, seed=0)).batch(0)


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def reference_main(out_dir: str) -> None:
    from jax.sharding import AxisType

    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.dist import context as dist_context
    from repro.models import model as jax_model
    from repro.models import moe as jax_moe
    from repro.train import train_step as jts

    def mesh_of(shape):
        return jax.make_mesh(shape, AXES, axis_types=(AxisType.Auto,) * 3,
                             devices=jax.devices()[:math.prod(shape)])

    def flat(tree, prefix):
        return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    out = {}
    for name, dm, b, s, h, kv, hd, window in ATTEND:
        mesh = mesh_of((1, 1, dm))

        def attend(q, k, v, h=h, hd=hd, window=window, mesh=mesh):
            with dist_context.distribution(mesh):
                return jax_layers._attend_tp(q, k, v, h, hd, causal=True, window=window)

        out[f"attend/{name}"] = np.asarray(jax.jit(attend)(*attend_inputs(b, s, h, kv, hd)))

    p = moe_params()
    x, ct = moe_inputs()
    for shape in EP_MESHES + [DENSE_MESH]:
        mesh = mesh_of(shape)

        def loss(p, x, mesh=mesh):
            with dist_context.distribution(mesh):
                y = jax_moe.moe_apply(p, x, top_k=TOP_K, capacity_factor=CF)
            return jnp.sum(y * ct), y

        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(p, x)
        key = mesh_key(shape)
        out[f"moe/{key}/out"] = np.asarray(y)
        out[f"moe/{key}/grad/x"] = np.asarray(gx)
        out.update(flat(gp, f"moe/{key}/grad/"))
    # per-row routing: what the port's dense dispatch computed on (1, 2, 1)
    # before it routed the pod's rows
    y0 = jax_moe._moe_apply_dense_dispatch(p, x[:1], top_k=TOP_K, capacity_factor=CF)
    y1 = jax_moe._moe_apply_dense_dispatch(p, x[1:], top_k=TOP_K, capacity_factor=CF)
    out["moe/per-rank/out"] = np.concatenate([np.asarray(y0), np.asarray(y1)])

    jcfg = jax_smoke(ARCH)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=CF))
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    out.update(flat(params, "pod/init/"))
    mesh = mesh_of((1, 1, 2))

    def grads(p, batch):
        with dist_context.distribution(mesh):
            return jax.value_and_grad(lambda q: jts.loss_fn(jcfg, q, batch, jnp.float32))(p)

    step = jax.jit(grads)
    batch = pod_batch()
    for pod in range(2):
        rows = slice(pod * POD_BATCH // 2, (pod + 1) * POD_BATCH // 2)
        loss, g = step(params, {k: jnp.asarray(v[rows]) for k, v in batch.items()})
        out[f"pod/{pod}/loss"] = np.asarray(loss)
        out.update(flat(g, f"pod/{pod}/grad/"))
    np.savez(os.path.join(out_dir, "tp_ep.npz"), **out)


def moe_params():
    from repro.models import moe as jax_moe

    p = jax.tree.map(np.array, jax_moe.moe_init(jax.random.PRNGKey(3), D, E, D_EXPERT))
    p["router"]["w"] = np.random.default_rng(3).normal(0, 0.5, (D, E)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, __file__, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out_dir / "tp_ep.npz"))


def sub(runs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in runs.items() if k.startswith(prefix)}


def assert_rel(got, want, what, rel=REL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e}, scale {scale:.3e}"


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------


def moe_rank(rank: int, shape: tuple, p: dict) -> dict:
    """``moe_apply`` on this rank's rows under its distribution context,
    and the gradients of ``sum(out * ct)`` over those rows."""
    mesh, _ = make_mesh(shape, device="cpu")
    x, ct = moe_inputs()
    rows = batch_rows(mesh.shape, mesh.coords, X_SHAPE[0])
    params = jax.tree.map(lambda v: torch.from_numpy(v).requires_grad_(), p)
    xt = torch.from_numpy(x[rows]).requires_grad_()
    ctx = DistContext.from_mesh(mesh, X_SHAPE[0])
    with distribution(ctx):
        out = moe.moe_apply(params, xt, top_k=TOP_K, capacity_factor=CF)
        (out * torch.from_numpy(ct[rows])).sum().backward()
    grads = {k: v.grad.numpy() for k, v in leaf_paths(params)}
    return {"coords": dict(mesh.coords), "rows": (rows.start, rows.stop),
            "out": out.detach().numpy(), "x": xt.grad.numpy(), "grads": grads,
            "tp_bytes": ctx.stats.bytes_sent}


@pytest.fixture(scope="module")
def port_moe():
    p = moe_params()
    return {mesh_key(s): run_local_ranks(moe_rank, math.prod(s), (s, p), timeout=RANK_TIMEOUT)
            for s in EP_MESHES + [DENSE_MESH]}


def pod_rank(rank: int, init: dict) -> dict:
    """This rank's block of its pod's gradient before the exchange, on
    (2, 1, 2)."""
    mesh, _ = make_mesh((2, 1, 2), device="cpu")
    cfg = granite()
    tcfg = TrainConfig(sync=SyncConfig("hier"), compute_dtype=torch.float32)
    whole = params_from_jax(cfg, init, device="cpu")
    params = train_mod.StatePlacement(cfg, tcfg, torch.device("cpu"), mesh).place(whole, "params")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pod_batch().items()}
    grads, loss = SyncGrads(cfg, tcfg, "cpu", mesh).local(params, batch)
    keys = [key for key, _ in leaf_paths(whole)]
    return {"coords": dict(mesh.coords), "loss": float(loss),
            "grads": {k: g.numpy() for k, g in zip(keys, grads)}}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,kv,dm", [(4, 2, 2), (4, 2, 3), (24, 8, 2), (32, 8, 3), (4, 1, 2),
                                     (12, 4, 6)])
def test_pad_heads_for_tp_is_the_references_layout(h, kv, dm):
    q, k, v = attend_inputs(2, 4, h, kv, 8)
    want = jax_layers.pad_heads_for_tp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dm)
    got = layers.pad_heads_for_tp(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  dm)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].shape[2] % dm == 0 and got[1].shape[2] % dm == 0
    # tp_heads: every real q head in exactly one rank's block, reading its own kv head
    seen = []
    for coord in range(dm):
        q_heads, kv_heads = layers.tp_heads(h, kv, dm, coord)
        group = len(q_heads) // len(kv_heads)
        for slot, head in enumerate(q_heads):
            if head >= 0:
                assert kv_heads[slot // group] == head // (h // kv)
                seen.append(head)
    assert sorted(seen) == list(range(h))


@pytest.mark.parametrize("case", ATTEND, ids=[c[0] for c in ATTEND])
def test_attend_tp_per_rank_sums_to_the_references(case, reference):
    """Each ``model`` rank attends its block of the padded layout; its real
    heads' outputs, put in their places and summed over the ranks, are
    the reference's ``_attend_tp``."""
    name, dm, b, s, h, kv, hd, window = case
    q, k, v = (torch.from_numpy(t) for t in attend_inputs(b, s, h, kv, hd))
    total = torch.zeros(b, s, h, hd)
    for coord in range(dm):
        q_heads, kv_heads = layers.tp_heads(h, kv, dm, coord)
        qs = torch.stack([q[:, :, i] if i >= 0 else torch.zeros_like(q[:, :, 0])
                          for i in q_heads], dim=2)
        ks, vs = k[:, :, kv_heads], v[:, :, kv_heads]
        out = layers._attend_tp(qs, ks, vs, q_heads, causal=True, window=window)
        total[:, :, [i for i in q_heads if i >= 0]] += out
    assert_rel(total.numpy(), reference[f"attend/{name}"], name)


@pytest.mark.parametrize("shape", EP_MESHES + [DENSE_MESH], ids=mesh_key)
def test_moe_on_a_mesh_matches_the_reference(shape, port_moe, reference):
    """Expert parallelism on (1, 1, 2), (1, 2, 2), (1, 1, 3), and dense
    dispatch over the pod's rows on (1, 2, 1): each rank's output rows and
    the gradient of its rows' input are the reference's; the parameters'
    gradients, summed over the ranks (each holds the part of its experts
    and rows), are the reference's."""
    want = sub(reference, f"moe/{mesh_key(shape)}/")
    ranks = port_moe[mesh_key(shape)]
    for got in ranks:
        rows = slice(*got["rows"])
        assert_rel(got["out"], want["out"][rows], f"out, rank {got['coords']}")
        assert_rel(got["x"], want["grad/x"][rows], f"x's gradient, rank {got['coords']}")
    for key in ranks[0]["grads"]:
        total = sum(got["grads"][key] for got in ranks)
        assert_rel(total, want[f"grad/{key}"], f"{key}'s gradient")
    assert all(got["tp_bytes"] > 0 for got in ranks)


def test_dense_dispatch_routes_the_pods_rows(port_moe, reference):
    """Fault 10: on (1, 2, 1) the reference routes the rows of every
    ``data`` rank together; routed per rank (as the port did) the output is
    another at this capacity factor."""
    want = reference[f"moe/{mesh_key(DENSE_MESH)}/out"]
    per_rank = reference["moe/per-rank/out"]
    assert np.abs(per_rank - want).max() > 0.05 * np.abs(want).max()
    got = np.concatenate([r["out"] for r in port_moe[mesh_key(DENSE_MESH)]])
    assert_rel(got, want, "the pod's output")


def test_expert_parallelism_differs_from_dense_dispatch_over_the_batch(reference):
    """On (1, 2, 2) the reference's experts see each ``data`` shard's tokens
    alone; over the whole batch the drops differ (the port follows the
    former, ``test_moe_on_a_mesh_matches_the_reference``)."""
    ep = reference[f"moe/{mesh_key((1, 2, 2))}/out"]
    dense = reference[f"moe/{mesh_key(DENSE_MESH)}/out"]
    assert np.abs(ep - dense).max() > 0.05 * np.abs(dense).max()
    assert_rel(reference[f"moe/{mesh_key((1, 1, 3))}/out"], dense, "padded experts")


def test_each_pods_gradient_is_the_references_on_its_rows(reference):
    """On (2, 1, 2) each pod routes and differentiates its own rows: every
    rank's block of its pod's gradient before the exchange is the block of
    the reference's (1, 1, 2) gradient on that pod's rows."""
    init = sub(reference, "pod/init/")
    ranks = run_local_ranks(pod_rank, 4, (init,), timeout=RANK_TIMEOUT)
    cfg = granite()
    sizes = dict(zip(AXES, (2, 1, 2)))
    specs = leaf_specs(cfg, sizes, "hier")
    for got in ranks:
        pod = got["coords"]["pod"]
        want = params_from_jax(cfg, sub(reference, f"pod/{pod}/grad/"), device="cpu")
        np.testing.assert_allclose(got["loss"], reference[f"pod/{pod}/loss"], rtol=1e-6)
        for key, w in leaf_paths(want):
            block = local_shard(w, specs[key], got["coords"], sizes).numpy()
            assert_rel(got["grads"][key], block, f"pod {pod} {key}", POD_REL)


def split_rows_rank(rank: int, init: dict, rows: int) -> None:
    mesh, _ = make_mesh((1, 2, 2), device="cpu")
    cfg = granite()
    tcfg = TrainConfig(sync=SyncConfig("hier"), compute_dtype=torch.float32)
    whole = params_from_jax(cfg, init, device="cpu")
    params = train_mod.StatePlacement(cfg, tcfg, torch.device("cpu"), mesh).place(whole, "params")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:rows])) for k, v in pod_batch().items()}
    SyncGrads(cfg, tcfg, "cpu", mesh).local(params, batch)


def test_expert_parallelism_refuses_rows_that_do_not_split_over_data(reference):
    """With ``data`` and ``model`` above 1 the reference's expert
    parallelism splits the tokens of a row over ``data`` when the rows do
    not split; the port splits rows, so it refuses a batch of one row on
    (1, 2, 2) (two rows step, ``test_torch_inpod_train.py``)."""
    with pytest.raises(RuntimeError, match="does not split over data"):
        run_local_ranks(split_rows_rank, 4, (sub(reference, "pod/init/"), 1),
                        timeout=RANK_TIMEOUT)


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
