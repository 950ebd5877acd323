"""In-pod sharding (``repro_torch.dist.sharding``, ``dist.inpod``,
``dist.grouping``) against the reference on the CPU, on meshes (2, 2, 1),
(2, 1, 2) and (2, 2, 2) of gloo ranks.

The reference runs in a child process with 8 forced host devices, its
meshes built with ``Auto`` axes (fault 1), and writes what it computed:

* the block each device holds of every leaf of the smoke configs of
  rwkv6-7b, minitron-8b and granite-moe-3b-a800m, grouped as it stacks
  them (``NamedSharding(mesh, param_specs(...)).devices_indices_map``);
* ``sync_gradients`` on every device's block of a per-pod gradient of
  rwkv6-7b's smoke tree, in a fully manual ``shard_map`` over the whole
  mesh (fault 2): inputs stacked over a leading pod axis, each leaf's
  spec ``P("pod", *param_spec)``, for flat, hier and geococo at density
  0.25 and 1.0, each with and without the relay ring (1, 0);
* one ``adamw_update`` of that tree with the clip biting, and its
  ``global_norm``.

The port's ranks (``launch.mesh.run_local_ranks``, within
``RANK_TIMEOUT`` seconds) take their blocks by ``local_shard`` per layer
and group them, and hold every rank's result against the same block of
the reference's.  Tolerances: blocks and the grouped-shard identity bit
for bit; synced values and residuals within 1e-6 of each leaf's largest
value and the geococo mask (the entries whose residual became 0) the same
set (the inputs are random normal, so no two magnitudes in a chunk tie);
the wire values counted equal to ``estimate_sync_bytes`` over the rank's
blocks exactly; the norm rtol 1e-6 and the parameters after AdamW rtol =
atol = 1e-6 (``test_torch_train_step.py``'s tolerance with the clip: the
norm sums in another order).  On each mesh granite-moe-3b-a800m's smoke
config at capacity factor 1.25 also steps, its synced gradient against the
port's own one process with a microbatch per routing group (within 1e-5),
and ``DistContext``'s expert layout is held against the reference's.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import collectives as col
from repro_torch.dist.context import DistContext
from repro_torch.dist.grouping import (group_like_reference, grouped_specs, leaf_specs, ungroup,
                                       zero_residuals)
from repro_torch.dist.inpod import InPodGroup
from repro_torch.dist.sharding import (batch_rows, fit_batch_axes, local_shape, local_shard,
                                       shard_factor, unshard)
from repro_torch.launch.mesh import AXES, check_mesh_shape, make_mesh, run_local_ranks
from repro_torch.launch.train import StatePlacement
from repro_torch.models.model import init_params
from repro_torch.optim import adamw
from repro_torch.train.train_step import SyncGrads, TrainConfig, grads_and_loss
from repro_torch.tree import leaf_paths, leaves

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
MESHES = [(2, 2, 1), (2, 1, 2), (2, 2, 2)]
ARCHS = ["rwkv6-7b", "minitron-8b", "granite-moe-3b-a800m"]
SYNC_ARCH = "rwkv6-7b"
# chunks of 48 cross the layer boundary inside a stacked block; the stacked
# norms (128 values, replicated) are filtered, the final norm (64) is not
CHUNK, MIN_LEAF = 48, 100
CASES = [(s, d, ring) for s, d in (("flat", 1.0), ("hier", 1.0), ("geococo", 0.25),
                                   ("geococo", 1.0)) for ring in (False, True)]
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=4, grad_clip=1.0)
REL = 1e-6


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def case_key(shape, strategy, density, ring) -> str:
    return f"{mesh_key(shape)}/{strategy}/{density}/{int(ring)}"


def sync_cfg_kwargs(strategy, density, ring):
    return dict(strategy=strategy, density=density, chunk=CHUNK, min_leaf_size=MIN_LEAF,
                ring_order=(1, 0) if ring else None)


def grouped_meta(arch: str) -> dict[str, torch.Tensor]:
    cfg = get_smoke_config(arch)
    return group_like_reference(cfg, leaves(init_params(cfg, None, "meta")))


def pod_gradients(n_pods: int = 2) -> list[dict[str, np.ndarray]]:
    """Per pod, a whole gradient of the rwkv6 smoke tree, grouped; f32
    random normal."""
    rng = np.random.default_rng(22)
    shapes = {k: tuple(v.shape) for k, v in grouped_meta(SYNC_ARCH).items()}
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n_pods)]


def pod_residuals(n_pods: int = 2) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(23)
    shapes = {k: tuple(v.shape) for k, v in grouped_meta(SYNC_ARCH).items()}
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(n_pods)]


def adamw_inputs() -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Parameters N(0, 1) and a gradient N(0, 3^2), grouped: the clip at
    1.0 bites."""
    rng = np.random.default_rng(24)
    shapes = {k: tuple(v.shape) for k, v in grouped_meta(SYNC_ARCH).items()}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.normal(0, 3, size=s).astype(np.float32) for k, s in shapes.items()}
    return p, g


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def reference_main(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.dist import collectives as rcol
    from repro.dist import sharding as rsharding
    from repro.models import model as jax_model
    from repro.optim import adamw as jadamw

    def make(shape):
        return jax.make_mesh(shape, AXES, axis_types=(AxisType.Auto,) * 3,
                             devices=jax.devices()[:math.prod(shape)])

    def key_of(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

    def specs_by_key(arch, mesh):
        """The reference's spec of every leaf of its (nested) tree, by key."""
        tree = jax.eval_shape(lambda: jax_model.init_params(jax_smoke(arch), jax.random.PRNGKey(0)))
        specs = rsharding.param_specs(tree, mesh, "hier")
        flat_specs = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
        return {key_of(path): (leaf, spec) for (path, leaf), (_, spec)
                in zip(jax.tree_util.tree_flatten_with_path(tree)[0], flat_specs)}

    blocks = {}
    for shape in MESHES:
        mesh = make(shape)
        where = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
                 for d in mesh.devices.flat}
        for arch in ARCHS:
            for key, (leaf, spec) in specs_by_key(arch, mesh).items():
                index = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
                blocks[f"{mesh_key(shape)}/{arch}/{key}"] = {
                    "".join(map(str, where[d.id])): [[s.start or 0, n if s.stop is None else s.stop]
                                                     for s, n in zip(sl, leaf.shape)]
                    for d, sl in index.items()}

    arrays = {}
    grads, res = pod_gradients(), pod_residuals()
    keys = list(grads[0])
    for shape in MESHES:
        mesh = make(shape)
        specs = specs_by_key(SYNC_ARCH, mesh)
        pod_specs = {k: P("pod", *specs[k][1]) for k in keys}
        g = {k: jnp.asarray(np.stack([pod[k] for pod in grads])) for k in keys}
        r = {k: jnp.asarray(np.stack([pod[k] for pod in res])) for k in keys}
        for strategy, density, ring in CASES:
            cfg = rcol.SyncConfig(**sync_cfg_kwargs(strategy, density, ring))

            def body(g, r, cfg=cfg):
                g = {k: v[0] for k, v in g.items()}
                r = {k: v[0] for k, v in r.items()} if cfg.needs_residuals else None
                out, new_r = rcol.sync_gradients(g, r, cfg, axis="pod", n_pods=shape[0])
                new_r = new_r if new_r is not None else g
                return ({k: v[None] for k, v in out.items()},
                        {k: v[None] for k, v in new_r.items()})

            run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(pod_specs, pod_specs),
                                        out_specs=(pod_specs, pod_specs), check_vma=False))
            out, new_r = run(g, r)
            key = case_key(shape, strategy, density, ring)
            for k in keys:
                arrays[f"{key}/{k}/out"] = np.asarray(out[k])
                arrays[f"{key}/{k}/res"] = np.asarray(new_r[k])

    p, g = adamw_inputs()
    opt = jadamw.AdamWConfig(**OPT)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    new_p, _, metrics = jadamw.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                            jadamw.adamw_init(jp, opt), opt)
    arrays.update({f"adamw/{k}": np.asarray(v) for k, v in new_p.items()})
    arrays["adamw_norm"] = np.asarray(metrics["grad_norm"])
    arrays["global_norm"] = np.asarray(jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    np.savez(os.path.join(out_dir, "reference.npz"), **arrays)
    with open(os.path.join(out_dir, "blocks.json"), "w") as f:
        json.dump(blocks, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, __file__, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return (dict(np.load(out_dir / "reference.npz")),
            json.loads((out_dir / "blocks.json").read_text()))


# ---------------------------------------------------------------------------
# the port, on gloo ranks
# ---------------------------------------------------------------------------


def rank_blocks(cfg, full_grouped: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """This rank's blocks of a whole grouped tree, taken as the train step
    takes them: per layer, by ``leaf_specs``, then grouped."""
    per_layer = ungroup(cfg, full_grouped)
    specs = leaf_specs(cfg, mesh.shape, "hier").values()
    return group_like_reference(cfg, [local_shard(leaf, spec, mesh.coords, mesh.shape)
                                      for leaf, spec in zip(per_layer, specs, strict=True)])


def port_rank(rank: int, shape: tuple) -> dict:
    mesh, groups = make_mesh(shape, device="cpu")
    cfg = get_smoke_config(SYNC_ARCH)
    out = {"coords": dict(mesh.coords),
           "groups": {a: sorted(torch.distributed.get_process_group_ranks(g))
                      for a, g in groups.items()}}
    pod = mesh.coords["pod"]
    grads = {k: torch.from_numpy(v) for k, v in pod_gradients()[pod].items()}
    res = {k: torch.from_numpy(v) for k, v in pod_residuals()[pod].items()}
    g_blocks, r_blocks = rank_blocks(cfg, grads, mesh), rank_blocks(cfg, res, mesh)
    group = col.PodGroup(mesh.get_group("pod"))
    for strategy, density, ring in CASES:
        sync = col.SyncConfig(**sync_cfg_kwargs(strategy, density, ring))
        group.stats = col.WireStats()
        synced, new_r = col.sync_gradients(g_blocks, dict(r_blocks) if sync.needs_residuals
                                           else None, sync, group=group)
        key = case_key(shape, strategy, density, ring)
        out[key] = {"out": {k: v.numpy() for k, v in synced.items()},
                    "res": {k: v.numpy() for k, v in (new_r or g_blocks).items()},
                    "counted": 2.0 * (2 - 1) / 2 * (4 * group.stats.dense_values
                                                    + 8 * group.stats.sparse_values),
                    "model": col.estimate_sync_bytes(g_blocks, sync, 2)}
    # one AdamW step on blocks, the clip from the norm of the whole gradient
    inpod = InPodGroup(mesh)
    p, g = adamw_inputs()
    p_blocks = rank_blocks(cfg, {k: torch.from_numpy(v) for k, v in p.items()}, mesh)
    g_blocks = rank_blocks(cfg, {k: torch.from_numpy(v) for k, v in g.items()}, mesh)
    specs = grouped_specs(cfg, mesh.shape, "hier")
    opt = adamw.AdamWConfig(**OPT)
    norm = inpod.global_norm(list(g_blocks.values()), [specs[k] for k in g_blocks])
    _, _, metrics = adamw.adamw_update(p_blocks, g_blocks, adamw.adamw_init(p_blocks, opt), opt,
                                       gnorm=norm)
    out["adamw"] = {k: v.numpy() for k, v in p_blocks.items()}
    out["adamw_norm"] = float(metrics["grad_norm"])
    out["moe"] = moe_against_one_process(mesh)
    # the in-pod collectives, each against its definition
    base = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    for spec in (("data", "model"), ("data", None), (None, "model")):
        block = local_shard(base, spec, mesh.coords, mesh.shape)
        out[f"gathered/{spec}"] = inpod.gather(block, spec).numpy()
    x = base * (1 + torch.distributed.get_rank())
    out["reduced"] = inpod.reduce_scatter_mean(x, ("data", "model")).numpy()
    out["reduced_rep"] = inpod.reduce_scatter_mean(x, ()).numpy()
    out["inpod_bytes"] = inpod.stats.bytes_sent
    return out


def moe_against_one_process(mesh) -> dict[str, float]:
    """granite-moe-3b-a800m's smoke config at capacity factor 1.25, one hier
    step's synced gradient on ``mesh`` against one process's over the
    global batch with as many microbatches as the mesh has routing groups
    (each pod's rows, with ``model`` above 1 each ``data`` rank's):
    per leaf, the largest difference of this rank's block over the
    largest value of the one-process gradient's block."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    tcfg = TrainConfig(sync=col.SyncConfig("hier"), compute_dtype=torch.float32)
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                                   seed=0)).batch(0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    blocks = StatePlacement(cfg, tcfg, torch.device("cpu"), mesh).place(whole, "params")
    grads, _, _ = SyncGrads(cfg, tcfg, "cpu", mesh)(blocks, batch)
    groups = mesh.shape["pod"] * (mesh.shape["data"] if mesh.shape["model"] > 1 else 1)
    want, _ = grads_and_loss(cfg, dataclasses.replace(tcfg, microbatches=groups), whole, batch)
    specs = leaf_specs(cfg, mesh.shape, "hier")
    out = {}
    for (key, _), got, w in zip(leaf_paths(whole), grads, want, strict=True):
        w = local_shard(w, specs[key], mesh.coords, mesh.shape)
        out[key] = float((got - w).abs().max() / w.abs().max().clamp_min(1e-30))
    return out


@pytest.fixture(scope="module")
def port():
    return {mesh_key(s): run_local_ranks(port_rank, math.prod(s), (s,), timeout=RANK_TIMEOUT)
            for s in MESHES}


def ref_block(full: np.ndarray, spec, coords: dict, shape) -> np.ndarray:
    sizes = dict(zip(AXES, shape))
    return local_shard(torch.from_numpy(np.ascontiguousarray(full)), spec, coords, sizes).numpy()


def assert_rel(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: max abs err {err:.3e}, scale {scale:.3e}"


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_local_shard_is_the_references_block(arch, shape, reference):
    _, blocks = reference
    sizes = dict(zip(AXES, shape))
    grouped = grouped_meta(arch)
    specs = grouped_specs(get_smoke_config(arch), sizes, "hier")
    for key, leaf in grouped.items():
        full = torch.arange(leaf.numel(), dtype=torch.float32).reshape(leaf.shape)
        want = blocks[f"{mesh_key(shape)}/{arch}/{key}"]
        assert len(want) == math.prod(shape)
        for place, bounds in want.items():
            coords = dict(zip(AXES, map(int, place)))
            got = local_shard(full, specs[key], coords, sizes)
            index = tuple(slice(a, b) for a, b in bounds)
            assert torch.equal(got, full[index]), (key, place)
            assert tuple(got.shape) == local_shape(leaf.shape, specs[key], sizes)
        assert shard_factor(specs[key], sizes) * math.prod(got.shape) == leaf.numel()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_grouping_blocks_is_the_block_of_the_grouped_leaf(arch, shape):
    """The scan axis is never split and the rule shifts right by one, so
    stacking every layer's block gives the grouped leaf's block, on every
    rank; ``unshard`` inverts ``local_shard``."""
    cfg = get_smoke_config(arch)
    sizes = dict(zip(AXES, shape))
    per_layer = leaves(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    grouped = group_like_reference(cfg, per_layer)
    specs = grouped_specs(cfg, sizes, "hier")
    layer_specs = list(leaf_specs(cfg, sizes, "hier").values())
    residuals = zero_residuals(cfg, "cpu", sizes, "geococo")
    for d in range(shape[1]):
        for m in range(shape[2]):
            coords = {"pod": 1, "data": d, "model": m}
            mine = group_like_reference(cfg, [local_shard(p, s, coords, sizes)
                                              for p, s in zip(per_layer, layer_specs)])
            assert list(mine) == list(grouped)
            for key, block in mine.items():
                assert torch.equal(block, local_shard(grouped[key], specs[key], coords, sizes)), key
                assert block.shape == residuals[key].shape, key
    for key, leaf in grouped.items():
        order = [{"data": d, "model": m} for d in range(shape[1]) for m in range(shape[2])
                 if (d == 0 or "data" in specs[key]) and (m == 0 or "model" in specs[key])]
        back = unshard([local_shard(leaf, specs[key], c, sizes) for c in order], specs[key], sizes)
        assert torch.equal(back, leaf), key


@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_ranks_sit_row_major_over_the_axes(shape, port):
    for rank, got in enumerate(port[mesh_key(shape)]):
        p, d, m = shape
        assert got["coords"] == {"pod": rank // (d * m), "data": rank // m % d, "model": rank % m}
        first = rank - rank % (d * m)
        assert got["groups"]["inpod"] == list(range(first, first + d * m))
        assert got["groups"]["pod"] == [rank % (d * m) + i * d * m for i in range(p)]
        assert got["groups"]["model"] == list(range(rank - rank % m, rank - rank % m + m))


@pytest.mark.parametrize("strategy,density,ring", CASES)
@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_sync_gradients_on_every_ranks_block_matches_reference(shape, strategy, density, ring,
                                                               port, reference):
    arrays, _ = reference
    key = case_key(shape, strategy, density, ring)
    specs = grouped_specs(get_smoke_config(SYNC_ARCH), dict(zip(AXES, shape)), "hier")
    for got in port[mesh_key(shape)]:
        coords = got["coords"]
        for leaf, spec in specs.items():
            for part in ("out", "res"):
                want = ref_block(arrays[f"{key}/{leaf}/{part}"][coords["pod"]], spec, coords,
                                 shape)
                assert_rel(got[key][part][leaf], want, f"{key} {leaf} {part} at {coords}")
                if part == "res" and strategy == "geococo":
                    np.testing.assert_array_equal(got[key][part][leaf] == 0, want == 0,
                                                  err_msg=f"{key} {leaf}: mask at {coords}")
        assert got[key]["counted"] == got[key]["model"], (key, coords)
    # the ranks of one pod group (one data, model coordinate) hold the same synced blocks
    ranks = port[mesh_key(shape)]
    per_pod = math.prod(shape[1:])
    for r in range(per_pod):
        for leaf in specs:
            assert np.array_equal(ranks[r][key]["out"][leaf], ranks[r + per_pod][key]["out"][leaf])


@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_global_norm_clip_on_blocks_matches_reference(shape, port, reference):
    arrays, _ = reference
    specs = grouped_specs(get_smoke_config(SYNC_ARCH), dict(zip(AXES, shape)), "hier")
    for got in port[mesh_key(shape)]:
        np.testing.assert_allclose(got["adamw_norm"], float(arrays["global_norm"]), rtol=REL)
        np.testing.assert_allclose(got["adamw_norm"], float(arrays["adamw_norm"]), rtol=REL)
        for leaf, spec in specs.items():
            want = ref_block(arrays[f"adamw/{leaf}"], spec, got["coords"], shape)
            np.testing.assert_allclose(got["adamw"][leaf], want, rtol=1e-6, atol=1e-6,
                                       err_msg=leaf)
    norms = {got["adamw_norm"] for got in port[mesh_key(shape)]}
    assert len(norms) == 1, "the ranks clip by different norms"


@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_in_pod_collectives_follow_their_definitions(shape, port):
    """``gather`` returns the whole leaf; ``reduce_scatter_mean`` a rank's
    block of the mean over ``data`` (each rank's x is its rank + 1 times
    the same tensor), its own ``model`` block taken without a message."""
    sizes = dict(zip(AXES, shape))
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    ranks = port[mesh_key(shape)]
    for rank, got in enumerate(ranks):
        coords = got["coords"]
        for spec in (("data", "model"), ("data", None), (None, "model")):
            np.testing.assert_array_equal(got[f"gathered/{spec}"], x.numpy())
        first = rank - coords["data"] * shape[2]            # data 0 of this pod and model
        scale = sum(1 + first + d * shape[2] for d in range(shape[1])) / shape[1]
        mean = x * scale
        np.testing.assert_allclose(got["reduced"], local_shard(mean, ("data", "model"), coords,
                                                                sizes).numpy(), rtol=1e-7)
        np.testing.assert_allclose(got["reduced_rep"], mean.numpy(), rtol=1e-7)
        assert got["inpod_bytes"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=mesh_key)
def test_moe_step_on_a_sharded_mesh_agrees_with_one_process(shape, port):
    """An MoE steps on every mesh, ``model`` above 1 too: its synced
    gradient is one process's with a microbatch per routing group, within
    1e-5 of each block's largest value (f32, sums in other orders)."""
    for got in port[mesh_key(shape)]:
        worst = max(got["moe"], key=got["moe"].get)
        assert got["moe"][worst] <= 1e-5, (worst, got["moe"][worst])


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 2), (2, 2, 2), (4, 1, 4)], ids=mesh_key)
def test_expert_layout_is_the_references(shape):
    """``DistContext.experts`` on every ``model`` coordinate against the
    reference's expert-parallel layout (``repro.models.moe``,
    ``_moe_apply_manual_ep``): ``e_pad``, ``e_local`` and the offsets
    ``arange(dm) * e_local``, for the smoke config's 8 experts, the full
    config's 40 and counts that leave padded experts."""
    sizes = dict(zip(AXES, shape))
    dm = shape[2]
    for e in (8, 40, 3, 7):
        e_pad = -(-e // dm) * dm
        e_local = e_pad // dm
        offsets = np.arange(dm, dtype=np.int32) * e_local
        for m in range(dm):
            ctx = DistContext(sizes, {"pod": 0, "data": 0, "model": m})
            assert ctx.experts(e) == (e_pad, e_local, int(offsets[m]))
        assert e_pad >= e and e_pad - e < dm


@pytest.mark.parametrize("shape,world,error", [((2, 2, 1), 4, None), ((2, 1, 2), 4, None),
                                               ((2, 2, 2), 8, None), ((2, 2), 4, "a size each"),
                                               ((2, 0, 2), 0, "a size each"),
                                               ((2, 2, 1), 2, "the world has 2")])
def test_check_mesh_shape(shape, world, error):
    if error is None:
        check_mesh_shape(shape, world)
    else:
        with pytest.raises(ValueError, match=error):
            check_mesh_shape(shape, world)


@pytest.mark.parametrize("shape,rows,axes", [((2, 2, 1), 4, ("pod", "data")),
                                             ((2, 2, 2), 8, ("pod", "data")),
                                             ((2, 2, 1), 2, ("data",)), ((2, 3, 1), 4, ("pod",)),
                                             ((2, 2, 1), 1, ()), ((1, 1, 4), 4, ())])
def test_batch_rows_follow_fit_batch_axes(shape, rows, axes):
    """The reference's ``_fit_batch_axes`` (train_step.py:117-130); the
    rows of each rank row-major over those axes, ranks along ``model``
    sharing theirs."""
    sizes = dict(zip(AXES, shape))
    assert fit_batch_axes(sizes, rows) == axes
    taken = {}
    for p in range(shape[0]):
        for d in range(shape[1]):
            for m in range(shape[2]):
                own = batch_rows(sizes, {"pod": p, "data": d, "model": m}, rows)
                taken.setdefault((p, d), own)
                assert taken[(p, d)] == own
    n = math.prod(sizes[a] for a in axes)
    assert sorted({(s.start, s.stop) for s in taken.values()}) == [
        (i * rows // n, (i + 1) * rows // n) for i in range(n)]


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
