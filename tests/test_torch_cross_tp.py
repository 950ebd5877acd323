"""Cross-attention with its heads split over ``model``
(``repro_torch.models.layers.gqa_apply`` with ``kv_source`` under a
distribution context), and llama-3.2-vision-90b's training step on a
``model``-parallel mesh, against the reference on the CPU.

The reference runs in a child process with 8 forced host devices, its
meshes built with ``Auto`` axes (fault 1), under its
``dist.context.distribution(mesh)``, and writes:

* ``gqa_apply(kv_source=...)``'s output and the gradients of ``sum(out *
  ct)`` for its parameters, its input and its context on (1, 1, 2) and
  (1, 1, 3), three head layouts: 4 q over 2 kv heads (clean on 2 ranks,
  padded on 3, as llama's smoke config is) and 4 q over one kv head;
* the loss and the gradient of every leaf of ``loss_fn`` in f32 for
  llama-3.2-vision-90b's smoke config (4 self-attention blocks, then the
  cross block over a 16-token image context) on (1, 1, 2) and (1, 2, 2),
  on one global batch with its image context drawn from a numpy seed.

The port computes the cross-attention per ``model`` coordinate under a
context without process groups (each coordinate's part: the region's
sums are the identity there), summed over the coordinates, and the step
on gloo ranks (``launch.mesh.run_local_ranks``) through
``SyncGrads.local``: each rank's blocks of its pod's gradient, before any
exchange.  ``test_torch_mla_mesh.py`` holds deepseek-v3-671b's step with
the helpers defined here.

Tolerances: outputs and gradients within 1e-6 of each tensor's largest
value (f32; the sums run in other orders); a step's loss within 1e-6 and
its gradient blocks within 1e-5 of each leaf's largest value (the losses
of five layers), as ``test_torch_tp_ep.py`` holds them.
"""

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

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.collectives import SyncConfig
from repro_torch.dist.context import DistContext, distribution
from repro_torch.dist.grouping import leaf_specs
from repro_torch.dist.sharding import local_shard
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import AXES, make_mesh, run_local_ranks
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import SyncGrads, TrainConfig
from repro_torch.tree import leaf_paths

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 120
REL, STEP_REL = 1e-6, 1e-5
# (name, model ranks, q heads, kv heads)
CROSS = [("2 ranks, 4 q and 2 kv heads", 2, 4, 2),
         ("3 ranks, padded: 4 q and 2 kv heads", 3, 4, 2),
         ("2 ranks, 4 q heads and one kv head", 2, 4, 1)]
D, HEAD_DIM, B, S, N_CTX = 32, 8, 2, 6, 10
ARCH = "llama-3.2-vision-90b"
STEP_MESHES = [(1, 1, 2), (1, 2, 2)]
STEP_BATCH, STEP_SEQ = 4, 16


def mesh_key(shape) -> str:
    return "x".join(map(str, shape))


def cross_inputs(h: int, kv: int) -> tuple[dict, np.ndarray, np.ndarray, np.ndarray]:
    """(params, x, the context, the cotangent), f32 numpy from a seed."""
    rng = np.random.default_rng(10 * h + kv)

    def w(d_in, d_out):
        return {"w": rng.normal(0, d_in ** -0.5, (d_in, d_out)).astype(np.float32)}

    p = {"wq": w(D, h * HEAD_DIM), "wk": w(D, kv * HEAD_DIM), "wv": w(D, kv * HEAD_DIM),
         "wo": w(h * HEAD_DIM, D)}
    x, src, ct = (rng.normal(0, 1, shape).astype(np.float32)
                  for shape in ((B, S, D), (B, N_CTX, D), (B, S, D)))
    return p, x, src, ct


def step_batch(cfg) -> dict[str, np.ndarray]:
    """The global batch of the step tests: ``SyntheticLM``'s tokens and
    labels, and for a model with an image context ``img`` from a seed."""
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=STEP_SEQ,
                                   global_batch=STEP_BATCH, seed=0)).batch(0)
    if cfg.n_img_tokens:
        batch["img"] = np.random.default_rng(1).normal(
            0, 1, (STEP_BATCH, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


# ---------------------------------------------------------------------------
# the reference, in a child process (run as ``python this_file.py reference``)
# ---------------------------------------------------------------------------


def mesh_of(shape):
    from jax.sharding import AxisType

    return jax.make_mesh(shape, AXES, axis_types=(AxisType.Auto,) * 3,
                         devices=jax.devices()[:math.prod(shape)])


def flat(tree, prefix: str) -> dict[str, np.ndarray]:
    return {prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v) for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference_steps(arch: str, shapes: list) -> dict[str, np.ndarray]:
    """The reference's initial parameters of ``arch``'s smoke config and,
    on each mesh of ``shapes``, the loss and gradients of ``loss_fn`` in
    f32 on ``step_batch``, under its ``distribution(mesh)``."""
    import repro.dist  # noqa: F401  (installs jax.shard_map on old JAX)
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.dist import context as dist_context
    from repro.models import model as jax_model
    from repro.train import train_step as jts

    jcfg = jax_smoke(arch)
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    out = flat(params, f"{arch}/init/")
    batch = {k: jnp.asarray(v) for k, v in step_batch(jcfg).items()}
    for shape in shapes:
        def grads(p, b, mesh=mesh_of(shape)):
            with dist_context.distribution(mesh):
                return jax.value_and_grad(lambda q: jts.loss_fn(jcfg, q, b, jnp.float32))(p)

        loss, g = jax.jit(grads)(params, batch)
        out[f"{arch}/{mesh_key(shape)}/loss"] = np.asarray(loss)
        out.update(flat(g, f"{arch}/{mesh_key(shape)}/grad/"))
    return out


def reference_main(out_dir: str) -> None:
    from repro.dist import context as dist_context
    from repro.models import layers as jax_layers

    out = {}
    for name, dm, h, kv in CROSS:
        p, x, src, ct = cross_inputs(h, kv)

        def loss(p, x, src, h=h, kv=kv, ct=ct, mesh=mesh_of((1, 1, dm))):
            with dist_context.distribution(mesh):
                y, _ = jax_layers.gqa_apply(p, x, n_heads=h, n_kv=kv, head_dim=HEAD_DIM,
                                            causal=False, kv_source=src)
            return jnp.sum(y * ct), y

        (_, y), (gp, gx, gsrc) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(p, x, src)
        out[f"cross/{name}/out"] = np.asarray(y)
        out[f"cross/{name}/grad/x"] = np.asarray(gx)
        out[f"cross/{name}/grad/src"] = np.asarray(gsrc)
        out.update(flat(gp, f"cross/{name}/grad/"))
    out.update(reference_steps(ARCH, STEP_MESHES))
    np.savez(os.path.join(out_dir, "reference.npz"), **out)


def run_reference(tmp_path_factory, test_file: str) -> dict[str, np.ndarray]:
    """Run ``test_file``'s ``reference_main`` in a child process with 8
    forced host devices and return what it wrote."""
    out_dir = tmp_path_factory.mktemp("reference")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, test_file, "reference", str(out_dir)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(out_dir / "reference.npz"))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(tmp_path_factory, __file__)


def sub(runs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in runs.items() if k.startswith(prefix)}


def assert_rel(got, want, what, rel=REL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{what}: max abs err {err:.3e}, scale {scale:.3e}"


# ---------------------------------------------------------------------------
# the port's step, on gloo ranks
# ---------------------------------------------------------------------------


def step_rank(rank: int, arch: str, shape: tuple, init: dict) -> dict:
    """This rank's blocks of its pod's gradient and its loss, on ``shape``,
    from the reference's initial parameters, in f32."""
    mesh, _ = make_mesh(shape, device="cpu")
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(sync=SyncConfig("hier"), compute_dtype=torch.float32)
    whole = params_from_jax(cfg, init, device="cpu")
    params = train_mod.StatePlacement(cfg, tcfg, torch.device("cpu"), mesh).place(whole, "params")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in step_batch(cfg).items()}
    grads, loss = SyncGrads(cfg, tcfg, "cpu", mesh).local(params, batch)
    keys = [key for key, _ in leaf_paths(whole)]
    return {"coords": dict(mesh.coords), "loss": float(loss),
            "grads": {k: g.numpy() for k, g in zip(keys, grads)}}


def check_step(arch: str, shape: tuple, reference: dict) -> None:
    """The port's step on ``shape`` against the reference's: the mean of
    the ``data`` ranks' losses (each over its rows; the ranks along
    ``model`` share rows and agree) is the global batch's, and each rank's
    block of every leaf's gradient is its block of the reference's."""
    key = mesh_key(shape)
    ranks = run_local_ranks(step_rank, math.prod(shape),
                            (arch, shape, sub(reference, f"{arch}/init/")),
                            timeout=RANK_TIMEOUT)
    cfg = get_smoke_config(arch)
    sizes = dict(zip(AXES, shape))
    specs = leaf_specs(cfg, sizes, "hier")
    by_data = {}
    for got in ranks:
        by_data.setdefault(got["coords"]["data"], []).append(got["loss"])
    for losses in by_data.values():
        assert max(losses) == min(losses), f"{arch} on {key}: the model ranks' losses {losses}"
    np.testing.assert_allclose(np.mean([v[0] for v in by_data.values()]),
                               reference[f"{arch}/{key}/loss"], rtol=REL)
    want = params_from_jax(cfg, sub(reference, f"{arch}/{key}/grad/"), device="cpu")
    for got in ranks:
        for leaf, w in leaf_paths(want):
            block = local_shard(w, specs[leaf], got["coords"], sizes).numpy()
            assert_rel(got["grads"][leaf], block, f"{arch} on {key}, rank {got['coords']}: {leaf}",
                       STEP_REL)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CROSS, ids=[c[0] for c in CROSS])
def test_cross_attention_per_model_rank_sums_to_the_references(case, reference):
    """Each ``model`` coordinate computes its part of ``gqa_apply`` with a
    context: its q heads of the padded layout, the kv heads they read from
    the context, its rows of ``wo``.  The parts of the output, and of the
    gradients of the parameters, the input and the context, summed over
    the coordinates, are the reference's."""
    name, dm, h, kv = case
    p, x, src, ct = cross_inputs(h, kv)
    want = sub(reference, f"cross/{name}/")
    total, grads = 0, {}
    for coord in range(dm):
        pt = jax.tree.map(lambda v: torch.from_numpy(v).requires_grad_(), p)
        xt, st = (torch.from_numpy(v).requires_grad_() for v in (x, src))
        with distribution(DistContext({"model": dm}, {"model": coord})):
            y, cache = layers.gqa_apply(pt, xt, n_heads=h, n_kv=kv, head_dim=HEAD_DIM,
                                        causal=False, kv_source=st)
        (y * torch.from_numpy(ct)).sum().backward()
        assert cache is None
        total = total + y.detach().numpy()
        for k, t in [*leaf_paths(pt), ("x", xt), ("src", st)]:
            grads[k] = grads.get(k, 0) + t.grad.numpy()
    assert_rel(total, want["out"], f"{name}: out")
    assert sorted(grads) == sorted(k[len("grad/"):] for k in want if k.startswith("grad/"))
    for k, g in grads.items():
        assert_rel(g, want[f"grad/{k}"], f"{name}: {k}'s gradient")


def test_cross_attention_without_a_split_is_unchanged(reference):
    """Under a context with ``model`` 1, and under none, cross-attention
    computes whole: the same bits either way, the reference's numbers."""
    name, _, h, kv = CROSS[0]
    p, x, src, _ = cross_inputs(h, kv)
    pt = jax.tree.map(torch.from_numpy, p)
    kw = dict(n_heads=h, n_kv=kv, head_dim=HEAD_DIM, causal=False,
              kv_source=torch.from_numpy(src))
    whole, _ = layers.gqa_apply(pt, torch.from_numpy(x), **kw)
    with distribution(DistContext({"model": 1}, {"model": 0})):
        one, _ = layers.gqa_apply(pt, torch.from_numpy(x), **kw)
    assert torch.equal(whole, one)
    assert_rel(whole.numpy(), reference[f"cross/{name}/out"], name)


@pytest.mark.parametrize("shape", STEP_MESHES, ids=mesh_key)
def test_vision_step_on_a_model_mesh_matches_the_reference(shape, reference):
    """llama-3.2-vision-90b's smoke step with heads split over ``model``,
    the cross block's too (over the image context, padded nowhere: 4 q and
    2 kv heads on 2 ranks), and on (1, 2, 2) its rows over ``data``."""
    check_step(ARCH, shape, reference)


def test_region_leaves_take_the_cross_blocks_projections():
    """The cross block's q, k, v and o projections are summed over
    ``model`` as self-attention's are; its norms and SwiGLU are not."""
    cfg = get_smoke_config(ARCH)
    keys = model.region_leaves(cfg)
    cross = [i for i, blk in enumerate(cfg.block_list()) if blk.mixer == "attn_cross"]
    assert cross == [4]
    assert {k for k in keys if k.startswith("layers/4/")} == {
        f"layers/4/mixer/{w}/w" for w in ("wq", "wk", "wv", "wo")}
    assert not any("/ffn/" in k or "norm" in k for k in keys)


if __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    reference_main(sys.argv[2])
