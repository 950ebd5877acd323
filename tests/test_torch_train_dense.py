"""The port's training step against the JAX reference on the CPU, for the
dense decoders: minitron-8b's smoke config and demo-20m, the small model of
``examples/train_100m.py``.  ``test_torch_train_rwkv6.py``,
``test_torch_train_recurrentgemma.py`` and ``test_torch_train_moe.py`` use
the trajectory helpers defined here, as does ``test_torch_train_frames_image.py``
(``batches`` draws the frames and image contexts of those models).

Both sides start from the same weights (a JAX tree carried over by
``params_from_jax``) and see the same ``SyntheticLM`` batches.  The
reference's trainer fails by fault 1 (ROADMAP §3), so its pieces are called
directly: ``jax.value_and_grad(loss_fn)`` and ``adamw_update`` on one
device, 8 steps.  The port runs ``build_train_step``.  What is compared:

* the step-1 gradients, leaf by leaf, each relative to its norm;
* the 8 losses;
* the parameters after 8 steps.  AdamW moves each element by about
  lr * sign(g) while m and v are young, so an element whose gradient is
  near its rounding noise can move the other way in one of two correct
  implementations: 2 lr per step and element at most.  The check holds
  every element within that bound (2 x the sum of the 8 learning rates)
  and all but a share ``FLIP_SHARE`` of the elements within a tight one.

Tolerances: f32 gradients 1e-4 of the leaf's norm, losses rtol 1e-4,
parameters 1e-5 (abs.) for all but 1% of each leaf's elements.  bf16
compute (``TrainConfig``'s default): gradients 1e-1 of the norm, losses
rtol 2e-2, parameters 1e-3 for all but 10%.  bf16 keeps 8 bits of mantissa
and rounds at other places in the two frameworks' matmuls, norms and casts,
and a leaf's gradient sums many such products.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import Block as JaxBlock
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.data import pipeline as jax_pipeline
from repro.models import model as jax_model
from repro.optim import adamw as jax_adamw
from repro.train import train_step as jax_train_step
from repro_torch.configs.base import Block, ModelConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import leaf_paths, leaves
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainConfig, build_train_step, grads_and_loss

STEPS = 8
LR, WARMUP = 1e-3, 2
TOLS = {
    "float32": dict(grad=1e-4, loss=1e-4, param=1e-5, flip_share=0.01),
    "bfloat16": dict(grad=1e-1, loss=2e-2, param=1e-3, flip_share=0.10),
}


def jax_tree(jcfg, seed=0):
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def batches(cfg, seq, batch, seed=0):
    """``SyntheticLM``'s batches; for a frames frontend ``embeds`` (B, S, d)
    in place of the tokens, and for a model with an image context ``img``
    (B, N_img, d), both N(0, 1) from a numpy generator of ``seed``."""
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                                  seed=seed))
    want = jax_pipeline.SyntheticLM(jax_pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))
    out = [data.batch(i) for i in range(STEPS)]
    np.testing.assert_array_equal(out[-1]["tokens"], want.batch(STEPS - 1)["tokens"])
    rng = np.random.default_rng(seed + 1)
    for b in out:
        if cfg.frontend != "token":
            del b["tokens"]
            b["embeds"] = rng.normal(0, 1, (batch, seq, cfg.d_model)).astype(np.float32)
        if cfg.n_img_tokens:
            b["img"] = rng.normal(0, 1, (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def reference_run(jcfg, tree, data, dtype):
    """The reference's 8 steps: (losses, step-1 gradients, final params) as
    numpy trees."""
    opt = jax_adamw.AdamWConfig(lr=LR, warmup_steps=WARMUP, total_steps=STEPS)
    p = jax.tree.map(jnp.asarray, tree)
    state = jax_adamw.adamw_init(p, opt)
    cdt = getattr(jnp, dtype)
    vg = jax.jit(jax.value_and_grad(
        lambda pp, b: jax_train_step.loss_fn(jcfg, pp, b, cdt)))
    losses, first = [], None
    for b in data:
        loss, g = vg(p, jax.tree.map(jnp.asarray, b))
        first = first if first is not None else jax.tree.map(np.asarray, g)
        p, state, _ = jax_adamw.adamw_update(p, g, state, opt)
        losses.append(float(loss))
    return losses, first, jax.tree.map(np.asarray, p)


def port_run(cfg, tree, data, dtype, microbatches=1):
    opt = adamw.AdamWConfig(lr=LR, warmup_steps=WARMUP, total_steps=STEPS)
    tcfg = TrainConfig(optim=opt, compute_dtype=getattr(torch, dtype), microbatches=microbatches)
    params = params_from_jax(cfg, tree, device="cpu")
    state = adamw.adamw_init(params, opt)
    step = build_train_step(cfg, tcfg, device="cpu")
    as_t = [{k: torch.from_numpy(v) for k, v in b.items()} for b in data]
    first, _ = grads_and_loss(cfg, tcfg, params, as_t[0])
    losses = [float(step(params, state, b)["loss"]) for b in as_t]
    return losses, first, params


def check_trajectories(cfg, jcfg, dtype, seq=16, batch=2, seed=0, microbatches=1, **tols):
    """Run both sides and hold the port to TOLS[dtype], updated by
    ``tols``."""
    tol = dict(TOLS[dtype], **tols)
    tree = jax_tree(jcfg, seed)
    data = batches(cfg, seq, batch, seed)
    want_losses, want_g, want_p = reference_run(jcfg, tree, data, dtype)
    losses, grads, params = port_run(cfg, tree, data, dtype, microbatches)
    np.testing.assert_allclose(losses, want_losses, rtol=tol["loss"])
    want_g = params_from_jax(cfg, want_g, device="cpu")
    for (key, w), g in zip(leaf_paths(want_g), grads):
        assert torch.isfinite(g).all(), key
        assert (g - w).norm() <= tol["grad"] * w.norm() + 1e-12, key
    bound = 2 * sum(float(adamw.cosine_lr(adamw.AdamWConfig(
        lr=LR, warmup_steps=WARMUP, total_steps=STEPS), torch.tensor(i))) for i in range(1, 9))
    for (key, w), p in zip(leaf_paths(params_from_jax(cfg, want_p, device="cpu")),
                           leaves(params)):
        diff = (p.detach() - w).abs()
        assert diff.max() <= bound + tol["param"], key
        assert (diff > tol["param"]).float().mean() <= tol["flip_share"], key
    return losses


def demo_20m():
    """``examples/train_100m.py``'s --small model (demo-20m), in both
    packages' config classes."""
    kw = dict(name="demo-20m", family="dense", n_layers=4, d_model=256, n_heads=8,
              n_kv_heads=4, d_ff=1024, vocab_size=32_000)
    return (ModelConfig(**kw, blocks_pattern=(Block("attn", "dense"),)),
            JaxModelConfig(**kw, blocks_pattern=(JaxBlock("attn", "dense"),)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_minitron_trajectory_matches_reference(dtype):
    check_trajectories(get_smoke_config("minitron-8b"), jax_get_smoke_config("minitron-8b"), dtype)


def test_minitron_trajectory_with_two_microbatches():
    check_trajectories(get_smoke_config("minitron-8b"), jax_get_smoke_config("minitron-8b"),
                       "float32", batch=4, microbatches=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demo_20m_trajectory_matches_reference(dtype):
    cfg, jcfg = demo_20m()
    check_trajectories(cfg, jcfg, dtype, seq=32, batch=2)
