"""The port's training step against the JAX reference on the CPU, for the
two models whose batches carry more than tokens: hubert-xlarge's smoke
config (frames: ``embeds`` (B, S, d) through ``embed_proj``, not causal,
64 codebook targets) and llama-3.2-vision-90b's (tokens and an image
context ``img`` (B, 16, d) read by its cross block).

The trajectories, what is compared and the tolerances are those of
``test_torch_train_dense.py``, whose helpers run both sides: the step-1
gradients leaf by leaf against the norm, the 8 losses, and the parameters
after 8 steps of AdamW, in f32 and in bf16 compute, the reference being
``value_and_grad(loss_fn)`` + ``adamw_update`` on the same batches
(``batches`` draws ``embeds`` and ``img`` from a numpy seed beside
``SyntheticLM``'s labels).  Also with 2 microbatches, which cut every entry
of the batch along its rows, against the reference's whole batch; the
gradients of 1 and 2 microbatches on one batch against each other in f32
(within 1e-6 of each leaf's largest value: the batch's mean is summed in
two halves); and on a (1, 2, 1) mesh of gloo ranks, each ``data`` rank
takes its rows of every entry (``SyncGrads.local``): the pod's gradient is
the one process's, within 1e-6.  ``train()`` still refuses both models
(``test_torch_train_deepseek_v3.py``): its pipeline yields tokens only.
"""

import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist.collectives import SyncConfig
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_mesh, run_local_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import SyncGrads, TrainConfig, grads_and_loss
from test_torch_train_dense import batches, check_trajectories, jax_tree

ARCHS = ["hubert-xlarge", "llama-3.2-vision-90b"]
REL = 1e-6
RANK_TIMEOUT = 120


def as_torch(batch: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def assert_rel(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= REL * scale, f"{what}: max abs err {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_matches_reference(arch, dtype):
    check_trajectories(get_smoke_config(arch), jax_get_smoke_config(arch), dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_with_two_microbatches(arch):
    check_trajectories(get_smoke_config(arch), jax_get_smoke_config(arch), "float32", batch=4,
                       microbatches=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_cut_every_entry(arch):
    """Microbatches 1 and 2 on one batch of 4 rows give the same loss and
    gradients: each half takes its rows of ``embeds`` or of ``tokens`` and
    ``img`` with its labels."""
    cfg = get_smoke_config(arch)
    params = params_from_jax(cfg, jax_tree(jax_get_smoke_config(arch)), device="cpu")
    batch = as_torch(batches(cfg, 16, 4)[0])
    assert set(batch) == ({"embeds", "labels"} if arch == "hubert-xlarge"
                          else {"tokens", "img", "labels"})
    one = TrainConfig(compute_dtype=torch.float32)
    g1, l1 = grads_and_loss(cfg, one, params, batch)
    g2, l2 = grads_and_loss(cfg, TrainConfig(compute_dtype=torch.float32, microbatches=2),
                            params, batch)
    np.testing.assert_allclose(float(l2), float(l1), rtol=REL)
    for i, (a, b) in enumerate(zip(g2, g1)):
        assert_rel(a, b, f"{arch} leaf {i}")


def rows_rank(rank: int, arch: str, tree: dict) -> dict:
    mesh, _ = make_mesh((1, 2, 1), device="cpu")
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(sync=SyncConfig("flat"), compute_dtype=torch.float32)
    params = train_mod.StatePlacement(cfg, tcfg, torch.device("cpu"), mesh).place(
        params_from_jax(cfg, tree, device="cpu"), "params")
    grads, loss = SyncGrads(cfg, tcfg, "cpu", mesh).local(params, as_torch(batches(cfg, 16, 4)[0]))
    return {"loss": float(loss), "grads": [g.numpy() for g in grads]}


def test_data_ranks_take_their_rows_of_the_frames():
    """hubert-xlarge on (1, 2, 1) under flat (every leaf whole): each rank's
    loss is its two rows', the pod's gradient the whole batch's."""
    arch = "hubert-xlarge"
    cfg, tree = get_smoke_config(arch), jax_tree(jax_get_smoke_config(arch))
    ranks = run_local_ranks(rows_rank, 2, (arch, tree), timeout=RANK_TIMEOUT)
    params = params_from_jax(cfg, tree, device="cpu")
    batch = as_torch(batches(cfg, 16, 4)[0])
    f32 = TrainConfig(compute_dtype=torch.float32)
    grads, _ = grads_and_loss(cfg, f32, params, batch)
    for got, rows in zip(ranks, (slice(0, 2), slice(2, 4))):
        _, loss = grads_and_loss(cfg, f32, params, {k: v[rows] for k, v in batch.items()})
        np.testing.assert_allclose(got["loss"], float(loss), rtol=REL)
        for i, (a, b) in enumerate(zip(got["grads"], grads)):
            assert_rel(torch.from_numpy(a), b, f"leaf {i}")
