"""hubert-xlarge's frames frontend and encoder against the JAX package, on
the CPU at the smoke size (hubert-xlarge-smoke: 2 non-causal attention
blocks, d_model 64, 4 heads, 64 codebook targets).

The model reads frame embeddings (B, S, d_model) through one projection,
``embed_proj``, and has its own ``lm_head`` (the reference's
``model.py:207-212, 231``).  It is encoder-only: it has no decode, so it is
served by its prefill step (``launch.serve.encode``).  Tolerances as in
``test_torch_dense_serve.py``: rtol = atol = 1e-4 in f32, 2e-2 in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import model as jax_model
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import TrainConfig
from test_torch_dense_serve import BF16_TOL, F32_TOL, jax_tree

ARCH = "hubert-xlarge"
B = 2


def frames(cfg, seed, s, b=B):
    return np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)


def both(cfg, jcfg, tree, embeds, dtype):
    """(port, reference) logits over ``embeds`` in ``dtype``, as f32 numpy."""
    want, _ = jax_model.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                                {"embeds": jnp.asarray(embeds)}, compute_dtype=getattr(jnp, dtype))
    with torch.inference_mode():
        got, cache = model.forward(cfg, params_from_jax(cfg, tree, device="cpu"),
                                   {"embeds": torch.from_numpy(embeds)},
                                   compute_dtype=getattr(torch, dtype))
    assert cache is None and got.dtype == getattr(torch, dtype)
    assert got.shape == (*embeds.shape[:2], cfg.vocab_size)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frames_forward_matches_jax(dtype):
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    got, want = both(cfg, jcfg, jax_tree(jcfg, 0), frames(cfg, 1, 24), dtype)
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_attention_is_not_causal():
    """Row 0's last frame changed: row 0's first position moves (it sees
    every frame), the other rows stay bit for bit."""
    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(frames(cfg, 2, 16, b=4))
    y = x.clone()
    y[0, -1] += 1.0
    with torch.inference_mode():
        a, _ = model.forward(cfg, params, {"embeds": x}, compute_dtype=torch.float32)
        b, _ = model.forward(cfg, params, {"embeds": y}, compute_dtype=torch.float32)
    assert (a[0, 0] - b[0, 0]).abs().max() > 1e-3
    assert torch.equal(a[1:], b[1:])


def test_long_forward_goes_through_non_causal_flash_attention(monkeypatch):
    """S = 1088 puts S^2 above attention_any's dense threshold, so both
    sides take flash attention, not causal, in chunks of 544."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    seen = []
    real = layers.flash_attention
    monkeypatch.setattr(layers, "flash_attention",
                        lambda q, k, v, **kw: seen.append(kw) or real(q, k, v, **kw))
    got, want = both(cfg, jcfg, jax_tree(jcfg, 3), frames(cfg, 4, 1088, b=1), "float32")
    assert seen == [{"causal": False, "q_chunk": 544, "kv_chunk": 544}] * cfg.n_layers
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_frames_frontend_has_its_own_head():
    """A frames model has ``embed_proj`` and no table, and its ``lm_head``
    even where the config ties embeddings (the reference's model.py:231)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), tie_embeddings=True)
    tree = model.init_params(cfg, None, "meta")
    assert "embed" not in tree and tree["embed_proj"]["w"].shape == (cfg.d_model, cfg.d_model)
    assert tree["lm_head"]["w"].shape == (cfg.d_model, cfg.vocab_size)
    assert model.param_count(cfg) == jax_model.param_count(
        dataclasses.replace(jax_get_smoke_config(ARCH), tie_embeddings=True))


def test_serve_refuses_an_encoder_and_encode_runs_its_prefill_step():
    """``serve()`` raises on an encoder-only config (no decode, as the
    reference's ``applicable_shapes`` gives it none); ``encode`` runs the
    prefill step in the compute dtype and matches the reference's
    forward."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    tree = jax_tree(jcfg, 5)
    with pytest.raises(ValueError, match="encoder-only"):
        serve_mod.serve(cfg, params_from_jax(cfg, tree, device="cpu"),
                        np.zeros((B, 4), np.int32), 2, device="cpu")
    x = serve_mod.make_frames(cfg, B, 12, seed=6)
    np.testing.assert_array_equal(x, frames(cfg, 6, 12))
    for dtype in ("float32", "bfloat16"):
        res = serve_mod.encode(cfg, params_from_jax(cfg, tree, device="cpu"), x,
                               TrainConfig(compute_dtype=getattr(torch, dtype)), "cpu")
        _, want = both(cfg, jcfg, tree, x, dtype)
        assert res.prefill_s > 0 and res.logits.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(res.logits.float().numpy(), want,
                                   **(F32_TOL if dtype == "float32" else BF16_TOL))
    with pytest.raises(ValueError, match="not frames"):
        serve_mod.encode(get_smoke_config("minitron-8b"), {}, x, device="cpu")


def test_serve_cli_runs_the_prefill_step(capsys):
    res = serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "6"])
    assert res.logits.shape == (2, 6, get_smoke_config(ARCH).vocab_size)
    out = capsys.readouterr().out
    assert "prefill step over 2 x 6 frames" in out and "frames/s" in out
