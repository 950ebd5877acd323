"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla``, on the CPU at the smoke
widths of deepseek-v3-671b (d_model 64, 4 heads, q rank 32, kv rank 16,
qk head dim 16 + 8, v head dim 16).

Both sides get the weights of the first block of the smoke model's JAX
tree, jittered as the serve tests jitter them (the norm gains move the
output), carried over by ``params_from_jax``, and the same numpy inputs.
Tolerances, as in ``test_torch_dense_serve.py``: rtol = atol = 1e-4 in f32,
2e-2 in bf16 (bf16 rounds at other places in the two frameworks' matmuls).

Cases: without a cache at s = 8 (dense attention) and s = 2056 (above 2048:
``flash_attention`` in chunks of 514, the largest divisor of 2056 up to
1024, as the reference's ``mla.py:117-121`` picks them); with a cache, a
prefill then decode steps, the cache in f32 and in bf16 (the latents are
written in the cache's dtype).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import mla as jax_mla
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist.context import DistContext, distribution
from repro_torch.models import mla, model
from repro_torch.models.convert import params_from_jax
from test_torch_dense_serve import BF16_TOL, F32_TOL, jax_tree

ARCH = "deepseek-v3-671b"
B = 2
PROMPT, STEPS = 6, 3


@pytest.fixture(scope="module")
def weights():
    """The first block's MLA weights: (port tensors, JAX arrays)."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    tree = jax_tree(jcfg, 0)
    port = params_from_jax(cfg, tree, device="cpu")["layers"][0]["mixer"]
    return cfg, port, jax.tree.map(jnp.asarray, tree["prefix"][0]["mixer"])


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **_tol(dtype))


def test_leaves_are_the_references(weights):
    cfg, port, ref = weights
    assert sorted(port) == sorted(ref) == ["kv_norm", "q_norm", "wdkv", "wdq", "wkr", "wo",
                                           "wuk", "wuq", "wuv"]
    mine = mla.mla_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.n_heads, cfg.mla,
                        torch.device("cpu"))
    for name, sub in mine.items():
        for leaf, t in sub.items():
            assert tuple(t.shape) == ref[name][leaf].shape, (name, leaf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 2056])
def test_uncached_matches_jax(weights, s, dtype, monkeypatch):
    cfg, port, ref = weights
    calls = []
    real = mla.flash_attention
    monkeypatch.setattr(mla, "flash_attention",
                        lambda q, k, v, **kw: calls.append(kw) or real(q, k, v, **kw))
    x = _x(cfg, s, 1)
    want, want_cache = jax_mla.mla_apply(ref, jnp.asarray(x, dtype), n_heads=cfg.n_heads,
                                         mla=cfg.mla, rope_theta=cfg.rope_theta)
    with torch.inference_mode():
        got, cache = mla.mla_apply(port, torch.from_numpy(x).to(getattr(torch, dtype)),
                                   n_heads=cfg.n_heads, mla=cfg.mla, rope_theta=cfg.rope_theta)
    assert cache is None and want_cache is None
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, s, cfg.d_model)
    assert calls == ([{"causal": True, "q_chunk": 514, "kv_chunk": 514}] if s > 2048 else [])
    _close(got, want, dtype)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_prefill_and_decode_match_jax(weights, dtype, cache_dtype):
    """A prefill of PROMPT tokens, then STEPS one-token steps, on a cache of
    PROMPT + STEPS positions; each output and the cache after each call."""
    cfg, port, ref = weights
    x = _x(cfg, PROMPT + STEPS, 2)
    jc = jax_mla.mla_init_cache(B, PROMPT + STEPS, cfg.mla, getattr(jnp, cache_dtype))
    pc = mla.mla_init_cache(B, PROMPT + STEPS, cfg.mla, getattr(torch, cache_dtype), "cpu")
    spans = [(0, PROMPT)] + [(t, t + 1) for t in range(PROMPT, PROMPT + STEPS)]
    with torch.inference_mode():
        for lo, hi in spans:
            want, jc = jax_mla.mla_apply(ref, jnp.asarray(x[:, lo:hi], dtype), n_heads=cfg.n_heads,
                                         mla=cfg.mla, rope_theta=cfg.rope_theta, cache=jc)
            before = {k: v.clone() for k, v in pc.items() if k != "len"}
            got, new = mla.mla_apply(port, torch.from_numpy(x[:, lo:hi]).to(getattr(torch, dtype)),
                                     n_heads=cfg.n_heads, mla=cfg.mla,
                                     rope_theta=cfg.rope_theta, cache=pc)
            # the caller's cache is left as it was
            assert all(torch.equal(pc[k], before[k]) for k in before)
            pc = new
            _close(got, want, dtype)
            assert pc["len"] == int(jc["len"]) == hi
            for name in ("ckv", "kr"):
                assert pc[name].dtype == getattr(torch, cache_dtype)
                _close(pc[name], jc[name], dtype)


def test_cached_equals_uncached(weights):
    """The cached prefill (dense attention over the cache) computes the
    uncached forward's numbers, in f32."""
    cfg, port, _ = weights
    x = torch.from_numpy(_x(cfg, 12, 3))
    with torch.inference_mode():
        want, _ = mla.mla_apply(port, x, n_heads=cfg.n_heads, mla=cfg.mla)
        cache = mla.mla_init_cache(B, 16, cfg.mla, torch.float32, "cpu")
        got, cache = mla.mla_apply(port, x, n_heads=cfg.n_heads, mla=cfg.mla, cache=cache)
    assert cache["len"] == 12 and not cache["ckv"][:, 12:].any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_cache_overflow_is_refused(weights):
    cfg, port, _ = weights
    cache = mla.mla_init_cache(B, 4, cfg.mla, torch.float32, "cpu")
    with pytest.raises(ValueError, match="holds 4 positions"):
        mla.mla_apply(port, torch.from_numpy(_x(cfg, 5, 4)), n_heads=cfg.n_heads, mla=cfg.mla,
                      cache=cache)


def test_mla_ignores_the_model_split(weights):
    """MLA runs whole under a context that splits ``model``: the reference
    computes it outside any model-parallel region.  Its training step on
    meshes that split ``model`` is held against the reference's in
    ``test_torch_mla_mesh.py``."""
    cfg, port, _ = weights
    x = torch.from_numpy(_x(cfg, 8, 5))
    want, _ = mla.mla_apply(port, x, n_heads=cfg.n_heads, mla=cfg.mla)
    with distribution(DistContext({"model": 2}, {"model": 1})):
        got, _ = mla.mla_apply(port, x, n_heads=cfg.n_heads, mla=cfg.mla)
    assert torch.equal(got, want)


def test_region_leaves_take_no_mla_leaf():
    """Under ``model`` > 1 MLA runs whole on every rank, so none of its
    leaves is summed over ``model``; the MoE experts (not the shared one)
    are, and so are a cross-attention block's projections, which split
    their heads over ``model`` as self-attention's do."""
    keys = model.region_leaves(get_smoke_config(ARCH))
    assert keys and not any("/mixer/" in k for k in keys)
    assert all("/ffn/" in k and "/shared/" not in k for k in keys)
    vision = model.region_leaves(get_smoke_config("llama-3.2-vision-90b"))
    assert any(k.startswith("layers/0/mixer/") for k in vision)
    assert {k for k in vision if k.startswith("layers/4/")} == {
        f"layers/4/mixer/{w}/w" for w in ("wq", "wk", "wv", "wo")}
