"""The port's top-k MoE FFN and granite-moe-3b-a800m's serving path against
the JAX package, on the CPU at the smoke size (granite-moe-3b-a800m-smoke:
2 layers, d_model 64, 8 experts of 32, top 2, tied embeddings).

``moe_apply`` is held against the reference's dense dispatch
(``repro.models.moe._moe_apply_dense_dispatch``), with assignments dropped
where the per-call capacity is short: the outputs at the tolerances of
the serve tests (rtol = atol = 1e-4 in f32, 2e-2 in bf16), the aux loss at
rtol 1e-6, the drop rate exactly.  The model's forward and serve flow are held as in
``test_torch_dense_serve.py`` (whose helpers they use), at the smoke
config's capacity factor (8.0, which drops nothing) and at the published
1.25, which drops assignments at every decode step of this batch.  The
router is jittered to N(0, 0.5) there, so routing is decisive.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import moe as jax_moe
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import model, moe
from repro_torch.models.convert import params_from_jax
from test_torch_dense_serve import (
    B,
    BF16_TOL,
    F32_TOL,
    GEN,
    PROMPT,
    check_chip_smoke_gate,
    check_forward,
    check_serve_flow,
    jax_tree,
    tokens,
)

ARCH = "granite-moe-3b-a800m"
D = 32

# name: (experts, top_k, batch, seq, capacity factor, shared experts, dtype)
MOE_CASES = {
    "t 4, capacity 1 (drops 1 in 4)": (8, 2, 1, 4, 1.25, 0, "float32"),
    "t 16, capacity 5, a shared expert": (8, 2, 2, 8, 1.25, 1, "float32"),
    "granite's decode shape (40 experts, top 8, t 8, capacity 2)": (40, 8, 8, 1, 1.25, 0,
                                                                     "float32"),
    "no drops (capacity t)": (8, 2, 2, 8, 4.0, 0, "float32"),
    "bf16, capacity 1": (8, 2, 1, 4, 1.25, 0, "bfloat16"),
}


def _moe_params(e, shared, seed):
    p = jax.tree.map(np.array, jax_moe.moe_init(jax.random.PRNGKey(seed), D, e, 24,
                                                 n_shared=shared))
    p["router"]["w"] = np.random.default_rng(seed).normal(0, 0.5, (D, e)).astype(np.float32)
    return p


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    e, k, b, s, cf, shared, dtype = MOE_CASES[case]
    p = _moe_params(e, shared, 3)
    x = np.random.default_rng(4).normal(0, 1, (b, s, D)).astype(np.float32)
    want, want_aux = jax_moe._moe_apply_dense_dispatch(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x, dtype), top_k=k, capacity_factor=cf,
        return_aux=True)
    got, aux = moe.moe_apply(jax.tree.map(torch.from_numpy, p),
                             torch.from_numpy(x).to(getattr(torch, dtype)),
                             top_k=k, capacity_factor=cf, return_aux=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    assert float(aux["drop_rate"]) == float(want_aux["drop_rate"])
    assert (float(aux["drop_rate"]) > 0) == (cf < 4.0)
    np.testing.assert_allclose(float(aux["aux_loss"]), float(want_aux["aux_loss"]), rtol=1e-6)
    # without return_aux: the output alone, the same numbers
    assert torch.equal(moe.moe_apply(jax.tree.map(torch.from_numpy, p),
                                     torch.from_numpy(x).to(getattr(torch, dtype)),
                                     top_k=k, capacity_factor=cf), got)


def test_dropped_assignment_keeps_the_token_in_its_slot():
    """All 4 tokens pick expert 0 (top 1 of 2, capacity int(1.0 * 4 / 2) =
    2): tokens 0 and 1 take its slots 0 and 1, tokens 2 and 3 drop and are
    clamped onto slot 1 with zero rows.  The scatter adds, so token 1 keeps
    its output; an assignment would leave the last zero row there."""
    p = _moe_params(2, 0, 5)
    p["router"]["w"][:] = 0.0
    p["router"]["w"][0] = [10.0, -10.0]
    x = np.random.default_rng(6).normal(0, 1, (1, 4, D)).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 0.5
    want, want_aux = jax_moe._moe_apply_dense_dispatch(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), top_k=1, capacity_factor=1.0,
        return_aux=True)
    got, aux = moe.moe_apply(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), top_k=1,
                             capacity_factor=1.0, return_aux=True)
    assert float(aux["drop_rate"]) == float(want_aux["drop_rate"]) == 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    wi, wg, wo = (torch.from_numpy(p[n][0]) for n in ("wi", "wg", "wo"))
    xt = torch.from_numpy(x[0])
    expert0 = (torch.nn.functional.silu(xt @ wg) * (xt @ wi)) @ wo
    np.testing.assert_allclose(got[0, :2].numpy(), expert0[:2].numpy(), **F32_TOL)
    assert got[0, 1].abs().max() > 1e-3
    assert torch.equal(got[0, 2:], torch.zeros_like(got[0, 2:]))


def _configs(variant):
    """(port config, JAX config) of the smoke model: as published, at the
    capacity factor 1.25, or with one shared expert."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    if variant == "cf 1.25":
        change = {"capacity_factor": 1.25}
    elif variant == "a shared expert":
        change = {"n_shared": 1}
    else:
        return cfg, jcfg
    return (dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **change)),
            dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **change)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["smoke", "cf 1.25", "a shared expert"])
def test_forward_matches_jax(variant, dtype):
    cfg, jcfg = _configs(variant)
    check_forward(cfg, jcfg, jax_tree(jcfg, 0), tokens(cfg, 1, 20), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["smoke", "cf 1.25"])
def test_prefill_decode_matches_jax_serve_flow(variant, dtype):
    cfg, jcfg = _configs(variant)
    check_serve_flow(cfg, jcfg, jax_tree(jcfg, 2), tokens(cfg, 3, PROMPT + GEN), dtype)


def test_cast_params_keeps_router_f32():
    params = model.init_params(get_smoke_config(ARCH), torch.Generator().manual_seed(0), "cpu")
    assert "lm_head" not in params                         # tied embeddings
    model.cast_params_(params, torch.bfloat16)
    ffn = params["layers"][0]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    cast = [ffn["wi"], ffn["wg"], ffn["wo"], params["layers"][0]["mixer"]["wq"]["w"],
            params["embed"]["table"], params["final_norm"]["g"]]
    assert all(x.dtype == torch.bfloat16 for x in cast)
    assert model.param_dtypes(params) == {torch.bfloat16}


@pytest.mark.parametrize("mutate", [False, True])
def test_bf16_decode_routes_on_f32_router_like_jax(mutate, monkeypatch):
    """In bf16 decode the JAX package routes on its f32 router weights: the
    bf16 activations promote against them to an f32 product
    (``moe.py:216``).  The port's router probabilities in a bf16 decode step
    must match JAX's on the same activations at an f32 tolerance; a router
    cast to bf16 moves them by ~1e-3 and fails.  At the logits the bf16
    noise of the whole model (2e-2) would hide it, until a near tie flips
    an expert."""
    cfg, jcfg = _configs("smoke")
    tree = jax_tree(jcfg, 9)
    toks = tokens(cfg, 10, 13)
    params = params_from_jax(cfg, tree, device="cpu")
    seen = []
    real = moe._route
    monkeypatch.setattr(moe, "_route", lambda r, xf, k: seen.append((xf, real(r, xf, k)))
                        or seen[-1][1])
    with torch.inference_mode():
        cache = model.init_cache(cfg, B, 13, dtype=torch.float32, device="cpu")
        _, cache = model.forward(cfg, params, {"tokens": torch.from_numpy(toks[:, :12])},
                                 cache=cache, compute_dtype=torch.float32)
        model.cast_params_(params, torch.bfloat16)
        if mutate:
            for layer in params["layers"]:
                layer["ffn"]["router"]["w"] = layer["ffn"]["router"]["w"].to(torch.bfloat16)
        seen.clear()
        model.forward(cfg, params, {"tokens": torch.from_numpy(toks[:, 12:])},
                      cache=cache, compute_dtype=torch.bfloat16)
    assert len(seen) == cfg.n_layers
    mismatch = []
    for layer, (xf, (probs, _, _)) in enumerate(seen):
        assert xf.dtype == torch.bfloat16 and probs.dtype == torch.float32
        w = jnp.asarray(tree["scan"][0]["ffn"]["router"]["w"][layer])
        want = jax.nn.softmax(jnp.asarray(xf.float().numpy(), jnp.bfloat16) @ w, axis=-1)
        mismatch.append(not np.allclose(probs.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7))
    assert any(mismatch) == mutate, mismatch


@pytest.mark.parametrize("fault", [False, True])
def test_chip_smoke_decode_gate_catches_zeroed_kv_cache(fault):
    cfg = get_smoke_config(ARCH)
    check_chip_smoke_gate(cfg, torch.from_numpy(tokens(cfg, 11, 28)), 24, fault)


def _break(tree, how):
    ffn = tree["scan"][0]["ffn"]
    if how == "missing_router":
        del ffn["router"]
    elif how == "expert_axis":
        ffn["wi"] = ffn["wi"][:, :4]
    else:                                           # a shared expert the config lacks
        ffn["shared"] = {"wi": {"w": np.zeros((2, 64, 32), np.float32)}}
    return tree


@pytest.mark.parametrize("how", ["missing_router", "expert_axis", "extra_shared"])
def test_params_from_jax_refuses_broken_moe_tree(how):
    cfg, jcfg = _configs("smoke")
    params_from_jax(cfg, jax_tree(jcfg, 0), device="cpu")     # intact: carried over
    with pytest.raises(ValueError):
        params_from_jax(cfg, _break(jax_tree(jcfg, 0), how), device="cpu")
