"""llama-3.2-vision-90b's serving path against the JAX package, on the CPU
at the smoke size (llama-3.2-vision-90b-smoke: 4 self-attention blocks and
one cross-attention block over a 16-token image context; d_model 64, 4
query heads over 2 KV heads).

Every call takes the image context ``img`` (B, 16, 64) beside the tokens,
the decode steps' too: the cross block projects its keys and values from
it on every call and caches nothing.  The forward and the serve flow are
held as in ``test_torch_dense_serve.py``, whose helpers run both sides
(with ``extra={"img": ...}``), at its tolerances (1e-4 in f32, 2e-2 in
bf16).  The reference's own example prefills without the image context
and so cannot serve this model (ROADMAP, fault 11); the port is held
against the reference's ``forward`` with ``img`` given.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import TrainConfig, build_serve_step
from test_torch_dense_serve import (
    B,
    GEN,
    PROMPT,
    _chip_smoke_module,
    check_forward,
    check_serve_flow,
    jax_tree,
    tokens,
)

ARCH = "llama-3.2-vision-90b"


def image(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"img": rng.normal(0, 1, (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_image_matches_jax(dtype):
    cfg = get_smoke_config(ARCH)
    check_forward(cfg, jax_get_smoke_config(ARCH), jax_tree(jax_get_smoke_config(ARCH), 0),
                  tokens(cfg, 1, 20), dtype, image(cfg, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_decode_with_image_matches_jax(dtype):
    """Prefill and every decode step with the image context, against the
    reference's cached forward; in f32 the greedy tokens and ``serve()``'s
    own too."""
    cfg = get_smoke_config(ARCH)
    check_serve_flow(cfg, jax_get_smoke_config(ARCH), jax_tree(jax_get_smoke_config(ARCH), 3),
                     tokens(cfg, 4, PROMPT + GEN), dtype, image(cfg, 5))


def test_forward_without_image_raises():
    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(cfg, 1, 6))
    with pytest.raises(ValueError, match="image context"):
        model.forward(cfg, params, {"tokens": toks})
    with pytest.raises(ValueError, match="pass img"):
        serve_mod.serve(cfg, params, toks.numpy(), 2, device="cpu")


def test_cross_block_caches_only_its_length_and_reads_the_image_every_step():
    """The cross block's cache is ``{"len"}``; a decode step with another
    image context gives other logits, and the same one the same."""
    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(cfg, 1, 7))
    img = {k: torch.from_numpy(v) for k, v in image(cfg, 2).items()}
    other = {k: torch.from_numpy(v) for k, v in image(cfg, 3).items()}
    with torch.inference_mode():
        cache = model.init_cache(cfg, B, 7, dtype=torch.float32, device="cpu")
        assert cache["layers"][4] == {"len": 0}
        _, cache = model.forward(cfg, params, {"tokens": toks[:, :6], **img}, cache=cache,
                                 compute_dtype=torch.float32)
        assert cache["layers"][4] == {"len": 6}
        step = {"tokens": toks[:, 6:]}
        same, new = model.forward(cfg, params, {**step, **img}, cache=cache,
                                  compute_dtype=torch.float32)
        moved, _ = model.forward(cfg, params, {**step, **other}, cache=cache,
                                 compute_dtype=torch.float32)
        full, _ = model.forward(cfg, params, {"tokens": toks, **img}, compute_dtype=torch.float32)
    assert new["layers"][4] == {"len": 7}
    np.testing.assert_allclose(same[:, 0].numpy(), full[:, 6].numpy(), rtol=1e-4, atol=1e-4)
    assert (moved - same).abs().max() > 1e-2


def test_decode_step_moves_the_image_to_the_device():
    """``build_serve_step`` hands the forward every input of the batch, on
    its device: the decode step with the image equals the forward."""
    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(tokens(cfg, 1, 5))
    img = {k: torch.from_numpy(v) for k, v in image(cfg, 2).items()}
    step = build_serve_step(cfg, TrainConfig(compute_dtype=torch.float32), kind="decode",
                            device="cpu")
    cache = model.init_cache(cfg, B, 6, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        logits, cache = model.forward(cfg, params, {"tokens": toks, **img}, cache=cache,
                                      compute_dtype=torch.float32)
        tok, _ = step(params, cache, {"tokens": toks[:, -1:], **img})
        want, _ = model.forward(cfg, params, {"tokens": toks[:, -1:], **img}, cache=cache,
                                compute_dtype=torch.float32)
    assert torch.equal(tok, want[:, -1].argmax(-1).to(torch.int32))


def test_serve_on_cpu_with_the_seeds_image():
    """``serve()`` with the image context ``make_image`` draws after the
    prompts, as the JAX example draws it; bf16 decode."""
    cfg = get_smoke_config(ARCH)
    prompts = serve_mod.make_prompts(cfg, 3, 5, seed=7)
    img = serve_mod.make_image(cfg, 3, 5, seed=7)
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(rng.integers(0, cfg.vocab_size, (3, 5)), prompts)
    np.testing.assert_array_equal(rng.normal(size=(3, cfg.n_img_tokens, cfg.d_model))
                                  .astype(np.float32), img)
    assert serve_mod.make_image(get_smoke_config("minitron-8b"), 3, 5) is None
    params = serve_mod.init_model(cfg, TrainConfig(), seed=0, device="cpu")
    res = serve_mod.serve(cfg, params, prompts, 4, device="cpu", img=img)
    assert res.tokens.shape == (3, 4) and ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()


@pytest.mark.parametrize("fault", [None, "a zeroed attention KV cache", "a different image"])
def test_chip_smoke_decode_gate_with_image(fault):
    """chip_smoke.py's stepwise-decode check at the smoke size, with the
    image context: it passes on the port and fails when every decode step
    is fed a zeroed KV cache, or another image context than the prefill's."""
    chip_smoke = _chip_smoke_module()
    cfg = get_smoke_config(ARCH)
    seq = torch.from_numpy(tokens(cfg, 11, 28))
    extra = {k: torch.from_numpy(v) for k, v in image(cfg, 12).items()}
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    full = chip_smoke._logits(cfg, params, seq, torch.float32, extra=extra)[0]
    limit = chip_smoke.decode_limit(cfg, params, seq, torch.float32, full, 24, extra)
    how = {}
    if fault == "a zeroed attention KV cache":
        how = {"zero": chip_smoke.ATTN_FAULTS[fault]}
    elif fault:
        how = {"decode_extra": {k: torch.from_numpy(v) for k, v in image(cfg, 13).items()}}
    rows = chip_smoke.decode_vs_full(cfg, params, seq, torch.float32, full, prompt=24,
                                     extra=extra, **how)
    over = [label for label, err in rows if err > limit]
    if fault:
        assert over and all("decode" in label for label in over), rows
    else:
        assert not over, rows


def test_params_from_jax_is_the_references_tree():
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    params = params_from_jax(cfg, jax_tree(jcfg, 0), device="cpu")
    assert sorted(params["layers"][4]["mixer"]) == ["wk", "wo", "wq", "wv"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
