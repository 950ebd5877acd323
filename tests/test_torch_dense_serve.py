"""The port's global-attention decoders against the JAX package, on the CPU
at the smoke size: minitron-8b (2 layers, d_model 64, 4 query heads over 2
KV heads), deepseek-7b (MHA, 4 over 4), qwen2.5-32b (q/k/v biases) and
deepseek-coder-33b (3 layers, head dim 14).

Both sides get the same weights (a JAX tree, jittered with numpy so that
the q/k/v biases and norm gains, zero and one at init, move the output,
carried over by ``params_from_jax``) and the same numpy tokens.
Tolerances, as in the other serve tests:

* f32: rtol = atol = 1e-4;
* bf16: rtol = atol = 2e-2, the tolerance of ``tests/test_archs_smoke.py``;
  bf16 rounds at other places in the two frameworks' matmuls.

The serve flow is prefill in f32 compute on an f32 cache, then decode in
the test's dtype on that cache (the port on weights cast once by
``cast_params_``, JAX on its f32 weights).  ``test_torch_moe_serve.py``
reuses the flow helpers for granite-moe-3b-a800m, and the deepseek-v3 and
vision tests for theirs; ``extra`` there is a dict of numpy inputs that goes
with every call beside the tokens (a VLM's image context).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers, model
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import TrainConfig, build_serve_step

REPO = Path(__file__).resolve().parents[1]
DENSE = ("minitron-8b", "deepseek-7b", "qwen2.5-32b", "deepseek-coder-33b")
B = 2
PROMPT, GEN = 9, 4                # the cache holds PROMPT + GEN positions, as serve() sizes it
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _jitter(path, leaf, rng):
    name = str(path[-1].key)
    if name == "b":                               # q/k/v biases (JAX inits them at 0)
        return rng.normal(0.0, 0.3, leaf.shape)
    if name == "g":
        return 1.0 + rng.normal(0.0, 0.1, leaf.shape)
    if name == "w" and str(path[-2].key) == "router":
        return rng.normal(0.0, 0.5, leaf.shape)   # decisive routing (0.02 at init)
    return leaf


def jax_tree(jcfg, seed=0):
    """The JAX parameters of ``jcfg``, jittered, as numpy f32 arrays."""
    params = jax_model.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(_jitter(p, np.asarray(a), rng), np.float32), params
    )


def tokens(cfg, seed, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)


def jax_flow(jcfg, tree, toks, prompt, dtype, greedy, extra=None):
    """The JAX serve flow over a cache of ``toks.shape[1]`` positions:
    prefill ``prompt`` tokens in f32, then decode steps in ``dtype``
    (forward + argmax over the last position's f32 logits), fed greedily or
    with ``toks``.  Returns the last-position logits and the tokens."""
    p = jax.tree.map(jnp.asarray, tree)
    more = {k: jnp.asarray(v) for k, v in (extra or {}).items()}
    cache = jax_model.init_cache(jcfg, B, toks.shape[1], dtype=jnp.float32)
    logits, cache = jax_model.forward(jcfg, p, {"tokens": jnp.asarray(toks[:, :prompt]), **more},
                                      cache=cache, compute_dtype=jnp.float32)
    outs, out_toks = [], []
    for t in range(prompt, toks.shape[1] + 1):
        last = logits[:, -1].astype(jnp.float32)
        outs.append(np.asarray(last))
        out_toks.append(np.asarray(jnp.argmax(last, -1)))
        if t == toks.shape[1]:
            break
        nxt = out_toks[-1] if greedy else toks[:, t]
        logits, cache = jax_model.forward(jcfg, p, {"tokens": jnp.asarray(nxt[:, None], jnp.int32),
                                                    **more},
                                          cache=cache, compute_dtype=dtype)
    return outs, np.stack(out_toks, 1).astype(np.int32)


def port_flow(cfg, params, toks, prompt, dtype, greedy, extra=None):
    """The port's serve flow, as ``jax_flow``, decoding through
    ``build_serve_step``; checks on the way that the step hands back the
    cache ``forward`` makes."""
    step = build_serve_step(cfg, TrainConfig(compute_dtype=dtype), kind="decode", device="cpu")
    more = {k: torch.from_numpy(v) for k, v in (extra or {}).items()}
    with torch.inference_mode():
        cache = model.init_cache(cfg, B, toks.shape[1], dtype=torch.float32, device="cpu")
        logits, cache = model.forward(cfg, params,
                                      {"tokens": torch.from_numpy(toks[:, :prompt]), **more},
                                      cache=cache, compute_dtype=torch.float32)
        model.cast_params_(params, dtype)
        outs, out_toks = [], []
        for t in range(prompt, toks.shape[1] + 1):
            last = logits[:, -1].float()
            outs.append(last.numpy())
            out_toks.append(last.argmax(-1).to(torch.int32))
            if t == toks.shape[1]:
                break
            nxt = out_toks[-1] if greedy else torch.from_numpy(toks[:, t])
            batch = {"tokens": nxt[:, None], **more}
            logits, want_cache = model.forward(cfg, params, batch, cache=cache, compute_dtype=dtype)
            tok, cache = step(params, cache, batch)
            assert torch.equal(tok, logits[:, -1].float().argmax(-1).to(torch.int32))
            for got, want in zip(jax.tree.leaves(cache), jax.tree.leaves(want_cache)):
                assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    return outs, torch.stack(out_toks, 1).numpy()


def check_forward(cfg, jcfg, tree, toks, dtype, extra=None):
    more = extra or {}
    want, _ = jax_model.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(toks),
                                 **{k: jnp.asarray(v) for k, v in more.items()}},
                                compute_dtype=getattr(jnp, dtype))
    with torch.inference_mode():
        got, cache = model.forward(cfg, params_from_jax(cfg, tree, device="cpu"),
                                   {"tokens": torch.from_numpy(toks),
                                    **{k: torch.from_numpy(v) for k, v in more.items()}},
                                   compute_dtype=getattr(torch, dtype))
    assert cache is None
    assert got.shape == (*toks.shape, cfg.vocab_size) and got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def check_serve_flow(cfg, jcfg, tree, toks, dtype, extra=None):
    greedy = dtype == "float32"          # bf16 argmax may flip on a near tie: feed tokens
    want_logits, want_toks = jax_flow(jcfg, tree, toks, PROMPT, getattr(jnp, dtype), greedy,
                                      extra)
    got_logits, got_toks = port_flow(cfg, params_from_jax(cfg, tree, device="cpu"), toks, PROMPT,
                                     getattr(torch, dtype), greedy, extra)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, **tol)
    if greedy:
        np.testing.assert_array_equal(got_toks, want_toks)
        # launch.serve's own flow (f32 decode here) yields the same greedy tokens
        res = serve_mod.serve(cfg, params_from_jax(cfg, tree, device="cpu"), toks[:, :PROMPT],
                              GEN + 1, TrainConfig(compute_dtype=torch.float32), "cpu",
                              (extra or {}).get("img"))
        np.testing.assert_array_equal(res.tokens, want_toks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, dtype):
    cfg = get_smoke_config(arch)
    check_forward(cfg, jax_get_smoke_config(arch), jax_tree(jax_get_smoke_config(arch), 0),
                  tokens(cfg, 1, 20), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_jax_serve_flow(arch, dtype):
    cfg = get_smoke_config(arch)
    check_serve_flow(cfg, jax_get_smoke_config(arch), jax_tree(jax_get_smoke_config(arch), 2),
                     tokens(cfg, 3, PROMPT + GEN), dtype)


FLASH_CASES = {
    # name: (Sq, Sk, q_chunk, kv_chunk, causal, q heads, kv heads, head dim)
    "one block": (32, 32, 32, 32, True, 4, 2, 16),
    "4 x 4 blocks": (64, 64, 16, 16, True, 4, 2, 16),
    "q chunk < kv chunk, MQA": (64, 64, 16, 32, True, 4, 1, 16),
    "q chunk > kv chunk, head dim 14": (60, 60, 20, 12, True, 4, 2, 14),
    "not causal, Sq != Sk": (32, 64, 8, 16, False, 4, 2, 16),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_jax(case, dtype):
    sq, sk, qc, kc, causal, hq, hkv, d = FLASH_CASES[case]
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(0, 1, (B, s, h, d)).astype(np.float32)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    want = jax_layers.flash_attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                                      causal=causal, q_chunk=qc, kv_chunk=kc)
    t = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v)]
    got = layers.flash_attention(*t, causal=causal, q_chunk=qc, kv_chunk=kc)
    assert got.dtype == t[0].dtype and got.shape == (B, sq, hq, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    if dtype == "float32" and sq == sk:       # and the scores materialised agree with it
        dense = layers.dense_attention(*t, causal=causal)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), **F32_TOL)


def test_long_forward_goes_through_flash_attention(monkeypatch):
    """S = 1088 puts S^2 above attention_any's dense threshold (1024^2) with
    no window, so both sides take flash attention, in chunks of 544 (the
    largest divisor of 1088 up to 1024): 2 x 2 blocks per layer."""
    arch = "minitron-8b"
    cfg, jcfg = get_smoke_config(arch), jax_get_smoke_config(arch)
    seen = []
    real = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(layers, "flash_attention", spy)
    tree = jax_tree(jcfg, 5)
    toks = tokens(cfg, 6, 1088)[:1]
    want, _ = jax_model.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(toks)}, compute_dtype=jnp.float32)
    with torch.inference_mode():
        got, _ = model.forward(cfg, params_from_jax(cfg, tree, device="cpu"),
                               {"tokens": torch.from_numpy(toks)}, compute_dtype=torch.float32)
    assert seen == [{"causal": True, "q_chunk": 544, "kv_chunk": 544}] * cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", DENSE + ("granite-moe-3b-a800m",))
def test_param_count_matches_jax(arch, full):
    get, jax_get = (get_config, jax_get_config) if full else (get_smoke_config,
                                                              jax_get_smoke_config)
    assert model.param_count(get(arch)) == jax_model.param_count(jax_get(arch))
    if full and arch in ("minitron-8b", "granite-moe-3b-a800m"):     # the two served on the card
        assert model.param_count(get(arch)) == {"minitron-8b": 9_882_046_464,
                                                "granite-moe-3b-a800m": 3_298_793_472}[arch]


def test_global_attention_cache_is_linear():
    """An ``attn`` block caches every position (``repro/models/model.py:93-94``):
    a linear cache of max_len, never a ring."""
    cfg = get_smoke_config("minitron-8b")
    with pytest.raises(ValueError, match="max_len"):
        model.init_cache(cfg, 1, device="cpu")
    for layer in model.init_cache(cfg, 1, 4100, device="cpu")["layers"]:
        assert layer["k"].shape == layer["v"].shape == (1, 4100, 2, 16) and layer["len"] == 0


def _chip_smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_chip_smoke_gate(cfg, seq, prompt, fault):
    """chip_smoke.py's stepwise-decode check at the smoke size: it passes on
    the port and fails when every decode step is fed a zeroed KV cache."""
    chip_smoke = _chip_smoke_module()
    names = chip_smoke.ATTN_FAULTS["a zeroed attention KV cache"] if fault else ()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    full = chip_smoke._logits(cfg, params, seq, torch.float32)[0]
    limit = chip_smoke.decode_limit(cfg, params, seq, torch.float32, full, prompt)
    rows = chip_smoke.decode_vs_full(cfg, params, seq, torch.float32, full,
                                     prompt=prompt, zero=names)
    assert len(rows) == 1 + seq.shape[1] - prompt
    over = [label for label, err in rows if err > limit]
    if fault:
        assert over and all("decode" in label for label in over), rows
    else:
        assert not over, rows


@pytest.mark.parametrize("fault", [False, True])
def test_chip_smoke_decode_gate_catches_zeroed_kv_cache(fault):
    cfg = get_smoke_config("minitron-8b")
    seq = torch.from_numpy(tokens(cfg, 11, 28))
    check_chip_smoke_gate(cfg, seq, 24, fault)


@pytest.mark.parametrize("arch", [a for a in ARCHS[2:] if not get_config(a).is_encoder_only])
def test_serve_cli_on_cpu(arch, capsys):
    res = serve_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "5", "--gen-len", "3"])
    assert res.tokens.shape == (2, 3) and res.tokens.dtype == np.int32
    assert f"{arch}-smoke" in capsys.readouterr().out
