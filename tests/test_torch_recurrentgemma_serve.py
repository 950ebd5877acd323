"""The port's recurrentgemma serving path against the JAX package, on the CPU
at the smoke size (recurrentgemma-9b-smoke: 3 layers (rglru, rglru,
attn_local), d_model 64, 4 heads over 1 KV head, local window 32).

Both sides get the same weights (a JAX tree, jittered with numpy so that
every parameter moves the output, carried over by ``params_from_jax``) and
the same numpy tokens.  Tolerances:

* f32: rtol = atol = 1e-4.  The JAX block sums the RG-LRU recurrence with
  an associative scan, the port sweeps it in order.
* bf16: rtol = atol = 2e-2, the tolerance of ``tests/test_archs_smoke.py``;
  bf16 rounds at other places in the two frameworks' matmuls.

The bf16 flow is the serving flow: prefill in f32 compute on an f32 cache,
then decode in bf16 compute on that cache (the port on weights cast once
by ``cast_params_``, JAX on its f32 weights).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import layers, model, rglru
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import TrainConfig, build_serve_step

ARCH = "recurrentgemma-9b"
B = 2
WINDOW = 32                                   # the smoke config's local window
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# (prompt, generated tokens); the cache holds prompt + generated positions,
# as serve() sizes it
CACHE_CASES = {
    "linear": (16, 5),            # 21 < window: a linear cache with the window mask
    "ring": (24, 8),              # 32 = window: a ring, 31 writes, no wrap
    "ring_wrap": (WINDOW, 9),     # a ring of 32; 8 decode steps wrap and evict
}


def _jitter(path, leaf, rng):
    name = str(path[-1].key)
    if name == "b":                               # gate biases (JAX inits them at 0)
        return rng.normal(0.0, 0.3, leaf.shape)
    if name == "conv_b":
        return rng.normal(0.0, 0.1, leaf.shape)
    if name == "lam":                             # decays away from 1, so h moves
        return rng.uniform(-1.0, 3.0, leaf.shape)
    if name == "g":
        return 1.0 + rng.normal(0.0, 0.1, leaf.shape)
    return leaf


def _jax_tree(seed=0):
    params = jax_model.init_params(jax_get_smoke_config(ARCH), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(_jitter(p, np.asarray(a), rng), np.float32), params
    )


def _tokens(seed, s):
    rng = np.random.default_rng(seed)
    return rng.integers(0, get_smoke_config(ARCH).vocab_size, (B, s)).astype(np.int32)


def _port_params(tree):
    return params_from_jax(get_smoke_config(ARCH), tree, device="cpu")


def _jax_flow(tree, tokens, prompt, gen, dtype, greedy):
    """The JAX serve flow: prefill in f32 on an f32 cache of prompt + gen
    positions, then gen - 1 decode steps in ``dtype`` (forward + argmax
    over the last position's f32 logits), fed greedily or with ``tokens``."""
    cfg = jax_get_smoke_config(ARCH)
    p = jax.tree.map(jnp.asarray, tree)
    cache = jax_model.init_cache(cfg, B, prompt + gen, dtype=jnp.float32)
    logits, cache = jax_model.forward(cfg, p, {"tokens": jnp.asarray(tokens[:, :prompt])},
                                      cache=cache, compute_dtype=jnp.float32)
    outs, toks = [], []
    for t in range(prompt, prompt + gen):
        last = logits[:, -1].astype(jnp.float32)
        outs.append(np.asarray(last))
        toks.append(np.asarray(jnp.argmax(last, -1)))
        if t == prompt + gen - 1:
            break
        nxt = toks[-1] if greedy else tokens[:, t]
        logits, cache = jax_model.forward(cfg, p, {"tokens": jnp.asarray(nxt[:, None], jnp.int32)},
                                          cache=cache, compute_dtype=dtype)
    return outs, np.stack(toks, 1).astype(np.int32)


def _port_flow(params, tokens, prompt, gen, dtype, greedy):
    """The port's serve flow, decoding through ``build_serve_step``; checks
    on the way that the step hands back the cache ``forward`` makes."""
    cfg = get_smoke_config(ARCH)
    step = build_serve_step(cfg, TrainConfig(compute_dtype=dtype), kind="decode", device="cpu")
    with torch.inference_mode():
        cache = model.init_cache(cfg, B, prompt + gen, dtype=torch.float32, device="cpu")
        logits, cache = model.forward(cfg, params, {"tokens": torch.from_numpy(tokens[:, :prompt])},
                                      cache=cache, compute_dtype=torch.float32)
        model.cast_params_(params, dtype)
        outs, toks = [], []
        for t in range(prompt, prompt + gen):
            last = logits[:, -1].float()
            outs.append(last.numpy())
            toks.append(last.argmax(-1).to(torch.int32))
            if t == prompt + gen - 1:
                break
            nxt = toks[-1] if greedy else torch.from_numpy(tokens[:, t])
            batch = {"tokens": nxt[:, None]}
            logits, want_cache = model.forward(cfg, params, batch, cache=cache, compute_dtype=dtype)
            tok, cache = step(params, cache, batch)
            assert torch.equal(tok, logits[:, -1].float().argmax(-1).to(torch.int32))
            for got, want in zip(jax.tree.leaves(cache), jax.tree.leaves(want_cache)):
                assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    return outs, torch.stack(toks, 1).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    tree = _jax_tree(0)
    tokens = _tokens(1, 20)
    want, _ = jax_model.forward(jax_get_smoke_config(ARCH), jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(tokens)}, compute_dtype=getattr(jnp, dtype))
    with torch.inference_mode():
        got, cache = model.forward(get_smoke_config(ARCH), _port_params(tree),
                                   {"tokens": torch.from_numpy(tokens)},
                                   compute_dtype=getattr(torch, dtype))
    assert cache is None
    assert got.shape == (B, 20, get_smoke_config(ARCH).vocab_size)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_jax_serve_flow(dtype, case):
    prompt, gen = CACHE_CASES[case]
    tree = _jax_tree(2)
    tokens = _tokens(3, prompt + gen)
    greedy = dtype == "float32"          # bf16 argmax may flip on a near tie: feed tokens
    want_logits, want_toks = _jax_flow(tree, tokens, prompt, gen, getattr(jnp, dtype), greedy)
    got_logits, got_toks = _port_flow(_port_params(tree), tokens, prompt, gen,
                                      getattr(torch, dtype), greedy)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, **tol)
    if greedy:
        np.testing.assert_array_equal(got_toks, want_toks)
        # launch.serve's own flow (f32 decode here) yields the same greedy tokens
        res = serve_mod.serve(get_smoke_config(ARCH), _port_params(tree), tokens[:, :prompt], gen,
                              TrainConfig(compute_dtype=torch.float32), "cpu")
        np.testing.assert_array_equal(res.tokens, want_toks)


def test_banded_attention_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(0, 1, (B, 96, h, 16)).astype(np.float32) for h in (4, 1, 1))
    want = np.asarray(jax_layers.banded_attention(*map(jnp.asarray, (q, k, v)),
                                                  window=WINDOW, q_chunk=WINDOW))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    np.testing.assert_allclose(layers.banded_attention(*t, window=WINDOW, q_chunk=WINDOW).numpy(),
                               want, **F32_TOL)
    # and the dense form with the window mask agrees with it
    np.testing.assert_allclose(layers.dense_attention(*t, window=WINDOW).numpy(), want, **F32_TOL)


def test_long_forward_goes_through_banded_attention(monkeypatch):
    """S = 1088 puts S^2 above attention_any's dense threshold (1024^2), so
    both sides take banded attention, in q chunks of the window (32)."""
    seen = []
    real = layers.banded_attention

    def spy(q, k, v, **kw):
        seen.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(layers, "banded_attention", spy)
    tree = _jax_tree(5)
    tokens = _tokens(6, 1088)
    want, _ = jax_model.forward(jax_get_smoke_config(ARCH), jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(tokens)}, compute_dtype=jnp.float32)
    with torch.inference_mode():
        got, _ = model.forward(get_smoke_config(ARCH), _port_params(tree),
                               {"tokens": torch.from_numpy(tokens)}, compute_dtype=torch.float32)
    assert seen == [{"window": WINDOW, "q_chunk": WINDOW}]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_flash_branch_names_its_slice():
    """The flash branch of ``attention_any``, which raised before the
    global-attention slice, at the shape it raised on: S = 1088 with no
    window takes flash attention on both sides (chunks of 544) and agrees
    with JAX; causal and not."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.normal(0, 1, (1, 1088, h, 16)).astype(np.float32) for h in (4, 1, 1))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    for causal in (True, False):
        want = jax_layers.attention_any(*map(jnp.asarray, (q, k, v)), causal=causal, window=0)
        got = layers.attention_any(*t, causal=causal, window=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_ring_prefill_longer_than_window_is_refused_where_jax_diverges():
    """Fault 5 of the reference: a prefill longer than the window into a
    ring cache writes duplicate indices and shifts the queries' positions
    (``repro/models/layers.py:390-402``).  JAX's cached forward then differs
    from its own uncached forward; the port refuses the prefill."""
    tree = _jax_tree(7)
    tokens = _tokens(8, 40)
    cfg = jax_get_smoke_config(ARCH)
    p = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": jnp.asarray(tokens)}
    cached, _ = jax_model.forward(cfg, p, batch, cache=jax_model.init_cache(cfg, B, 48, jnp.float32),
                                  compute_dtype=jnp.float32)
    plain, _ = jax_model.forward(cfg, p, batch, compute_dtype=jnp.float32)
    rel = float(jnp.abs(cached - plain).max() / jnp.abs(plain).max())
    assert rel > 0.05, rel

    params = _port_params(tree)
    pcfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="wraps the ring cache"):
        model.forward(pcfg, params, {"tokens": torch.from_numpy(tokens)},
                      cache=model.init_cache(pcfg, B, 48, dtype=torch.float32, device="cpu"),
                      compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="fault 5"):
        serve_mod.serve(pcfg, params, tokens, 8, TrainConfig(), "cpu")
    # a prompt of exactly the window fills the ring without a wrap: served
    serve_mod.serve(pcfg, _port_params(tree), tokens[:, :WINDOW], 3, TrainConfig(), "cpu")


def test_cast_params_keeps_rglru_gates_f32():
    params = model.init_params(get_smoke_config(ARCH), torch.Generator().manual_seed(0), "cpu")
    model.cast_params_(params, torch.bfloat16)
    rg, attn = params["layers"][0]["mixer"], params["layers"][2]["mixer"]
    kept = [rg["wa"]["w"], rg["wa"]["b"], rg["wx"]["w"], rg["wx"]["b"], rg["lam"]]
    assert all(x.dtype == torch.float32 for x in kept)
    cast = [rg["w_in"]["w"], rg["w_gate"]["w"], rg["w_out"]["w"], rg["conv_w"], rg["conv_b"],
            attn["wq"]["w"], attn["wo"]["w"], params["layers"][0]["norm1"]["g"],
            params["layers"][0]["ffn"]["wi"]["w"], params["final_norm"]["g"],
            params["lm_head"]["w"], params["embed"]["table"]]
    assert all(x.dtype == torch.bfloat16 for x in cast)
    assert model.param_dtypes(params) == {torch.bfloat16}


@pytest.mark.parametrize("mutate", [None, "wa", "wx", "lam"])
def test_bf16_decode_gates_match_jax(mutate, monkeypatch):
    """In bf16 decode on the f32 cache the conv output is f32, so JAX
    computes the RG-LRU gates from its f32 weights (``rglru.py:58,93-95``).
    The port's decay a and input term of a bf16 decode step must match
    JAX's gate math on the same conv output in f32.  A bf16 ``wa`` (or
    ``wx``, or ``lam``) moves them by ~1e-3 and fails; at the logits, the
    bf16 noise of the whole model (2e-2) would hide it."""
    tree = _jax_tree(9)
    tokens = _tokens(10, 13)
    cfg = get_smoke_config(ARCH)
    params = _port_params(tree)
    seen = []
    real_conv, real_scan = rglru._causal_conv1d, rglru.rglru_scan
    monkeypatch.setattr(rglru, "_causal_conv1d",
                        lambda *a: seen.append(real_conv(*a)) or seen[-1])
    monkeypatch.setattr(rglru, "rglru_scan",
                        lambda a, b, h0: seen.append((a, b)) or real_scan(a, b, h0))
    with torch.inference_mode():
        cache = model.init_cache(cfg, B, 13, dtype=torch.float32, device="cpu")
        _, cache = model.forward(cfg, params, {"tokens": torch.from_numpy(tokens[:, :12])},
                                 cache=cache, compute_dtype=torch.float32)
        model.cast_params_(params, torch.bfloat16)
        for layer in params["layers"]:
            if mutate and "lam" in layer["mixer"]:
                m = layer["mixer"]
                if mutate == "lam":
                    m["lam"] = m["lam"].to(torch.bfloat16)
                else:
                    m[mutate]["w"] = m[mutate]["w"].to(torch.bfloat16)
        seen.clear()
        model.forward(cfg, params, {"tokens": torch.from_numpy(tokens[:, 12:])},
                      cache=cache, compute_dtype=torch.bfloat16)
    assert len(seen) == 4                         # (conv, scan) for each of 2 rglru layers
    mismatch = []
    for layer, ((u, _), (a, bterm)) in zip((0, 1), (seen[0:2], seen[2:4])):
        assert u.dtype == torch.float32           # promoted by the f32 conv window
        pj = jax.tree.map(lambda x: jnp.asarray(x[0]), tree["scan"][layer]["mixer"])
        uj = jnp.asarray(u.numpy())
        r = jax.nn.sigmoid(jax_layers.dense_apply(pj["wa"], uj))
        i = jax.nn.sigmoid(jax_layers.dense_apply(pj["wx"], uj))
        log_a = 8.0 * r * jax.nn.log_sigmoid(pj["lam"])[None, None]
        want_b = jnp.sqrt(jnp.maximum(1.0 - jnp.exp(2.0 * log_a), 1e-12)) * (i * uj)
        for got, want in ((a, jnp.exp(log_a)), (bterm, want_b)):
            mismatch.append(not np.allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6))
    assert any(mismatch) == (mutate is not None), mismatch


def _break(tree, how):
    if how == "missing_bias":
        del tree["scan"][0]["mixer"]["wa"]["b"]
    elif how == "extra":
        tree["suffix"][0]["mixer"]["conv_bias"] = np.zeros(4, np.float32)
    elif how == "shape":
        tree["scan"][2]["mixer"]["wk"]["w"] = tree["scan"][2]["mixer"]["wk"]["w"][..., :8]
    elif how == "missing_suffix":
        tree["suffix"] = tree["suffix"][:1]
    else:                                           # scan axis too short
        tree["scan"][1]["mixer"]["lam"] = tree["scan"][1]["mixer"]["lam"][:0]
    return tree


@pytest.mark.parametrize("how", ["missing_bias", "extra", "shape", "missing_suffix", "scan_axis"])
def test_params_from_jax_refuses_broken_tree(how):
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=5)     # one superblock + suffix 2
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), n_layers=5)
    tree = jax.tree.map(np.asarray, jax_model.init_params(jcfg, jax.random.PRNGKey(0)))
    params_from_jax(cfg, tree, device="cpu")        # intact: carried over
    with pytest.raises(ValueError):
        params_from_jax(cfg, _break(tree, how), device="cpu")


@pytest.mark.parametrize("full", [False, True])
def test_param_count_matches_jax(full):
    if full:
        n = model.param_count(get_config(ARCH))
        assert n == jax_model.param_count(jax_get_config(ARCH)) == 10_444_984_320
    else:
        assert model.param_count(get_smoke_config(ARCH)) == \
            jax_model.param_count(jax_get_smoke_config(ARCH))


def test_serve_cli_on_cpu(capsys):
    res = serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "5", "--gen-len", "3"])
    assert res.tokens.shape == (2, 3) and res.tokens.dtype == np.int32
    assert "recurrentgemma-9b-smoke" in capsys.readouterr().out


def test_init_cache_needs_max_len_for_attention():
    with pytest.raises(ValueError, match="max_len"):
        model.init_cache(get_smoke_config(ARCH), 1, device="cpu")
    cache = model.init_cache(get_smoke_config(ARCH), 1, 100, device="cpu")["layers"]
    assert cache[2]["k"].shape == (1, WINDOW, 1, 16) and cache[2]["len"] == 0
    assert cache[0]["h"].dtype == torch.float32 and cache[0]["conv"].shape == (1, 3, 64)


def _chip_smoke_module():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "recurrent", "attention"])
@pytest.mark.parametrize("case", ["linear", "ring_wrap"])
def test_chip_smoke_decode_gate_catches_cache_faults(case, fault):
    """chip_smoke.py's stepwise-decode check of phases 6 and 7 at the smoke
    size: it passes on the port, through a linear cache (prompt 24) and a
    ring that 4 decode steps wrap (prompt = window), and fails when decode
    steps are fed a zeroed RG-LRU state or a zeroed KV cache."""
    chip_smoke = _chip_smoke_module()
    prompt = {"linear": 24, "ring_wrap": WINDOW}[case]
    names = {None: (), "recurrent": ("h", "conv"), "attention": ("k", "v")}[fault]
    assert names in (*chip_smoke.RG_FAULTS.values(), ())
    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = torch.from_numpy(_tokens(11, prompt + 4))
    full = chip_smoke._logits(cfg, params, seq, torch.float32)[0]
    limit = chip_smoke.decode_limit(cfg, params, seq, torch.float32, full, prompt)
    rows = chip_smoke.decode_vs_full(cfg, params, seq, torch.float32, full,
                                     prompt=prompt, zero=names)
    assert len(rows) == 1 + 4
    over = [label for label, err in rows if err > limit]
    if fault:
        assert over and all("decode" in label for label in over), rows
    else:
        assert not over, rows
