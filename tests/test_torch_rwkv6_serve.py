"""The port's rwkv6 serving path against the JAX package, on the CPU at the
smoke size (rwkv6-7b-smoke: 2 layers, d_model 64, head dim 16).

Both sides get the same weights (a JAX tree, jittered with numpy so that
every parameter moves the output, carried over by ``params_from_jax``) and
the same numpy tokens.  Tolerances:

* f32: rtol = atol = 1e-4.  The JAX forward takes the chunked WKV6 form
  (cumulative log-decays) for T > 1, the port the sequential recurrence.
* bf16: rtol = atol = 2e-2, the tolerance of ``tests/test_archs_smoke.py``;
  bf16 rounds at other places in the two frameworks' matmuls.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import model as jax_model
from repro_torch.configs.base import Block
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.train.train_step import TrainConfig, build_serve_step

REPO = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-7b"
B, S, S_PRE = 2, 12, 8
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _jitter(path, leaf, rng):
    name = str(path[-1].key)
    if name in ("mu", "mu_k", "mu_r"):
        return rng.uniform(0.0, 1.0, leaf.shape)
    if name == "w_base":
        return rng.uniform(-2.5, -0.5, leaf.shape)
    if name in ("a", "b"):                       # LoRA factors
        return rng.normal(0.0, 0.1, leaf.shape)
    if name in ("g", "ln_g"):
        return 1.0 + rng.normal(0.0, 0.1, leaf.shape)
    if name in ("ln_b", "u"):
        return rng.normal(0.0, 0.3, leaf.shape)
    return leaf


def _jax_tree(seed=0):
    params = jax_model.init_params(jax_get_smoke_config(ARCH), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(_jitter(p, np.asarray(a), rng), np.float32), params
    )


def _tokens(seed, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, get_smoke_config(ARCH).vocab_size, (B, s)).astype(np.int32)


def _jax_flow(tree, tokens, dtype, greedy):
    """The JAX serve flow: prefill with a cache, then decode steps as
    ``build_serve_step``'s decode core computes them (forward + argmax over
    the last position's f32 logits), fed greedily or with ``tokens``."""
    cfg = jax_get_smoke_config(ARCH)
    p = jax.tree.map(jnp.asarray, tree)
    cache = jax_model.init_cache(cfg, B, S, dtype=dtype)
    logits, cache = jax_model.forward(cfg, p, {"tokens": jnp.asarray(tokens[:, :S_PRE])},
                                      cache=cache, compute_dtype=dtype)
    outs = [np.asarray(logits[:, -1].astype(jnp.float32))]
    toks = [np.asarray(jnp.argmax(logits[:, -1].astype(jnp.float32), -1))]
    for t in range(S_PRE, S_PRE + 2):
        nxt = toks[-1] if greedy else tokens[:, t]
        logits, cache = jax_model.forward(cfg, p, {"tokens": jnp.asarray(nxt[:, None], jnp.int32)},
                                          cache=cache, compute_dtype=dtype)
        outs.append(np.asarray(logits[:, -1].astype(jnp.float32)))
        toks.append(np.asarray(jnp.argmax(logits[:, -1].astype(jnp.float32), -1)))
    return outs, np.stack(toks, 1).astype(np.int32)


def _port_flow(params, tokens, dtype, greedy):
    cfg = get_smoke_config(ARCH)
    step = build_serve_step(cfg, TrainConfig(compute_dtype=dtype), kind="decode", device="cpu")
    with torch.inference_mode():
        cache = model.init_cache(cfg, B, dtype=dtype, device="cpu")
        logits, cache = model.forward(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S_PRE])},
                                      cache=cache, compute_dtype=dtype)
        outs = [logits[:, -1].float().numpy()]
        toks = [logits[:, -1].float().argmax(-1).to(torch.int32)]
        for t in range(S_PRE, S_PRE + 2):
            nxt = toks[-1] if greedy else torch.from_numpy(tokens[:, t])
            batch = {"tokens": nxt[:, None]}
            logits, _ = model.forward(cfg, params, batch, cache=cache, compute_dtype=dtype)
            tok, cache = step(params, cache, batch)
            outs.append(logits[:, -1].float().numpy())
            toks.append(tok)
    return outs, torch.stack(toks, 1).numpy()


def test_forward_matches_jax_f32():
    tree = _jax_tree(0)
    tokens = _tokens(1)
    want, _ = jax_model.forward(jax_get_smoke_config(ARCH), jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(tokens)}, compute_dtype=jnp.float32)
    params = params_from_jax(get_smoke_config(ARCH), tree, device="cpu")
    with torch.inference_mode():
        got, cache = model.forward(get_smoke_config(ARCH), params,
                                   {"tokens": torch.from_numpy(tokens)},
                                   compute_dtype=torch.float32)
    assert cache is None
    assert got.shape == (B, S, get_smoke_config(ARCH).vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_prefill_decode_matches_jax_serve_flow_f32():
    tree = _jax_tree(2)
    tokens = _tokens(3)
    want_logits, want_toks = _jax_flow(tree, tokens, jnp.float32, greedy=True)
    params = params_from_jax(get_smoke_config(ARCH), tree, device="cpu")
    got_logits, got_toks = _port_flow(params, tokens, torch.float32, greedy=True)
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, **F32_TOL)
    np.testing.assert_array_equal(got_toks, want_toks)
    # launch.serve's own flow (f32 decode here) yields the same greedy tokens
    res = serve_mod.serve(get_smoke_config(ARCH), params, tokens[:, :S_PRE], 3,
                          TrainConfig(compute_dtype=torch.float32), "cpu")
    np.testing.assert_array_equal(res.tokens, want_toks)


def test_prefill_decode_matches_jax_bf16():
    tree = _jax_tree(4)
    tokens = _tokens(5)
    want_logits, _ = _jax_flow(tree, tokens, jnp.bfloat16, greedy=False)
    params = model.cast_params_(params_from_jax(get_smoke_config(ARCH), tree, device="cpu"),
                                torch.bfloat16)
    got_logits, _ = _port_flow(params, tokens, torch.bfloat16, greedy=False)
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, **BF16_TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_recurrence_inputs_are_rounded_like_jax(dtype, monkeypatch):
    """As in ``repro.models.rwkv6`` (rwkv6.py:202-203): r/k/v/w/u reach the
    f32 recurrence rounded to the compute dtype (in bf16 the decay near init,
    0.99752, becomes 0.99609); the state stays f32."""
    from repro_torch.models import rwkv6

    real, seen = rwkv6.wkv6, []

    def spy(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(rwkv6, "wkv6", spy)
    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.inference_mode():
        model.forward(cfg, params, {"tokens": torch.from_numpy(_tokens(6))}, compute_dtype=dtype)
    assert len(seen) == cfg.n_layers
    for r, k, v, w, u, s0 in seen:
        assert all(x.dtype == torch.float32 for x in (r, k, v, w, u, s0))
        rounded = [torch.equal(x, x.to(torch.bfloat16).float()) for x in (r, k, v, w, u)]
        assert all(rounded) == (dtype == torch.bfloat16)


def test_cast_params_keeps_f32_leaves():
    params = model.init_params(get_smoke_config(ARCH), torch.Generator().manual_seed(0), "cpu")
    model.cast_params_(params, torch.bfloat16)
    mixer = params["layers"][0]["mixer"]
    assert {k for k in ("w_base", "ln_g", "ln_b") if mixer[k].dtype == torch.float32} == \
        {"w_base", "ln_g", "ln_b"}
    assert mixer["wr"]["w"].dtype == mixer["u"].dtype == torch.bfloat16
    assert params["lm_head"]["w"].dtype == params["embed"]["table"].dtype == torch.bfloat16


def _break(tree, how):
    if how == "missing":
        del tree["final_norm"]["g"]
    elif how == "extra":
        tree["final_norm"]["bias"] = np.zeros(4, np.float32)
    elif how == "shape":
        tree["lm_head"]["w"] = tree["lm_head"]["w"][:, :10]
    else:                                           # scan axis too short
        tree["scan"][0]["mixer"]["u"] = tree["scan"][0]["mixer"]["u"][:1]
    return tree


@pytest.mark.parametrize("how", ["missing", "extra", "shape", "scan_axis"])
def test_params_from_jax_refuses_mismatched_tree(how):
    tree = _break(_jax_tree(0), how)
    with pytest.raises(ValueError):
        params_from_jax(get_smoke_config(ARCH), tree, device="cpu")


@pytest.mark.parametrize("full", [False, True])
def test_param_count_matches_jax(full):
    if full:
        n = model.param_count(get_config(ARCH))
        assert n == jax_model.param_count(jax_get_config(ARCH))
        assert 7.5e9 < n < 7.6e9
    else:
        assert model.param_count(get_smoke_config(ARCH)) == \
            jax_model.param_count(jax_get_smoke_config(ARCH))


def test_registry_matches_jax_and_refuses_unknown_arch():
    assert ARCHS == ("rwkv6-7b", "recurrentgemma-9b", "minitron-8b", "deepseek-7b",
                     "qwen2.5-32b", "deepseek-coder-33b", "granite-moe-3b-a800m",
                     "deepseek-v3-671b", "llama-3.2-vision-90b", "hubert-xlarge")
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for arch in ARCHS:
        for get, jax_get in ((get_config, jax_get_config),
                             (get_smoke_config, jax_get_smoke_config)):
            ours, theirs = dataclasses.asdict(get(arch)), dataclasses.asdict(jax_get(arch))
            assert ours == theirs, arch
    with pytest.raises(KeyError, match="rwkv6-7b"):
        get_config("deepseek-v4")


def test_unported_blocks_name_their_slice():
    """Every block kind and frontend of the reference is ported: each of
    its configs builds (MLA, cross-attention and the frames frontend came
    last).  A block kind the reference does not know is refused by name,
    as the reference's ``_block_init`` refuses it."""
    smoke = get_smoke_config(ARCH)
    moe = get_smoke_config("granite-moe-3b-a800m").moe
    mla = get_smoke_config("deepseek-v3-671b").mla
    for block in (Block("attn", "dense"), Block("rglru", "moe"), Block("mla", "dense"),
                  Block("attn_cross", "none")):
        cfg = dataclasses.replace(smoke, blocks_pattern=(block,), moe=moe, mla=mla)
        assert model.param_count(cfg) == jax_model.param_count(cfg)
    frames = dataclasses.replace(smoke, frontend="frames")
    assert "embed_proj" in model.init_params(frames, None, "meta")
    for block, what in ((Block("ssm", "dense"), "unknown mixer 'ssm'"),
                        (Block("attn", "glu"), "unknown ffn 'glu'")):
        with pytest.raises(ValueError, match=what):
            model.init_params(dataclasses.replace(smoke, blocks_pattern=(block,)), None, "meta")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    cfg = get_smoke_config(ARCH)
    for call in (
        lambda: model.init_params(cfg, torch.Generator()),
        lambda: model.init_cache(cfg, 1),
        lambda: build_serve_step(cfg, TrainConfig()),
        lambda: serve_mod.main(["--smoke"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _chip_smoke_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "state dropped", "state decayed"])
def test_chip_smoke_decode_gate_catches_cache_faults(fault, monkeypatch):
    """chip_smoke.py's stepwise-decode check, at the smoke size: it passes on
    the port and fails when decode loses the carried WKV state or scales it
    by 0.99."""
    from repro_torch.models import rwkv6

    chip_smoke = _chip_smoke_module()
    real = rwkv6.wkv6

    def faulty(r, k, v, w, u, s0):
        if r.shape[1] == 1:                        # decode steps only
            s0 = torch.zeros_like(s0) if fault == "state dropped" else 0.99 * s0
        return real(r, k, v, w, u, s0)

    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seq = torch.from_numpy(_tokens(7, s=chip_smoke.CHECK_PROMPT + chip_smoke.CHECK_STEPS))
    full = chip_smoke._logits(cfg, params, seq, torch.float32)[0]
    limit = chip_smoke.decode_limit(cfg, params, seq, torch.float32, full)
    if fault:
        monkeypatch.setattr(rwkv6, "wkv6", faulty)
    rows = chip_smoke.decode_vs_full(cfg, params, seq, torch.float32, full)
    assert len(rows) == 1 + chip_smoke.CHECK_STEPS
    over = [label for label, err in rows if err > limit]
    if fault:
        assert over and all("decode" in label for label in over)
    else:
        assert not over, rows
    # the script's own fault: a zeroed state fed to each decode step
    zeroed = chip_smoke.decode_vs_full(cfg, params, seq, torch.float32, full, zero=("s",))
    assert max(err for _, err in zeroed) > limit


def test_serve_refuses_params_it_already_cast():
    cfg = get_smoke_config(ARCH)
    params = serve_mod.init_model(cfg, TrainConfig(), seed=0, device="cpu")
    prompts = serve_mod.make_prompts(cfg, 2, 5)
    serve_mod.serve(cfg, params, prompts, 2, TrainConfig(), "cpu")
    assert model.param_dtypes(params) == {torch.bfloat16}
    with pytest.raises(ValueError, match="already cast"):
        serve_mod.serve(cfg, params, prompts, 2, TrainConfig(), "cpu")


def test_serve_cli_on_cpu(capsys):
    res = serve_mod.main(["--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "5", "--gen-len", "3"])
    assert res.tokens.shape == (2, 3) and res.tokens.dtype == np.int32
    assert "sample row" in capsys.readouterr().out


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.split('.')[0] == 'repro')\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    if torch.cuda.is_available() and where == "repo":
        pytest.skip("on a card the script runs its full smoke")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
