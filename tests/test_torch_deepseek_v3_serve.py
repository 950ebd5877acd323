"""deepseek-v3-671b's serving path against the JAX package, on the CPU at
the smoke size (deepseek-v3-671b-smoke: 3 layers, an MLA + dense block then
two MLA + MoE blocks; d_model 64, 4 heads, 8 experts of 32, top 2, one
shared expert; capacity factor 8.0, which drops nothing at this size).

The serve flow (an f32 prefill on an f32 cache, then decode steps in the
test's dtype, decoding through ``build_serve_step``) is held as in
``test_torch_dense_serve.py``, whose helpers run both sides, at its
tolerances (1e-4 in f32, 2e-2 in bf16); the router is jittered to N(0,
0.5) there.  The forward is held at the same tolerances with each MoE
layer's choices recorded on both sides: in bf16 a near tie may route a
token to another expert in each framework, and the test shows that every
such flip is a near tie and holds the positions it cannot reach.  Here
also: ``cast_params_`` freeing each leaf as it goes, the conversion of every
smoke config of this slice, the parameter counts of the full configs, and
``chip_smoke.py``'s decode gate at the smoke size with the MLA cache
zeroed.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import model, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import leaf_paths
from test_torch_dense_serve import (
    BF16_TOL,
    F32_TOL,
    GEN,
    PROMPT,
    _chip_smoke_module,
    check_serve_flow,
    jax_tree,
    tokens,
)

ARCH = "deepseek-v3-671b"
SLICE = ("deepseek-v3-671b", "llama-3.2-vision-90b", "hubert-xlarge")
# a routing decision whose k-th and (k+1)-th probabilities are this close is
# a near tie that bf16 rounding may decide either way (the gap the rounding
# of the hidden state moves: up to ~0.005 at this size)
NEAR_TIE = 0.02


def _routes(monkeypatch, cfg, jcfg, tree, toks, dtype):
    """Both sides' forwards over ``toks`` in ``dtype``, with each MoE
    layer's top-k experts per token (sorted), the port's router
    probabilities beside them: (got, want, port routes, reference routes,
    port probabilities), one entry per MoE layer in the routes."""
    seen_ref, seen_port, probs = [], [], []
    real_ref, real_route = jax_moe._moe_apply_dense_dispatch, moe._route

    def spy_ref(p, x, **kw):
        jax.debug.callback(lambda a: seen_ref.append(np.asarray(a)),
                           jax.lax.top_k(jax.nn.softmax(x.astype(jnp.float32) @ p["router"]["w"]),
                                         kw["top_k"])[1].reshape(-1, kw["top_k"]), ordered=True)
        return real_ref(p, x, **kw)

    def spy_route(router, xf, top_k):
        out = real_route(router, xf, top_k)
        probs.append(out[0].numpy())
        seen_port.append(out[2].numpy())
        return out

    monkeypatch.setattr(jax_moe, "_moe_apply_dense_dispatch", spy_ref)
    monkeypatch.setattr(moe, "_route", spy_route)
    want, _ = jax_model.forward(jcfg, jax.tree.map(jnp.asarray, tree),
                                {"tokens": jnp.asarray(toks)}, compute_dtype=getattr(jnp, dtype))
    with torch.inference_mode():
        got, _ = model.forward(cfg, params_from_jax(cfg, tree, device="cpu"),
                               {"tokens": torch.from_numpy(toks)},
                               compute_dtype=getattr(torch, dtype))
    assert len(seen_ref) == len(seen_port) == sum(b.ffn == "moe" for b in cfg.block_list())
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            [np.sort(r, -1) for r in seen_port], [np.sort(r, -1) for r in seen_ref], probs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, monkeypatch):
    """The logits at the serve tests' tolerances.  Routing is discrete: in
    bf16 the two frameworks round the hidden state at other places, and a
    token whose k-th and (k+1)-th router probabilities are within
    ``NEAR_TIE`` can pick another expert on each side, which changes its
    logits and, through attention, those of the later positions of its
    row.  In f32 every choice must agree; in bf16 each disagreement must be
    such a near tie, and the positions it cannot reach agree at 2e-2."""
    cfg, jcfg = get_smoke_config(ARCH), jax_get_smoke_config(ARCH)
    toks = tokens(cfg, 1, 20)
    got, want, ours, theirs, probs = _routes(monkeypatch, cfg, jcfg, jax_tree(jcfg, 0), toks,
                                             dtype)
    k = cfg.moe.top_k
    reached = np.zeros(toks.shape, bool)
    for mine, ref, p in zip(ours, theirs, probs):
        for flat in np.flatnonzero((mine != ref).any(-1)):
            assert dtype == "bfloat16", f"an f32 routing differs at token {flat}"
            ranked = np.sort(p[flat])[::-1]
            assert ranked[k - 1] - ranked[k] < NEAR_TIE, (flat, ranked[:k + 1])
            row, pos = divmod(int(flat), toks.shape[1])
            reached[row, pos:] = True
    assert reached.mean() <= 0.5
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got[~reached], want[~reached], **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_matches_jax_serve_flow(dtype):
    """Each decode step's logits against the reference's cached forward; in
    f32 the greedy tokens too, and ``serve()``'s own."""
    cfg = get_smoke_config(ARCH)
    check_serve_flow(cfg, jax_get_smoke_config(ARCH), jax_tree(jax_get_smoke_config(ARCH), 2),
                     tokens(cfg, 3, PROMPT + GEN), dtype)


def test_serve_on_cpu_decodes_in_bf16():
    """``serve()`` as the CLI calls it: f32 prefill, one cast, bf16 decode;
    the MLA caches carry the latents of every position."""
    cfg = get_smoke_config(ARCH)
    params = serve_mod.init_model(cfg, serve_mod.TrainConfig(), seed=0, device="cpu")
    prompts = serve_mod.make_prompts(cfg, 2, 7, seed=0)
    res = serve_mod.serve(cfg, params, prompts, 4, device="cpu")
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == np.int32
    assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()
    assert model.param_dtypes(params) == {torch.bfloat16}
    cache = model.init_cache(cfg, 2, 11, device="cpu")
    assert [sorted(c) for c in cache["layers"]] == [["ckv", "kr", "len"]] * cfg.n_layers
    assert cache["layers"][0]["ckv"].shape == (2, 11, cfg.mla.kv_lora_rank)
    assert cache["layers"][0]["kr"].shape == (2, 11, cfg.mla.qk_rope_head_dim)


def test_cast_params_frees_each_leaf_before_the_next(monkeypatch):
    """``cast_params_`` casts leaf by leaf and frees each f32 leaf as soon as
    its cast copy replaces it, so the card holds at most one leaf twice: at
    full width one expert leaf of deepseek-v3-671b is 15 GB in f32, and
    holding a block's three until the block is done put serving's peak at
    79.49 GB of the card's 80."""
    cfg = get_smoke_config(ARCH)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    originals, alive = [], []
    real_to = torch.Tensor.to

    def spy(self, *args, **kwargs):
        alive.append(sum(ref() is not None for ref in originals))
        originals.append(weakref.ref(self))
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", spy)
    model.cast_params_(params, torch.bfloat16)
    monkeypatch.undo()
    assert len(alive) > 20 and alive == [0] * len(alive)
    assert model.param_dtypes(params) == {torch.bfloat16}


@pytest.mark.parametrize("arch", SLICE)
def test_params_from_jax_carries_every_leaf(arch):
    """Every leaf of the smoke model's JAX tree lands in the port's tree,
    bit for bit, the scanned ones unstacked; nothing is left over."""
    cfg, jcfg = get_smoke_config(arch), jax_get_smoke_config(arch)
    tree = jax_tree(jcfg, 4)
    params = params_from_jax(cfg, tree, device="cpu")
    got = dict(leaf_paths(params))
    assert sum(t.numel() for t in got.values()) == jax_model.param_count(jcfg)
    assert ("embed_proj/w" in got) == (cfg.frontend != "token")
    assert "lm_head/w" in got and ("embed/table" in got) == (cfg.frontend == "token")
    prefix, n_scan, pattern, _ = cfg.scan_partition()
    for j, _ in enumerate(pattern):
        for i in range(n_scan):
            layer = len(prefix) + i * len(pattern) + j
            for key, leaf in leaf_paths(tree["scan"][j]):
                np.testing.assert_array_equal(got[f"layers/{layer}/{key}"].numpy(), leaf[i])


@pytest.mark.parametrize("arch", SLICE)
def test_param_count_matches_jax(arch):
    """The full configs, counted on the meta device."""
    n = model.param_count(get_config(arch))
    assert n == jax_model.param_count(jax_get_config(arch))
    assert n == {"deepseek-v3-671b": 671_026_404_352, "llama-3.2-vision-90b": 87_666_794_496,
                 "hubert-xlarge": 1_260_698_880}[arch]


def test_registries_hold_the_same_architectures():
    assert len(ARCHS) == 10 and sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("fault", [False, True])
def test_chip_smoke_decode_gate_catches_zeroed_mla_cache(fault):
    """chip_smoke.py's stepwise-decode check at the smoke size: it passes on
    the port and fails when every decode step is fed a zeroed MLA cache.
    The routers are drawn at N(0, 0.5), so routing is decisive."""
    chip_smoke = _chip_smoke_module()
    cfg = get_smoke_config(ARCH)
    seq = torch.from_numpy(tokens(cfg, 11, 28))
    names = chip_smoke.MLA_FAULTS["a zeroed MLA cache (ckv, kr)"] if fault else ()
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(cfg, gen, "cpu")
    for layer, blk in zip(params["layers"], cfg.block_list()):
        if blk.ffn == "moe":
            layer["ffn"]["router"]["w"].normal_(0, 0.5, generator=gen)
    full = chip_smoke._logits(cfg, params, seq, torch.float32)[0]
    limit = chip_smoke.decode_limit(cfg, params, seq, torch.float32, full, 24)
    rows = chip_smoke.decode_vs_full(cfg, params, seq, torch.float32, full, prompt=24, zero=names)
    over = [label for label, err in rows if err > limit]
    if fault:
        assert over and all("decode" in label for label in over), rows
    else:
        assert not over, rows
