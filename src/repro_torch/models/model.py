"""Model assembly: a stack of residual blocks described by
``cfg.block_list()``, run as a plain loop.

Counterpart of ``repro.models.model``.  Parameters are nested dicts of
tensors; where the JAX package stacks the scanned layers, the port keeps one
entry per layer under ``params["layers"]`` (``convert.params_from_jax``
unstacks a JAX tree).

Public API:
    init_params(cfg, generator, device)               -> params
    forward(cfg, params, batch, cache=None, ...)      -> (logits, new_cache)
    init_cache(cfg, batch, max_len, dtype, device)    -> decode cache
    cast_params_(params, dtype)                       -> params, cast in place
    param_dtypes(params)                              -> dtypes cast_params_ sets
    param_count(cfg)                                  -> int
    region_leaves(cfg)                                -> keys of the leaves
                                                         split over ``model``

Every block kind of the reference runs: the mixers ``attn``,
``attn_local``, ``attn_cross`` (over ``batch["img"]``), ``mla``, ``rwkv``
and ``rglru``, the ffns ``dense``, ``moe``, ``rwkv_cmix`` and ``none``; an
unknown one raises ``ValueError``.  A frontend other than tokens reads
``batch["embeds"]`` through one projection, ``embed_proj``, as the
reference's stub frontend does.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.utils.checkpoint

from ..configs.base import Block, ModelConfig
from ..device import resolve_device
from ..tree import leaf_paths
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .layers import (
    Params,
    dense_apply,
    dense_init,
    embed_apply,
    embed_init,
    gqa_apply,
    gqa_init,
    gqa_init_cache,
    rmsnorm_apply,
    rmsnorm_init,
    swiglu_apply,
    swiglu_init,
    unembed_apply,
)

__all__ = [
    "init_params", "forward", "init_cache", "cast_params_", "param_dtypes",
    "param_count", "active_param_count", "region_leaves",
]

# sub-trees of a layer that the model reads in f32 whatever the compute
# dtype, so cast_params_ leaves them f32:
# * rwkv6.py: w_base feeds the f32 decay, ln_g/ln_b the f32 group norm;
# * rglru.py: lam feeds the f32 decay; wa/wx (weights and biases) gate the
#   conv output, which an f32 conv window keeps f32 under bf16 compute, so
#   the JAX package reads them in f32 when it decodes on an f32 cache;
# * moe.py: the router, which the JAX package reads as f32 weights whatever
#   the compute dtype; rounded to bf16 it would flip near-tie expert choices.
F32_SUBTREES = frozenset({
    ("mixer", "w_base"), ("mixer", "ln_g"), ("mixer", "ln_b"),
    ("mixer", "lam"), ("mixer", "wa"), ("mixer", "wx"),
    ("ffn", "router"),
})


def _block_init(gen, cfg: ModelConfig, block: Block, device) -> Params:
    d = cfg.d_model
    p: Params = {"norm1": rmsnorm_init(d, device)}
    if block.mixer == "rwkv":
        p["mixer"] = rwkv_mod.rwkv_tmix_init(gen, d, device)
    elif block.mixer == "rglru":
        p["mixer"] = rglru_mod.rglru_block_init(gen, d, cfg.rglru_lru_width or d, device,
                                                cfg.rglru_conv_width)
    elif block.mixer in ("attn", "attn_local", "attn_cross"):
        p["mixer"] = gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                              device, bias=cfg.qkv_bias)
    elif block.mixer == "mla":
        p["mixer"] = mla_mod.mla_init(gen, d, cfg.n_heads, cfg.mla, device)
    else:
        raise ValueError(f"unknown mixer {block.mixer!r}")
    if block.ffn != "none":
        p["norm2"] = rmsnorm_init(d, device)
    if block.ffn == "rwkv_cmix":
        p["ffn"] = rwkv_mod.rwkv_cmix_init(gen, d, cfg.d_ff, device)
    elif block.ffn == "dense":
        p["ffn"] = swiglu_init(gen, d, cfg.d_ff, device)
    elif block.ffn == "moe":
        p["ffn"] = moe_mod.moe_init(gen, d, cfg.moe.n_experts, cfg.moe.d_expert, device,
                                    n_shared=cfg.moe.n_shared, d_shared=cfg.moe.d_shared)
    elif block.ffn != "none":
        raise ValueError(f"unknown ffn {block.ffn!r}")
    return p


def _block_cache(cfg: ModelConfig, block: Block, b: int, max_len: int | None,
                 dtype: torch.dtype, device) -> Params:
    if block.mixer == "rwkv":
        return rwkv_mod.rwkv_init_state(b, cfg.d_model, cfg.rwkv_head_dim,
                                        dtype=dtype, device=device)
    if block.mixer == "rglru":
        return rglru_mod.rglru_init_state(b, cfg.rglru_lru_width or cfg.d_model,
                                          cfg.rglru_conv_width, dtype=dtype, device=device)
    if block.mixer == "attn_cross":
        return {"len": 0}            # the context comes with every call; nothing cached
    if block.mixer not in ("attn", "attn_local", "mla"):
        raise ValueError(f"unknown mixer {block.mixer!r}")
    if max_len is None:
        raise ValueError(f"{cfg.name} has attention blocks: init_cache needs max_len")
    if block.mixer == "mla":
        return mla_mod.mla_init_cache(b, max_len, cfg.mla, dtype=dtype, device=device)
    # a global attention cache is linear; a local one a ring where it spans the window
    window = min(cfg.local_window, max_len) if block.mixer == "attn_local" else 0
    return gqa_init_cache(b, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
                          window=window, dtype=dtype, device=device)


def _block_apply(cfg: ModelConfig, block: Block, p: Params, x: torch.Tensor,
                 cache: Params | None, img: torch.Tensor | None = None):
    h = rmsnorm_apply(p["norm1"], x, eps=cfg.norm_eps)
    if block.mixer == "rwkv":
        y, new_t = rwkv_mod.rwkv_tmix_apply(
            p["mixer"], h, head_dim=cfg.rwkv_head_dim,
            state=cache["tmix"] if cache is not None else None,
        )
        new_cache = None if cache is None else dict(cache, tmix=new_t)
    elif block.mixer == "rglru":
        y, new_cache = rglru_mod.rglru_block_apply(p["mixer"], h, state=cache)
    elif block.mixer == "attn_cross":
        if img is None:
            raise ValueError(f"{cfg.name}: a cross-attention block needs the image context, "
                             "batch['img']")
        y, _ = gqa_apply(p["mixer"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                         head_dim=cfg.resolved_head_dim, causal=False,
                         rope_theta=cfg.rope_theta, kv_source=img)
        new_cache = None if cache is None else {"len": cache["len"] + x.shape[1]}
    elif block.mixer == "mla":
        y, new_cache = mla_mod.mla_apply(p["mixer"], h, n_heads=cfg.n_heads, mla=cfg.mla,
                                         causal=cfg.causal, rope_theta=cfg.rope_theta,
                                         cache=cache)
    else:                                                   # attn, attn_local
        y, new_cache = gqa_apply(
            p["mixer"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, causal=cfg.causal,
            window=cfg.local_window if block.mixer == "attn_local" else 0,
            rope_theta=cfg.rope_theta, cache=cache,
        )
    x = x + y
    if block.ffn == "none":
        return x, new_cache
    h2 = rmsnorm_apply(p["norm2"], x, eps=cfg.norm_eps)
    if block.ffn == "dense":
        return x + swiglu_apply(p["ffn"], h2), new_cache
    if block.ffn == "moe":
        return x + moe_mod.moe_apply(p["ffn"], h2, top_k=cfg.moe.top_k,
                                     capacity_factor=cfg.moe.capacity_factor), new_cache
    # the cmix shift is carried only behind an rwkv mixer (model.py:188)
    carry = cache is not None and block.mixer == "rwkv"
    y2, new_c = rwkv_mod.rwkv_cmix_apply(
        p["ffn"], h2, state=cache["cmix"] if carry else None
    )
    if carry:
        new_cache["cmix"] = new_c
    return x + y2, new_cache


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                device: str | torch.device | None = None) -> Params:
    """float32 parameters drawn from ``generator``, which lives on ``device``
    (``None`` on the meta device, where only shapes are made).  A model
    whose frontend is not tokens has ``embed_proj`` (d_model x d_model) in
    place of the table, and its own ``lm_head``."""
    device = resolve_device(device)
    if device.type != "meta" and (generator is None or generator.device.type != device.type):
        raise ValueError(f"init_params on {device} needs a torch.Generator on that device")
    params: Params = {}
    if cfg.frontend == "token":
        params["embed"] = embed_init(generator, cfg.vocab_size, cfg.d_model, device)
    else:
        params["embed_proj"] = dense_init(generator, cfg.d_model, cfg.d_model, device)
    params["layers"] = [_block_init(generator, cfg, b, device) for b in cfg.block_list()]
    params["final_norm"] = rmsnorm_init(cfg.d_model, device)
    if not cfg.tie_embeddings or cfg.frontend != "token":
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, device,
                                       scale=0.02)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int | None = None,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> Params:
    """Decode cache, one entry per layer.  ``max_len`` sizes the attention
    caches: a global-attention cache holds ``max_len`` positions, a
    local-attention one ``min(local_window, max_len)``, a ring when that is
    the window.  Recurrent state is O(1) in
    length, so a model without attention blocks may leave it out.  An MLA
    block caches its latents (``mla.mla_init_cache``); a cross-attention
    block only its length."""
    device = resolve_device(device)
    return {"layers": [_block_cache(cfg, b, batch, max_len, dtype, device)
                       for b in cfg.block_list()]}


def forward(
    cfg: ModelConfig,
    params: Params,
    batch: dict[str, torch.Tensor],
    *,
    cache: Params | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    gather: Callable[[str, Params], Params] | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """``batch["tokens"]`` is (B, S), or ``batch["embeds"]`` (B, S, d) for
    a model whose frontend is not tokens; ``batch["img"]`` (B, N_img, d) is
    the context of the cross-attention blocks, given with every call, the
    decode steps' too.  ``embeds`` and ``img`` are cast to
    ``compute_dtype``.  Returns (logits (B, S, V) in ``compute_dtype``,
    new_cache or None).

    With ``cfg.remat``, grad enabled and no cache (a training forward), each
    block runs under ``torch.utils.checkpoint``: its activations are freed
    and recomputed in the backward, the per-block counterpart of the JAX
    package's ``jax.checkpoint`` over each scanned superblock.  The values
    are the same either way.

    ``gather(key, subtree)`` gives the parameters a part of the model uses
    (``embed`` or ``embed_proj``, ``layers/{i}``, ``final_norm``, ``lm_head``) from what
    ``params`` holds there, just before that part runs, and inside the
    checkpointed block, so that remat's recompute gathers a block's
    parameters again (``dist.inpod.gather_tree``: a rank holds blocks of
    the leaves).  By default ``params`` holds the whole leaves."""
    if gather is None:
        def gather(key: str, sub: Params) -> Params:
            return sub
    if cfg.frontend == "token":
        x = embed_apply(gather("embed", params["embed"]), batch["tokens"], compute_dtype)
    else:
        x = dense_apply(gather("embed_proj", params["embed_proj"]),
                        batch["embeds"].to(compute_dtype))
    img = batch.get("img")
    if img is not None:
        img = img.to(compute_dtype)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    new_layers = []
    for i, blk in enumerate(cfg.block_list()):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda p, xx, blk=blk, i=i: _block_apply(cfg, blk, gather(f"layers/{i}", p),
                                                         xx, None, img)[0],
                params["layers"][i], x, use_reentrant=False,
            )
            new_layers.append(None)
            continue
        c = cache["layers"][i] if cache is not None else None
        x, nc = _block_apply(cfg, blk, gather(f"layers/{i}", params["layers"][i]), x, c, img)
        new_layers.append(nc)
    x = rmsnorm_apply(gather("final_norm", params["final_norm"]), x, eps=cfg.norm_eps)
    if "lm_head" in params:
        logits = dense_apply(gather("lm_head", params["lm_head"]), x)
    else:
        logits = unembed_apply(gather("embed", params["embed"]), x)
    return logits, ({"layers": new_layers} if cache is not None else None)


def _leaves(tree, path: tuple = ()):
    """``(container, key, path)`` of every tensor leaf.  The generator holds
    no leaf while it waits, so a caller that replaces ``container[key]``
    frees the old leaf at once."""
    for key in list(tree) if isinstance(tree, dict) else range(len(tree)):
        if isinstance(tree[key], (dict, list)):
            yield from _leaves(tree[key], path + (key,))
        else:
            yield tree, key, path + (key,)


def _kept_f32(path: tuple) -> bool:
    """Whether the leaf at ``path`` lies in one of ``F32_SUBTREES`` of a
    layer (``("layers", i, "mixer", "wa", "w")`` does)."""
    inner = path[2:] if path[:1] == ("layers",) else ()
    return any(inner[:len(sub)] == sub for sub in F32_SUBTREES)


def cast_params_(params: Params, dtype: torch.dtype) -> Params:
    """Cast every leaf to ``dtype`` in place, leaf by leaf, except those the
    model reads in f32 (``F32_SUBTREES``).  ``forward`` casts weights to the
    compute dtype on every call (as the JAX ``dense_apply`` does); casting
    once gives the same numbers and leaves one serving copy on the card,
    never two."""
    for tree, key, path in _leaves(params):
        if not _kept_f32(path):
            tree[key] = tree[key].to(dtype)
    return params


def param_dtypes(params: Params) -> set[torch.dtype]:
    """The dtypes of the leaves ``cast_params_`` casts (all but the f32 ones)."""
    return {tree[key].dtype for tree, key, path in _leaves(params) if not _kept_f32(path)}


def param_count(cfg: ModelConfig) -> int:
    def count(tree) -> int:
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()

    return count(init_params(cfg, None, "meta"))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token uses: an MoE block's ``n_experts - top_k``
    unrouted experts left out (its shared experts are used)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    moe_blocks = sum(1 for b in cfg.block_list() if b.ffn == "moe")
    per_expert = 3 * cfg.d_model * cfg.moe.d_expert
    return total - moe_blocks * (cfg.moe.n_experts - cfg.moe.top_k) * per_expert


def region_leaves(cfg: ModelConfig) -> frozenset[str]:
    """The keys (``tree.leaf_paths``) of the leaves that ``forward`` reads
    inside a ``model``-parallel region under a distribution context with
    ``model`` above 1 (``dist.context``): every self- and cross-attention
    block's projections and every MoE block's router and experts, not its
    shared experts (MLA runs outside any such region, as in the
    reference).  Each ``model`` rank's gradient of such a leaf is a part
    of the leaf's."""
    blocks = cfg.block_list()
    keys = set()
    for key, _ in leaf_paths(init_params(cfg, None, "meta")):
        parts = key.split("/")
        if parts[0] != "layers":
            continue
        blk = blocks[int(parts[1])]
        if ((parts[2] == "mixer" and blk.mixer in ("attn", "attn_local", "attn_cross"))
                or (parts[2] == "ffn" and blk.ffn == "moe" and parts[3] != "shared")):
            keys.add(key)
    return frozenset(keys)
