"""Model assembly: a stack of residual blocks described by
``cfg.block_list()``, run as a plain loop.

Counterpart of ``repro.models.model``.  Parameters are nested dicts of
tensors; where the JAX package stacks the scanned layers, the port keeps one
entry per layer under ``params["layers"]`` (``convert.params_from_jax``
unstacks a JAX tree).

Public API:
    init_params(cfg, generator, device)               -> params
    forward(cfg, params, batch, cache=None, ...)      -> (logits, new_cache)
    init_cache(cfg, batch, dtype, device)             -> decode cache
    cast_params_(params, dtype)                       -> params, cast in place
    param_dtypes(params)                              -> dtypes cast_params_ sets
    param_count(cfg)                                  -> int

This slice ports the rwkv6 path; any other mixer or ffn raises
``NotImplementedError`` naming the slice that will port it.
"""

from __future__ import annotations

import torch

from ..configs.base import Block, ModelConfig
from ..device import resolve_device
from . import rwkv6 as rwkv_mod
from .layers import (
    Params,
    dense_apply,
    dense_init,
    embed_apply,
    embed_init,
    rmsnorm_apply,
    rmsnorm_init,
    unembed_apply,
)

__all__ = [
    "init_params", "forward", "init_cache", "cast_params_", "param_dtypes",
    "param_count",
]

_LATER_SLICE = {
    "rglru": "recurrentgemma-9b serving",
    "attn": "dense decoders' serving path",
    "attn_local": "recurrentgemma-9b serving",
    "attn_cross": "MoE, MLA and cross-attention",
    "mla": "MoE, MLA and cross-attention",
    "dense": "dense decoders' serving path",
    "moe": "MoE, MLA and cross-attention",
}

# leaves the model reads in f32 whatever the compute dtype
# (rwkv6.py: w_base feeds the f32 decay, ln_g/ln_b the f32 group norm)
F32_LEAVES = frozenset({"w_base", "ln_g", "ln_b"})


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.frontend != "token":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is not ported yet (MoE, MLA and "
            "cross-attention slice)"
        )
    for blk in cfg.block_list():
        for part, known in ((blk.mixer, ("rwkv",)), (blk.ffn, ("rwkv_cmix", "none"))):
            if part not in known:
                slice_ = _LATER_SLICE.get(part, "a later")
                raise NotImplementedError(
                    f"{part!r} blocks are not ported yet; they come with the "
                    f"{slice_} slice of the port"
                )


def _block_init(gen, cfg: ModelConfig, block: Block, device) -> Params:
    d = cfg.d_model
    p: Params = {
        "norm1": rmsnorm_init(d, device),
        "mixer": rwkv_mod.rwkv_tmix_init(gen, d, device),
    }
    if block.ffn == "rwkv_cmix":
        p["norm2"] = rmsnorm_init(d, device)
        p["ffn"] = rwkv_mod.rwkv_cmix_init(gen, d, cfg.d_ff, device)
    return p


def _block_apply(cfg: ModelConfig, block: Block, p: Params, x: torch.Tensor,
                 cache: Params | None):
    h = rmsnorm_apply(p["norm1"], x, eps=cfg.norm_eps)
    y, new_t = rwkv_mod.rwkv_tmix_apply(
        p["mixer"], h, head_dim=cfg.rwkv_head_dim,
        state=cache["tmix"] if cache is not None else None,
    )
    x = x + y
    new_cache = None if cache is None else dict(cache, tmix=new_t)
    if block.ffn == "none":
        return x, new_cache
    h2 = rmsnorm_apply(p["norm2"], x, eps=cfg.norm_eps)
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
    (``None`` on the meta device, where only shapes are made)."""
    _check_ported(cfg)
    device = resolve_device(device)
    if device.type != "meta" and (generator is None or generator.device.type != device.type):
        raise ValueError(f"init_params on {device} needs a torch.Generator on that device")
    params: Params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, device),
        "layers": [_block_init(generator, cfg, b, device) for b in cfg.block_list()],
        "final_norm": rmsnorm_init(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, device,
                                       scale=0.02)
    return params


def init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None) -> Params:
    """Decode cache, one entry per layer.  rwkv state is O(1) in length, so
    unlike the JAX ``init_cache`` it takes no ``max_len``."""
    _check_ported(cfg)
    device = resolve_device(device)
    return {
        "layers": [
            rwkv_mod.rwkv_init_state(batch, cfg.d_model, cfg.rwkv_head_dim,
                                     dtype=dtype, device=device)
            for _ in cfg.block_list()
        ]
    }


def forward(
    cfg: ModelConfig,
    params: Params,
    batch: dict[str, torch.Tensor],
    *,
    cache: Params | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, Params | None]:
    """``batch["tokens"]`` is (B, S).  Returns (logits (B, S, V) in
    ``compute_dtype``, new_cache or None)."""
    _check_ported(cfg)
    x = embed_apply(params["embed"], batch["tokens"], compute_dtype)
    new_layers = []
    for i, blk in enumerate(cfg.block_list()):
        c = cache["layers"][i] if cache is not None else None
        x, nc = _block_apply(cfg, blk, params["layers"][i], x, c)
        new_layers.append(nc)
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    if "lm_head" in params:
        logits = dense_apply(params["lm_head"], x)
    else:
        logits = unembed_apply(params["embed"], x)
    return logits, ({"layers": new_layers} if cache is not None else None)


def cast_params_(params: Params, dtype: torch.dtype) -> Params:
    """Cast every leaf to ``dtype`` in place, leaf by leaf, except those the
    model reads in f32.  ``forward`` casts weights to the compute dtype on
    every call (as the JAX ``dense_apply`` does); casting once gives the same
    numbers and leaves one serving copy on the card, never two."""
    items = params.items() if isinstance(params, dict) else enumerate(params)
    for key, leaf in list(items):
        if isinstance(leaf, (dict, list)):
            cast_params_(leaf, dtype)
        elif key not in F32_LEAVES:
            params[key] = leaf.to(dtype)
    return params


def param_dtypes(params: Params) -> set[torch.dtype]:
    """The dtypes of the leaves ``cast_params_`` casts (all but the f32 ones)."""
    items = params.items() if isinstance(params, dict) else enumerate(params)
    out: set[torch.dtype] = set()
    for key, leaf in items:
        if isinstance(leaf, (dict, list)):
            out |= param_dtypes(leaf)
        elif key not in F32_LEAVES:
            out.add(leaf.dtype)
    return out


def param_count(cfg: ModelConfig) -> int:
    def count(tree) -> int:
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel()

    return count(init_params(cfg, None, "meta"))
