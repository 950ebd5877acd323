"""Multi-head Latent Attention (DeepSeek-V2/V3): the counterpart of
``repro.models.mla``.

Queries and keys/values come from low-rank latent compressions:

    c_q  = x W_dq            (q_lora_rank)
    q    = RMSNorm(c_q) W_uq          -> per-head [nope | rope] parts
    c_kv = x W_dkv           (kv_lora_rank)    <- the cache (with k_rope)
    k    = RMSNorm(c_kv) W_uk + shared k_rope
    v    = RMSNorm(c_kv) W_uv

Decode caches only (c_kv, k_rope), kv_lora_rank + rope_dim values a token.
Attention is softmax over qk_head_dim with a separate v_head_dim.  The
cached path re-projects k_nope and v from the whole cache on every call, as
the reference computes it (folding ``wuk`` into the query is not a port).
"""

from __future__ import annotations

import math

import torch

from ..configs.base import MLAConfig
from ..dist import context as dist_context
from .layers import (
    Params,
    _largest_chunk,
    apply_rope,
    dense_apply,
    dense_attention,
    dense_init,
    flash_attention,
    rmsnorm_apply,
    rmsnorm_init,
    seq_split_attention,
    split_offset,
    write_positions,
)

__all__ = ["mla_init", "mla_apply", "mla_init_cache"]

# above this many tokens the uncached path attends blockwise (mla.py:118)
_FLASH_ABOVE = 2048


def mla_init(gen, d_model: int, n_heads: int, mla: MLAConfig, device: torch.device) -> Params:
    qk, rope = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    return {
        "wdq": dense_init(gen, d_model, mla.q_lora_rank, device),
        "q_norm": rmsnorm_init(mla.q_lora_rank, device),
        "wuq": dense_init(gen, mla.q_lora_rank, n_heads * (qk + rope), device),
        "wdkv": dense_init(gen, d_model, mla.kv_lora_rank, device),
        "kv_norm": rmsnorm_init(mla.kv_lora_rank, device),
        "wuk": dense_init(gen, mla.kv_lora_rank, n_heads * qk, device),
        "wuv": dense_init(gen, mla.kv_lora_rank, n_heads * mla.v_head_dim, device),
        "wkr": dense_init(gen, d_model, rope, device),
        "wo": dense_init(gen, n_heads * mla.v_head_dim, d_model, device,
                         scale=0.02 / math.sqrt(2)),
    }


def mla_init_cache(b: int, max_len: int, mla: MLAConfig, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | None = None) -> Params:
    """The latent cache; ``len`` is a Python int, as in ``gqa_init_cache``."""
    return {
        "ckv": torch.zeros((b, max_len, mla.kv_lora_rank), dtype=dtype, device=device),
        "kr": torch.zeros((b, max_len, mla.qk_rope_head_dim), dtype=dtype, device=device),
        "len": 0,
    }


def _project_kv(p: Params, ckv: torch.Tensor, n_heads: int, mla: MLAConfig):
    ckv_n = rmsnorm_apply(p["kv_norm"], ckv)
    b, s, _ = ckv.shape
    k_nope = dense_apply(p["wuk"], ckv_n).reshape(b, s, n_heads, mla.qk_nope_head_dim)
    v = dense_apply(p["wuv"], ckv_n).reshape(b, s, n_heads, mla.v_head_dim)
    return k_nope, v


def _keys(k_nope: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """[k_nope | k_rope], the one rope key (B, S, rope_d) broadcast over the
    heads."""
    return torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], -1)], dim=-1)


def mla_apply(
    p: Params,
    x: torch.Tensor,                     # (B, S, d)
    *,
    n_heads: int,
    mla: MLAConfig,
    causal: bool = True,
    rope_theta: float = 10_000.0,
    cache: Params | None = None,         # {"ckv", "kr", "len"} for decode
) -> tuple[torch.Tensor, Params | None]:
    """With a cache, the new latents are written into a copy of it in the
    cache's dtype (the caller's cache is left as it was), k_nope and v are
    projected from the whole cache in ``x.dtype``, and attention is dense
    over the valid positions.  Without one, attention is blockwise above
    2048 tokens (``flash_attention``, chunks of the largest divisor up to
    1024), dense otherwise.  Plain tensor code, whatever the distribution
    context: the reference computes MLA outside any ``model``-parallel
    region; but a cache split along the sequence over ``model``
    (``seq_shards``) holds a rank's positions only, from which it projects
    k_nope and v, and the ranks' partial softmax sums are merged
    (``layers.seq_split_attention``)."""
    b, s, _ = x.shape
    qk, rope_d = mla.qk_nope_head_dim, mla.qk_rope_head_dim

    cq = rmsnorm_apply(p["q_norm"], dense_apply(p["wdq"], x))
    q = dense_apply(p["wuq"], cq).reshape(b, s, n_heads, qk + rope_d)
    q_nope, q_rope = q[..., :qk], q[..., qk:]

    ckv_new = dense_apply(p["wdkv"], x)                       # (B, S, r_kv)
    kr_new = dense_apply(p["wkr"], x)                         # (B, S, rope_d)

    clen = 0 if cache is None else cache["len"]
    pos = clen + torch.arange(s, device=x.device)
    q_full = torch.cat([q_nope, apply_rope(q_rope, pos, rope_theta)], dim=-1)
    kr_rot = apply_rope(kr_new[:, :, None, :], pos, rope_theta)[:, :, 0]

    new_cache = None
    if cache is not None:
        ckv, kr = cache["ckv"].clone(), cache["kr"].clone()
        shards = cache.get("seq_shards", 1)
        if clen + s > ckv.shape[1] * shards:
            raise ValueError(f"the cache holds {ckv.shape[1] * shards} positions; "
                             f"{clen} + {s} do not fit")
        lo = split_offset(cache, dist_context.current(), ckv.shape[1])
        write_positions(ckv, ckv_new, clen, lo)
        write_positions(kr, kr_rot, clen, lo)
        new_cache = {"ckv": ckv, "kr": kr, "len": clen + s}
        k_nope, v = _project_kv(p, ckv.to(x.dtype), n_heads, mla)
        keys = _keys(k_nope, kr.to(x.dtype))
        if shards > 1:
            new_cache["seq_shards"] = shards
            out = seq_split_attention(q_full, keys, v, dist_context.current(), lo=lo,
                                      q_offset=clen, kv_len=clen + s, causal=causal)
        else:
            out = dense_attention(q_full, keys, v, causal=causal, q_offset=clen,
                                  kv_len=clen + s)
    else:
        k_nope, v = _project_kv(p, ckv_new, n_heads, mla)
        k = _keys(k_nope, kr_rot)
        if s > _FLASH_ABOVE:
            chunk = _largest_chunk(s, 1024)
            out = flash_attention(q_full, k, v, causal=causal, q_chunk=chunk, kv_chunk=chunk)
        else:
            out = dense_attention(q_full, k, v, causal=causal)

    y = dense_apply(p["wo"], out.reshape(b, s, n_heads * mla.v_head_dim))
    return y, new_cache
