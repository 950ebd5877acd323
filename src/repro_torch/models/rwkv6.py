"""RWKV-6 "Finch" time-mix and channel-mix (arXiv:2404.05892).

Counterpart of ``repro.models.rwkv6``.  Time-mix per head (head dim N,
state S in R^{NxN}):

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with data-dependent decay ``w_t = exp(-exp(wb + lora_w(x)))`` and
data-dependent token-shift interpolation.  WKV always goes through
``kernels.rwkv6_wkv.ops.wkv6``: the CUDA kernel on the card, the plain
recurrence on the CPU.  The casts follow the JAX module one by one: decay
and ``u`` are rounded to ``x.dtype``, the recurrence runs in f32, its output
is rounded to ``x.dtype`` before the f32 group norm.

Decode is O(1): the f32 state (B, H, N, N) plus one token-shift vector,
stored in the cache's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.rwkv6_wkv.ops import wkv6
from .layers import Params, dense_apply, dense_init, normal

__all__ = [
    "rwkv_tmix_init",
    "rwkv_tmix_apply",
    "rwkv_cmix_init",
    "rwkv_cmix_apply",
    "rwkv_init_state",
]


def _lora_init(gen, d: int, r: int, out: int, device) -> Params:
    return {"a": normal(gen, (d, r), 0.01, device), "b": normal(gen, (r, out), 0.01, device)}


def _lora_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p["a"].to(x.dtype)) @ p["b"].to(x.dtype)


def _token_shift(x: torch.Tensor, state: Params | None) -> torch.Tensor:
    """x shifted one step back in time; position 0 sees the cached shift."""
    if state is not None:
        first = state["shift"][:, None].to(x.dtype)
    else:
        first = torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _last(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The new token shift: x's last position, copied (a view would keep all
    of x alive in the cache) into the cache's dtype."""
    return x[:, -1].to(like.dtype, copy=True)


def rwkv_tmix_init(gen, d_model: int, device) -> Params:
    return {
        "mu": torch.full((5, d_model), 0.5, device=device),   # token-shift bases (r,k,v,w,g)
        "mu_lora": _lora_init(gen, d_model, 32, 5 * d_model, device),
        "wr": dense_init(gen, d_model, d_model, device),
        "wk": dense_init(gen, d_model, d_model, device),
        "wv": dense_init(gen, d_model, d_model, device),
        "wg": dense_init(gen, d_model, d_model, device),
        "wo": dense_init(gen, d_model, d_model, device, scale=0.02 / math.sqrt(2)),
        "w_base": torch.full((d_model,), -6.0, device=device),  # slow decay at init
        "w_lora": _lora_init(gen, d_model, 64, d_model, device),
        "u": normal(gen, (d_model,), 0.1, device),
        "ln_g": torch.ones(d_model, device=device),             # per-head group norm gain
        "ln_b": torch.zeros(d_model, device=device),
    }


def rwkv_tmix_apply(
    p: Params,
    x: torch.Tensor,                # (B, T, d)
    *,
    head_dim: int,
    state: Params | None = None,    # {"s": (B,H,N,N) f32, "shift": (B,d)}
    norm_eps: float = 1e-5,
) -> tuple[torch.Tensor, Params | None]:
    b, t, d = x.shape
    h = d // head_dim

    x_prev = _token_shift(x, state)
    lora = _lora_apply(p["mu_lora"], x).reshape(b, t, 5, d)
    mu = p["mu"].to(x.dtype)[None, None] + lora                # (B, T, 5, d)
    xs = x[:, :, None] + (x_prev - x)[:, :, None] * mu
    xr, xk, xv, xw, xg = xs.unbind(2)

    r = dense_apply(p["wr"], xr).reshape(b, t, h, head_dim)
    k = dense_apply(p["wk"], xk).reshape(b, t, h, head_dim)
    v = dense_apply(p["wv"], xv).reshape(b, t, h, head_dim)
    g = F.silu(dense_apply(p["wg"], xg))
    w_log = p["w_base"].float() + _lora_apply(p["w_lora"], xw).float()
    w = torch.exp(-torch.exp(w_log)).reshape(b, t, h, head_dim).to(x.dtype)
    u = p["u"].to(x.dtype).reshape(h, head_dim)

    s0 = (
        state["s"]
        if state is not None
        else torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32, device=x.device)
    )
    y, s_fin = wkv6(r.float(), k.float(), v.float(), w.float(), u.float(), s0)
    y = y.to(x.dtype)

    # per-head group norm, in f32
    yh = y.float()
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mean) * torch.rsqrt(var + norm_eps)
    y = (yh.reshape(b, t, d) * p["ln_g"].float() + p["ln_b"].float()).to(x.dtype)

    out = dense_apply(p["wo"], y * g)
    new_state = None
    if state is not None:
        new_state = {"s": s_fin, "shift": _last(x, state["shift"])}
    return out, new_state


def rwkv_cmix_init(gen, d_model: int, d_ff: int, device) -> Params:
    return {
        "mu_k": torch.full((d_model,), 0.5, device=device),
        "mu_r": torch.full((d_model,), 0.5, device=device),
        "wk": dense_init(gen, d_model, d_ff, device),
        "wv": dense_init(gen, d_ff, d_model, device, scale=0.02 / math.sqrt(2)),
        "wr": dense_init(gen, d_model, d_model, device),
    }


def rwkv_cmix_apply(
    p: Params,
    x: torch.Tensor,
    *,
    state: Params | None = None,    # {"shift": (B, d)}
) -> tuple[torch.Tensor, Params | None]:
    x_prev = _token_shift(x, state)
    xk = x + (x_prev - x) * p["mu_k"].to(x.dtype)
    xr = x + (x_prev - x) * p["mu_r"].to(x.dtype)
    k = torch.square(torch.relu(dense_apply(p["wk"], xk)))
    out = torch.sigmoid(dense_apply(p["wr"], xr)) * dense_apply(p["wv"], k)
    new_state = {"shift": _last(x, state["shift"])} if state is not None else None
    return out, new_state


def rwkv_init_state(b: int, d_model: int, head_dim: int, *, dtype: torch.dtype,
                    device) -> Params:
    h = d_model // head_dim
    return {
        "tmix": {
            "s": torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32, device=device),
            "shift": torch.zeros((b, d_model), dtype=dtype, device=device),
        },
        "cmix": {"shift": torch.zeros((b, d_model), dtype=dtype, device=device)},
    }
