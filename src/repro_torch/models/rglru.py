"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.  Recurrence per channel:

    r_t = sigmoid(W_a x_t + b_a)                  (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                  (input gate)
    a_t = exp(c * r_t * log(sigmoid(Lambda)))     (data-dependent decay, c=8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

inside the Griffin recurrent block

    x -> [ gelu(W_gate x) ]  *  [ RG-LRU(conv1d_4(W_in x)) ]  -> W_out

The scan always goes through ``kernels.rglru_scan.ops.rglru_scan``: the
CUDA kernel on the card, the plain sequential recurrence on the CPU (the
JAX block sums with an associative scan, so the two agree to a few ulps per
step, not bit for bit).  The casts follow the JAX module one by one:

* the conv window concatenates the cached history with the new input, so
  an f32 cache under bf16 compute makes the conv output ``u`` f32, and the
  gates ``W_a``/``W_x`` then read their stored weights in f32
  (``model.cast_params_`` keeps them f32 for that reason);
* the conv weights and bias are rounded to the input's dtype first;
* the state ``h`` is stored in f32; the block output's ``h`` is rounded to
  the activation dtype before it meets the gate.

Decode is O(1): the f32 state (B, D) plus the conv window (B, W-1, D).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan.ops import rglru_scan
from .layers import Params, dense_apply, dense_init, normal

__all__ = ["rglru_block_init", "rglru_block_apply", "rglru_init_state"]

_C = 8.0


def rglru_block_init(gen, d_model: int, lru_width: int, device,
                     conv_width: int = 4) -> Params:
    # Lambda so that a = sigmoid(Lambda) lies in ~[0.9, 0.999]
    lam = torch.rand((lru_width,), generator=gen, device=device).mul_(5.0).add_(2.0)
    return {
        "w_in": dense_init(gen, d_model, lru_width, device),
        "w_gate": dense_init(gen, d_model, lru_width, device),
        "conv_w": normal(gen, (conv_width, lru_width), 0.1, device),
        "conv_b": torch.zeros(lru_width, device=device),
        "wa": dense_init(gen, lru_width, lru_width, device, bias=True),
        "wx": dense_init(gen, lru_width, lru_width, device, bias=True),
        "lam": lam,
        "w_out": dense_init(gen, lru_width, d_model, device, scale=0.02 / math.sqrt(2)),
    }


def _causal_conv1d(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                   prev: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width W.  prev: (B, W-1, D) history or None.
    The window takes the promoted dtype of history and input, as
    ``jnp.concatenate`` does."""
    width = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(prev.dtype, x.dtype)
    xp = torch.cat([prev.to(dt), x.to(dt)], dim=1)
    t = x.shape[1]
    out = sum(xp[:, i:i + t] * w[i].to(x.dtype) for i in range(width)) + b.to(x.dtype)
    # a copy: a view would keep all of xp alive in the cache
    new_prev = xp[:, -(width - 1):].clone() if width > 1 else prev
    return out, new_prev


def rglru_block_apply(
    p: Params,
    x: torch.Tensor,                 # (B, T, d_model)
    *,
    state: Params | None = None,     # {"h": (B, D) f32, "conv": (B, W-1, D)}
) -> tuple[torch.Tensor, Params | None]:
    gate = F.gelu(dense_apply(p["w_gate"], x), approximate="tanh")   # jax.nn.gelu's default
    u = dense_apply(p["w_in"], x)
    u, conv_state = _causal_conv1d(p["conv_w"], p["conv_b"], u,
                                   state["conv"] if state is not None else None)

    r = torch.sigmoid(dense_apply(p["wa"], u).float())
    i = torch.sigmoid(dense_apply(p["wx"], u).float())
    log_a = _C * r * F.logsigmoid(p["lam"].float())[None, None]      # < 0
    a = torch.exp(log_a)
    bterm = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u.float())
    h0 = state["h"].float() if state is not None else torch.zeros_like(bterm[:, 0])
    h, h_last = rglru_scan(a.contiguous(), bterm.contiguous(), h0.contiguous())
    h = h.to(x.dtype)

    out = dense_apply(p["w_out"], h * gate)
    new_state = None
    if state is not None:
        new_state = {"h": h_last.to(state["h"].dtype), "conv": conv_state}
    return out, new_state


def rglru_init_state(b: int, lru_width: int, conv_width: int = 4, *,
                     dtype: torch.dtype, device) -> Params:
    return {
        "h": torch.zeros((b, lru_width), dtype=torch.float32, device=device),
        "conv": torch.zeros((b, conv_width - 1, lru_width), dtype=dtype, device=device),
    }
