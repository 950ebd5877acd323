"""Mixture-of-Experts FFN with top-k routing (+ shared experts): the
counterpart of ``repro.models.moe``'s dense dispatch
(``_moe_apply_dense_dispatch``), on one card.

Tokens pick their top-k experts; within each expert the first ``capacity``
assignments, in token-major order with k by descending gate, are kept and
the rest drop (GShard / Switch semantics).  ``capacity`` is per call,
``max(1, int(capacity_factor * top_k * T / E))`` with ``T = B * S``, so a
decode step of a few tokens drops assignments a long prefill keeps.
Expert weights are stacked ``(E, d, d_ff)``.  The reference's
expert-parallel dispatch over a ``model`` mesh axis waits for the port's
mesh.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params, dense_init, normal, swiglu_apply, swiglu_init

__all__ = ["moe_init", "moe_apply"]


def moe_init(gen, d_model: int, n_experts: int, d_expert: int, device: torch.device, *,
             n_shared: int = 0, d_shared: int = 0) -> Params:
    scale_in = 1.0 / math.sqrt(d_model)
    p = {
        "router": dense_init(gen, d_model, n_experts, device, scale=0.02),
        "wi": normal(gen, (n_experts, d_model, d_expert), scale_in, device),
        "wg": normal(gen, (n_experts, d_model, d_expert), scale_in, device),
        "wo": normal(gen, (n_experts, d_expert, d_model), 0.02 / math.sqrt(2), device),
    }
    if n_shared > 0:
        # the reference's shared experts: one SwiGLU of n_shared x d_shared
        p["shared"] = swiglu_init(gen, d_model, (d_shared or d_expert) * n_shared, device)
    return p


def _route(router: Params, xf: torch.Tensor, top_k: int):
    """Router probabilities (T, E) in f32, and each token's top-k gates,
    renormalised, and experts (T, K), k by descending gate."""
    # JAX promotes bf16 activations against the f32 router to an f32 product
    probs = torch.softmax(xf.float() @ router["w"].float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1, sorted=True)
    return probs, gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9), expert_idx


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              return_aux: bool = False):
    """Top-k MoE over ``x`` (B, S, d), in ``x.dtype``; the routing in f32.
    With ``return_aux`` also ``{"aux_loss", "drop_rate"}`` (f32 scalars):
    the Switch load-balance loss and the share of assignments dropped."""
    b, s, d = x.shape
    e = p["wi"].shape[0]
    t = b * s
    xf = x.reshape(t, d)

    probs, gate_vals, expert_idx = _route(p["router"], xf, top_k)
    capacity = max(1, int(capacity_factor * top_k * t / e))
    # rank of each (token, k) assignment in its expert's queue: a running
    # count down the T*K assignments, taken along the last dim of the
    # (E, T*K) transpose (PyTorch scans a leading dim of a few dozen columns
    # on the card ~100x slower); integers, so the same values either way
    onehot = F.one_hot(expert_idx, e)                                  # (T, K, E)
    flat_oh = onehot.reshape(t * top_k, e)
    rank = torch.cumsum(flat_oh.t().contiguous(), dim=1).t()
    pos = ((rank * flat_oh).amax(dim=-1) - 1).reshape(t, top_k)
    keep = pos < capacity

    # dispatch: a dropped assignment lands on slot capacity - 1 with a zero
    # row, so the scatter must add (an assignment would overwrite the token
    # kept there); each slot receives at most one nonzero row, so the sum is
    # exact in any order
    flat_e = expert_idx.reshape(-1)
    flat_pos = torch.where(keep, pos, capacity - 1).reshape(-1)
    flat_keep = keep.reshape(-1)
    src = xf.repeat_interleave(top_k, dim=0) * flat_keep[:, None].to(xf.dtype)
    buf = torch.zeros((e * capacity, d), dtype=xf.dtype, device=x.device)
    buf.index_add_(0, flat_e * capacity + flat_pos, src)
    buf = buf.view(e, capacity, d)

    h = torch.bmm(buf, p["wi"].to(xf.dtype))
    g = torch.bmm(buf, p["wg"].to(xf.dtype))
    y = torch.bmm(F.silu(g) * h, p["wo"].to(xf.dtype))                  # (E, C, d)

    # combine: each assignment's output times its gate (zero where dropped),
    # the weight cast to the compute dtype before the product
    weight = (gate_vals.reshape(-1) * flat_keep).to(xf.dtype)
    out = (y[flat_e, flat_pos] * weight[:, None]).reshape(t, top_k, d).sum(dim=1)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], xf)
    out = out.reshape(b, s, d)
    if not return_aux:
        return out
    frac_tokens = onehot.float().sum(dim=(0, 1)) / (t * top_k)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    return out, {"aux_loss": aux, "drop_rate": 1.0 - flat_keep.float().mean()}
