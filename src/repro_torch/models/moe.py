"""Mixture-of-Experts FFN with top-k routing (+ shared experts): the
counterpart of ``repro.models.moe``.

Tokens pick their top-k experts; within each expert the first ``capacity``
assignments, in token-major order with k by descending gate, are kept and
the rest drop (GShard / Switch semantics).  ``capacity`` is per call,
``max(1, int(capacity_factor * top_k * T / E))``, so a decode step of a
few tokens drops assignments a long prefill keeps.  Expert weights are
stacked ``(E, d, d_ff)``.

Dense dispatch (``_moe_apply_dense_dispatch``) routes the tokens it is
given; under a distribution context whose ``data`` ranks hold different
rows of the pod's batch it routes the pod's rows, as the reference's
dense dispatch routes the rows its ``data`` axis splits: ``T`` is the
pod's token count and a rank's queues start after the assignments of the
``data`` ranks before it.  With ``model`` above 1 the experts are split
over ``model`` (``_moe_apply_manual_ep``, the reference's expert
parallelism): each rank routes its own rows alone, computes its block of
the experts for them, and the ranks' outputs are summed over ``model``.
Across pods each pod routes its own rows (the port is multi-controller).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import context as dist_context
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


def _queue_positions(expert_idx: torch.Tensor, e: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank of each (token, k) assignment in its expert's queue (T, K),
    and the (T * K, E) one-hot of the assignments."""
    t, k = expert_idx.shape
    # F.one_hot's own scatter, without the range check it reads back to the
    # host on the CPU alone: the same operations on every device
    flat_oh = torch.zeros((t * k, e), dtype=torch.long, device=expert_idx.device).scatter_(
        1, expert_idx.reshape(t * k, 1), 1)
    # a running count down the T*K assignments, taken along the last dim of
    # the (E, T*K) transpose (PyTorch scans a leading dim of a few dozen
    # columns on the card ~100x slower); integers, so the same values either way
    rank = torch.cumsum(flat_oh.t().contiguous(), dim=1).t()
    return ((rank * flat_oh).amax(dim=-1) - 1).reshape(t, k), flat_oh


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              return_aux: bool = False):
    """Top-k MoE over ``x`` (B, S, d), in ``x.dtype``; the routing in f32.
    With ``return_aux`` also ``{"aux_loss", "drop_rate"}`` (f32 scalars):
    the Switch load-balance loss and the share of assignments dropped.
    Expert-parallel where the reference is: under a distribution context
    with ``model`` above 1, without ``return_aux``."""
    ctx = dist_context.current()
    if not return_aux and ctx is not None and ctx.model_size > 1:
        return _moe_apply_manual_ep(p, x, top_k=top_k, capacity_factor=capacity_factor, ctx=ctx)
    return _moe_apply_dense_dispatch(p, x, top_k=top_k, capacity_factor=capacity_factor,
                                     return_aux=return_aux, ctx=ctx)


def _moe_apply_manual_ep(p: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float,
                         ctx: dist_context.DistContext) -> torch.Tensor:
    """Expert parallelism (the reference's ``_moe_apply_manual_ep``): this
    rank routes its own rows alone (capacity from its tokens, the
    reference's ``t_local``: a ``data`` rank's rows are its token shard),
    keeps the assignments to its ``model`` block of the experts
    (``DistContext.experts``), scatters them into (e_local, C, d) with
    ``top_k`` scatters, combines its experts' outputs in f32, and the
    ranks' outputs are summed over ``model`` in f32 (each in f64 under f64
    compute, ``dist.context.wide``).  The router's f32 product is the same
    on every rank.  The expert weights are whole here (gathered by the
    caller over ``data``, as the reference's FSDP gather inside its region
    gives them); a rank reads its experts' rows."""
    b, s, d = x.shape
    e = p["wi"].shape[0]
    t = b * s
    _, e_local, lo = ctx.experts(e)
    capacity = max(1, int(capacity_factor * top_k * t / e))
    cdt = x.dtype

    xw = ctx.enter(x.reshape(t, d).to(dist_context.wide(cdt)))
    xf = xw.to(cdt)
    _, gate_vals, expert_idx = _route(p["router"], xw, top_k)
    pos, _ = _queue_positions(expert_idx, e)
    keep = pos < capacity
    ctx.count_moe(keep)
    is_local = (expert_idx >= lo) & (expert_idx < lo + e_local)
    keep_l = keep & is_local
    slot = torch.where(is_local, expert_idx - lo, 0) * capacity + torch.where(keep_l, pos,
                                                                              capacity - 1)
    buf = torch.zeros((e_local * capacity, d), dtype=cdt, device=x.device)
    for j in range(top_k):          # each slot receives at most one nonzero row
        buf.index_add_(0, slot[:, j], xf * keep_l[:, j, None].to(cdt))

    def local(w: torch.Tensor) -> torch.Tensor:
        mine = w[lo:lo + e_local]
        if mine.shape[0] < e_local:                         # the padded experts: zeros
            mine = torch.cat([mine, mine.new_zeros(e_local - mine.shape[0], *mine.shape[1:])])
        return mine.to(cdt)

    buf = buf.view(e_local, capacity, d)
    h = torch.bmm(buf, local(p["wi"]))
    g = torch.bmm(buf, local(p["wg"]))
    y = torch.bmm(F.silu(g) * h, local(p["wo"])).view(e_local * capacity, d)

    out = torch.zeros((t, d), dtype=xw.dtype, device=x.device)
    for j in range(top_k):
        weight = (gate_vals[:, j] * keep_l[:, j]).to(xw.dtype)
        out = out + y[slot[:, j]].to(xw.dtype) * weight[:, None]
    out = ctx.exit(out).to(x.dtype)
    if "shared" in p:
        out = out + swiglu_apply(p["shared"], x.reshape(t, d))
    return out.reshape(b, s, d)


def _moe_apply_dense_dispatch(p: Params, x: torch.Tensor, *, top_k: int,
                              capacity_factor: float = 1.25, return_aux: bool = False,
                              ctx: dist_context.DistContext | None = None):
    b, s, d = x.shape
    e = p["wi"].shape[0]
    t = b * s
    xf = x.reshape(t, d)

    probs, gate_vals, expert_idx = _route(p["router"], xf, top_k)
    # rank of each (token, k) assignment in its expert's queue; over a pod's
    # rows split over data, after the assignments of the data ranks before
    local_pos, flat_oh = _queue_positions(expert_idx, e)
    if ctx is not None and ctx.splits_rows:
        capacity = max(1, int(capacity_factor * top_k * t * ctx.data_size / e))
        pos = local_pos + ctx.rows_before(flat_oh.sum(dim=0))[expert_idx]
        slots = min(capacity, t)          # a rank's queue of an expert holds at most t
    else:
        capacity = max(1, int(capacity_factor * top_k * t / e))
        pos, slots = local_pos, capacity
    keep = pos < capacity
    if ctx is not None:
        ctx.count_moe(keep)

    # dispatch: a dropped assignment lands on slot slots - 1 with a zero
    # row, so the scatter must add (an assignment would overwrite the token
    # kept there); each slot receives at most one nonzero row, so the sum is
    # exact in any order
    flat_e = expert_idx.reshape(-1)
    flat_pos = torch.where(keep, local_pos, slots - 1).reshape(-1)
    flat_keep = keep.reshape(-1)
    src = xf.repeat_interleave(top_k, dim=0) * flat_keep[:, None].to(xf.dtype)
    buf = torch.zeros((e * slots, d), dtype=xf.dtype, device=x.device)
    buf.index_add_(0, flat_e * slots + flat_pos, src)
    buf = buf.view(e, slots, d)

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
    frac_tokens = flat_oh.float().sum(dim=0) / (t * top_k)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    return out, {"aux_loss": aux, "drop_rate": 1.0 - flat_keep.float().mean()}
