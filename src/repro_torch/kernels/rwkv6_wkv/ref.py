"""Plain PyTorch WKV6: the sequential recurrence and its reverse sweep.

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Shapes: r/k/v/w (B, T, H, N); u (H, N); state (B, H, N, N).
All math in float32 (products of decays underflow quickly in bf16), or in
float64 when an input is float64.
"""

from __future__ import annotations

import torch

__all__ = ["wkv6_ref", "wkv6_backward_ref"]


def _math_dtype(*xs: torch.Tensor) -> torch.dtype:
    return torch.float64 if any(x.dtype == torch.float64 for x in xs) else torch.float32


def wkv6_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, N) f32, final state (B, H, N, N) f32)."""
    dt = _math_dtype(r, k, v, w, u, state)
    r, k, v, w, u, s = (x.to(dt) for x in (r, k, v, w, u, state))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B, H, N, N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv6_backward_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
    dy: torch.Tensor,      # (B, T, H, N): gradient of y
    ds_fin: torch.Tensor,  # (B, H, N, N): gradient of the final state
) -> tuple[torch.Tensor, ...]:
    """Returns (dr, dk, dv, dw, du, ds0), in float32 (float64 for a float64
    input): the reverse sweep of
    the recurrence, from dS_T = ds_fin down to t = 1,

        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
        du  += r_t * k_t * (v_t . dy_t)
        dk_t = u * r_t * (v_t . dy_t) + dS_t v_t
        dv_t = (r_t . (u * k_t)) dy_t + dS_t^T k_t
        dw_t = rowsum(dS_t * S_{t-1})
        dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T

    with ds0 = dS_0 and du summed over batch and time.  The states S_{t-1}
    come from a forward sweep kept in full; nothing divides by w, which may
    be 0."""
    dt = _math_dtype(r, k, v, w, u, state, dy, ds_fin)
    r, k, v, w, u, s, dy = (x.to(dt) for x in (r, k, v, w, u, state, dy))
    states = []
    for t in range(r.shape[1]):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    ds = ds_fin.to(dt)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    uu = u[None]
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dyt = r[:, t], k[:, t], v[:, t], w[:, t], dy[:, t]   # (B, H, N)
        vdy = (vt * dyt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", states[t], dyt) + uu * kt * vdy
        du = du + (rt * kt * vdy).sum(0)
        dk[:, t] = uu * rt * vdy + torch.einsum("bhij,bhj->bhi", ds, vt)
        dv[:, t] = ((rt * uu * kt).sum(-1, keepdim=True) * dyt
                    + torch.einsum("bhij,bhi->bhj", ds, kt))
        dw[:, t] = (ds * states[t]).sum(-1)
        ds = wt[..., None] * ds + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, ds
