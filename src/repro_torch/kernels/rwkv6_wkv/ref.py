"""Plain PyTorch WKV6: the sequential recurrence.

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

Shapes: r/k/v/w (B, T, H, N); u (H, N); state (B, H, N, N).
All math in float32 (products of decays underflow quickly in bf16).
"""

from __future__ import annotations

import torch

__all__ = ["wkv6_ref"]


def wkv6_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, N) f32, final state (B, H, N, N) f32)."""
    r, k, v, w, u, s = (x.float() for x in (r, k, v, w, u, state))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B, H, N, N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s
