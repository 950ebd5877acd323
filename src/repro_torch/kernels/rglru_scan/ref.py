"""Plain PyTorch RG-LRU scan: the gated linear recurrence, swept in order,
and its reverse sweep.

    h_t = a_t * h_{t-1} + b_t        (per channel)

Inputs: a, b (B, T, D) with a in (0, 1]; h0 (B, D).
Returns (h (B, T, D), h_T (B, D)), in float32 (float64 when an input is
float64).
"""

from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref", "rglru_scan_backward_ref"]


def _math_dtype(*xs: torch.Tensor) -> torch.dtype:
    return torch.float64 if any(x.dtype == torch.float64 for x in xs) else torch.float32


def rglru_scan_ref(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    dt = _math_dtype(a, b, h0)
    a, b, h = a.to(dt), b.to(dt), h0.to(dt)
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_scan_backward_ref(
    a: torch.Tensor,        # (B, T, D)
    h: torch.Tensor,        # (B, T, D): the forward's output
    h0: torch.Tensor,       # (B, D)
    dh: torch.Tensor,       # (B, T, D): gradient of h
    dh_last: torch.Tensor,  # (B, D): gradient of h_T
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (da, db, dh0), in float32: the reverse scan

        g_T = dh_T + dh_last,   g_t = dh_t + a_{t+1} g_{t+1}
        db_t = g_t,   da_t = g_t h_{t-1} (h_0 = h0),   dh0 = a_1 g_1

    (float64 for a float64 input)."""
    dt = _math_dtype(a, h, h0, dh, dh_last)
    a, h, h0, dh = a.to(dt), h.to(dt), h0.to(dt), dh.to(dt)
    da, db = torch.empty_like(a), torch.empty_like(a)
    carry = dh_last.to(dt)                     # a_{t+1} g_{t+1}
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + carry
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else h0)
        carry = a[:, t] * g
    return da, db, carry
