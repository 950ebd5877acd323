"""Plain PyTorch RG-LRU scan: the gated linear recurrence, swept in order.

    h_t = a_t * h_{t-1} + b_t        (per channel)

Inputs: a, b (B, T, D) with a in (0, 1]; h0 (B, D).
Returns (h (B, T, D), h_T (B, D)), in float32.
"""

from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref"]


def rglru_scan_ref(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    a, b, h = a.float(), b.float(), h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h
