"""Plain PyTorch white-data filter: error feedback, threshold and split.

Per element, over a gradient g and its residual r (any shape):

    acc   = g + r                       (in float32)
    keep  = |acc| >= tau
    send  = keep ? acc : 0              (crosses the slow link, g's dtype)
    r'    = keep ? 0   : acc            (stays local, r's dtype)
    kept  = sum(keep)                   (int32)

``send + r' == g + r``: the filter defers what it does not send and never
loses it.  Counterpart of ``repro/kernels/whitedata_filter/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["whitedata_filter_ref"]


def whitedata_filter_ref(
    g: torch.Tensor, r: torch.Tensor, tau: torch.Tensor | float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (send, new_residual, kept: int32 scalar)."""
    acc = g.float() + r.float()
    keep = acc.abs() >= torch.as_tensor(tau, dtype=torch.float32)
    send = torch.where(keep, acc, 0.0).to(g.dtype)
    new_r = torch.where(keep, 0.0, acc).to(r.dtype)
    return send, new_r, keep.sum(dtype=torch.int32)
