"""The CUDA RG-LRU scan kernel against its plain PyTorch version, on the card.

The kernel has no CPU or interpret mode, so these tests skip without a
card; each decides that when it runs.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_rglru_scan_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

# relative to the output's scale: the same f32 recurrence, one FMA per step
# in the kernel where the plain version rounds the product and the sum
TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(shape, seed, device):
    b, t, d = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.uniform(0.5, 0.999, shape), rng.normal(0, 0.5, shape),
              rng.normal(0, 1, (b, d))]
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device) for x in arrays)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 512, 4096), (8, 1, 4096), (2, 37, 96), (3, 17, 64)])
def test_kernel_matches_plain(card, shape):
    args = _inputs(shape, seed=11, device=card)
    before = ops.rglru_scan.launches
    h, h_last = ops.rglru_scan(*args)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    h_ref, last_ref = rglru_scan_ref(*args)
    for got, want in ((h, h_ref), (h_last, last_ref)):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= TOL * scale


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    a, b, h0 = _inputs((2, 4, 32), seed=0, device=card)
    with pytest.raises(TypeError):
        ops.rglru_scan(a.double(), b, h0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), b, h0)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.rglru_scan(a, b, h0.cpu())
