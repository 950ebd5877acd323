"""The CUDA WKV6 kernel against its plain PyTorch version, on the card.

The kernel has no CPU or interpret mode, so these tests skip without a
card; each decides that when it runs.  This file imports no JAX, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wkv6_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.rwkv6_wkv import ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

# relative to the output's scale: the same f32 recurrence, with y summed in
# another order by the plain version's batched matmul
TOL = 2e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, seed, device):
    b, t, h, n = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0, 1, shape) for _ in range(3)] + [
        rng.uniform(0.5, 0.999, shape),
        rng.normal(0, 0.5, (h, n)),
        rng.normal(0, 0.1, (b, h, n, n)),
    ]
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 512, 64, 64), (8, 1, 64, 64), (2, 64, 4, 16)])
def test_kernel_matches_plain(card, shape):
    args = _inputs(shape, seed=11, device=card)
    before = ops.wkv6.launches
    y, s = ops.wkv6(*args)
    torch.cuda.synchronize()
    assert ops.wkv6.launches == before + 1
    y_ref, s_ref = wkv6_ref(*args)
    for got, want in ((y, y_ref), (s, s_ref)):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= TOL * scale


@pytest.mark.gpu
def test_kernel_refuses_what_it_is_not_built_for(card):
    r, k, v, w, u, s0 = _inputs((1, 4, 2, 32), seed=0, device=card)
    with pytest.raises(ValueError, match="head dims"):
        ops.wkv6(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = _inputs((1, 4, 2, 16), seed=0, device=card)
    with pytest.raises(TypeError):
        ops.wkv6(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u, s0)
