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


def _inputs(shape, seed, device, w_kind="decay"):
    """r, k, v ~ N(0, 1); u, s0 nonzero.  w_kind "decay" draws w over
    [0.5, 0.999); "zeros" over [0, 1), with exact zeros, 1e-35 and the
    subnormal 1e-40 mixed in."""
    b, t, h, n = shape
    rng = np.random.default_rng(seed)
    if w_kind == "decay":
        w = rng.uniform(0.5, 0.999, shape)
    else:
        w = rng.uniform(0.0, 1.0, shape).reshape(-1)
        w[::7], w[3::11], w[5::13] = 0.0, 1e-35, 1e-40
        w = w.reshape(shape)
    arrays = [rng.normal(0, 1, shape) for _ in range(3)] + [
        w,
        rng.normal(0, 0.5, (h, n)),
        rng.normal(0, 0.1, (b, h, n, n)),
    ]
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays)


# the main path's shapes, ragged chunks (T = 1, 7, 200, 312, 513 at the
# prefill's B, H), one head, head dim 16, and w with zeros and values below
# 1e-30; every case has a nonzero s0
CASES = [
    pytest.param((8, 512, 64, 64), "decay", id="prefill"),
    pytest.param((8, 1, 64, 64), "decay", id="decode"),
    pytest.param((2, 64, 4, 16), "decay", id="head-dim-16"),
    *(pytest.param((8, t, 64, 64), "decay", id=f"ragged-t{t}") for t in (7, 200, 312, 513)),
    pytest.param((1, 512, 1, 64), "decay", id="one-head"),
    pytest.param((3, 37, 5, 16), "decay", id="head-dim-16-ragged"),
    pytest.param((8, 512, 64, 64), "zeros", id="w-zeros-subnormal"),
    pytest.param((2, 64, 4, 16), "zeros", id="head-dim-16-w-zeros"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,w_kind", CASES)
def test_kernel_matches_plain(card, shape, w_kind):
    args = _inputs(shape, seed=11, device=card, w_kind=w_kind)
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
    shifted = torch.empty(r.numel() + 1, device=card)[1:].view(r.shape)   # 4 bytes in
    shifted.copy_(r)
    with pytest.raises(ValueError, match="16-byte"):
        ops.wkv6(shifted, k, v, w, u, s0)
