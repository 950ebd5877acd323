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


# ---- the backward kernel and the differentiable wrapper

# relative to each gradient's scale: the same f32 reverse sweep, with the
# contractions summed in another order and the states recomputed by FMA
# from checkpoints where the plain version keeps every state
BWD_TOL = 1e-4


def _grads_in(shape, seed, device, w_kind="decay"):
    b, t, h, n = shape
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)
    ds_fin = torch.from_numpy(rng.normal(0, 1, (b, h, n, n)).astype(np.float32)).to(device)
    return _inputs(shape, seed, device, w_kind), dy, ds_fin


def _assert_close(got, want, tol, label):
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        scale = max(1.0, x.abs().max().item())
        err = (g - x).abs().max().item()
        assert torch.isfinite(g).all(), f"{label} {name} not finite"
        assert err <= tol * scale, f"{label} {name}: {err:.3e} > {tol} x {scale:.3e}"


# the training shape's heads at T = 4096 (cut to 2 heads), the serving
# prefill, ragged chunks (T = 1, 7, 513), the edges of the per-chunk finish
# and of the buffers' parities (one chunk, one chunk and a step, two
# chunks: T = 8, 9, 16), head dim 16, and w with zeros
BWD_CASES = [
    pytest.param((1, 4096, 2, 64), "decay", id="t4096"),
    pytest.param((8, 512, 64, 64), "decay", id="prefill"),
    pytest.param((2, 1, 4, 64), "decay", id="t1"),
    pytest.param((2, 7, 4, 64), "decay", id="ragged-t7"),
    pytest.param((2, 8, 4, 64), "decay", id="t8-one-chunk"),
    pytest.param((2, 9, 4, 64), "decay", id="t9-chunk-and-a-step"),
    pytest.param((2, 16, 4, 64), "decay", id="t16-two-chunks"),
    pytest.param((2, 513, 8, 64), "decay", id="ragged-t513"),
    pytest.param((3, 37, 5, 16), "decay", id="head-dim-16-ragged"),
    pytest.param((2, 200, 8, 64), "zeros", id="w-zeros-subnormal"),
    pytest.param((2, 64, 4, 16), "zeros", id="head-dim-16-w-zeros"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,w_kind", BWD_CASES)
def test_backward_kernel_matches_plain(card, shape, w_kind):
    args, dy, ds_fin = _grads_in(shape, 13, card, w_kind)
    before = ops.wkv6_backward.launches
    got = ops.wkv6_backward(*args, dy, ds_fin)
    torch.cuda.synchronize()
    assert ops.wkv6_backward.launches == before + 1
    _assert_close(got, ops.wkv6_backward_ref(*args, dy, ds_fin), BWD_TOL, "kernel vs plain")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 513, 8, 64), (3, 37, 5, 16)])
def test_backward_kernel_reruns_bit_identical(card, shape):
    """The kernel sums in a fixed order (no atomics), so a second launch on
    the same inputs gives the same bits in every gradient."""
    args, dy, ds_fin = _grads_in(shape, 19, card)
    first = ops.wkv6_backward(*args, dy, ds_fin)
    second = ops.wkv6_backward(*args, dy, ds_fin)
    torch.cuda.synchronize()
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f"{name} differs"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 40, 4, 64), (2, 19, 3, 16)])
def test_wrapper_gradients_match_autograd_of_plain(card, shape):
    """Fault 7: on the card the wrapper's outputs carry a grad_fn and its
    gradients are those of autograd through the plain recurrence; a None
    gradient of the final state counts as zeros."""
    args, dy, ds_fin = _grads_in(shape, 17, card)
    for with_state_grad in (True, False):
        xs = [x.clone().requires_grad_() for x in args]
        y, s = ops.wkv6(*xs)
        assert y.grad_fn is not None and s.grad_fn is not None
        loss = (y * dy).sum() + ((s * ds_fin).sum() if with_state_grad else 0.0)
        got = torch.autograd.grad(loss, xs)
        xr = [x.clone().requires_grad_() for x in args]
        yr, sr = wkv6_ref(*xr)
        loss_r = (yr * dy).sum() + ((sr * ds_fin).sum() if with_state_grad else 0.0)
        _assert_close(got, torch.autograd.grad(loss_r, xr), BWD_TOL, "wrapper vs autograd")


@pytest.mark.gpu
def test_wrapper_saves_nothing_without_grad(card):
    args = _inputs((2, 8, 4, 64), seed=3, device=card)
    before = (ops.wkv6.launches, ops.wkv6_backward.launches)
    with torch.inference_mode():
        y, s = ops.wkv6(*args)
    assert y.grad_fn is None and s.grad_fn is None
    assert (ops.wkv6.launches, ops.wkv6_backward.launches) == (before[0] + 1, before[1])


def _model_grads(cfg, params, tokens, plain, monkeypatch):
    """Gradients of the f32 loss per parameter leaf, through the kernels or
    with the wrapper swapped for the plain recurrence (autograd through
    it)."""
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.tree import leaves
    from repro_torch.train.train_step import loss_fn

    with monkeypatch.context() as mp:
        if plain:
            mp.setattr(rwkv_mod, "wkv6", wkv6_ref)
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        loss = loss_fn(cfg, params, {"tokens": tokens, "labels": tokens.roll(-1, 1)},
                       torch.float32)
        return loss.item(), torch.autograd.grad(loss, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("full_width", [False, True], ids=["smoke", "one-full-width-layer"])
def test_model_gradients_through_kernels_match_plain(card, full_width, monkeypatch):
    """rwkv6 at smoke size, and one rwkv6-7b layer at full width: every
    leaf's gradient through the kernels within 1e-4 of its norm of the plain
    path's, and every mixer leaf's gradient nonzero (fault 7)."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models.model import init_params

    cfg = (dataclasses.replace(get_config("rwkv6-7b"), n_layers=1) if full_width
           else get_smoke_config("rwkv6-7b"))
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int64)).to(card)
    before = (ops.wkv6.launches, ops.wkv6_backward.launches)
    loss_k, gk = _model_grads(cfg, params, tokens, False, monkeypatch)
    launched = (ops.wkv6.launches - before[0], ops.wkv6_backward.launches - before[1])
    assert launched == (2 * cfg.n_layers, cfg.n_layers)      # forward + remat recompute
    loss_p, gp = _model_grads(cfg, params, tokens, True, monkeypatch)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    from repro_torch.tree import leaf_paths
    for (key, _), a, b in zip(leaf_paths(params), gk, gp):
        assert (a - b).norm() <= 1e-4 * b.norm() + 1e-12, key
        if "/mixer/" in key:
            assert a.abs().max() > 0, f"{key}: no gradient through the kernel path"
