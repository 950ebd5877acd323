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


# (1, 33, 100) and (2, 37, 45) end in a partial 32-channel tile; D = 45 is
# no multiple of 4, so the kernels copy it 4 bytes at a time, not 16
RAGGED = [(1, 33, 100), (2, 37, 45)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 512, 4096), (8, 1, 4096), (1, 4096, 4096), (2, 37, 96),
                                   (3, 17, 64), *RAGGED])
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


# ---- the backward kernel and the differentiable wrapper

# relative to each gradient's scale: the same f32 reverse scan, the carry
# possibly contracted into an FMA by the compiler
BWD_TOL = 1e-5


def _grads_in(shape, seed, device):
    a, b, h0 = _inputs(shape, seed, device)
    rng = np.random.default_rng(seed + 1)
    dh = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(device)
    dh_last = torch.from_numpy(rng.normal(0, 1, shape[::2]).astype(np.float32)).to(device)
    return a, b, h0, dh, dh_last


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4096, 4096), (8, 512, 4096), (8, 1, 4096),
                                   (2, 37, 96), (3, 17, 64), *RAGGED])
def test_backward_kernel_matches_plain(card, shape):
    a, b, h0, dh, dh_last = _grads_in(shape, 13, card)
    h, _ = rglru_scan_ref(a, b, h0)
    before = ops.rglru_scan_backward.launches
    got = ops.rglru_scan_backward(a, h, h0, dh, dh_last)
    torch.cuda.synchronize()
    assert ops.rglru_scan_backward.launches == before + 1
    for g, x in zip(got, ops.rglru_scan_backward_ref(a, h, h0, dh, dh_last)):
        scale = max(1.0, x.abs().max().item())
        assert (g - x).abs().max().item() <= BWD_TOL * scale


def _both_kernels(shape, seed, device):
    """The forward's and the backward's outputs on one set of inputs."""
    a, b, h0, dh, dh_last = _grads_in(shape, seed, device)
    h, h_last = ops.rglru_scan(a, b, h0)
    return (h, h_last, *ops.rglru_scan_backward(a, h, h0, dh, dh_last))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4096, 4096), (8, 512, 4096), (2, 37, 45)])
def test_kernels_rerun_bit_identical(card, shape):
    """Each channel's walk has one fixed order, so a second run on the same
    inputs gives the same bits; a difference is a race in the staging ring."""
    first = _both_kernels(shape, 19, card)
    second = _both_kernels(shape, 19, card)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 512, 4096), (2, 37, 45)])
def test_kernels_leave_their_inputs_unchanged(card, shape):
    inputs = _grads_in(shape, 23, card)
    a, b, h0, dh, dh_last = inputs
    h, _ = ops.rglru_scan(a, b, h0)
    saved = [x.clone() for x in (*inputs, h)]
    ops.rglru_scan(a, b, h0)
    ops.rglru_scan_backward(a, h, h0, dh, dh_last)
    torch.cuda.synchronize()
    for x, y in zip((*inputs, h), saved):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.gpu
def test_kernels_take_inputs_not_16_byte_aligned(card):
    """Contiguous views that start 4 bytes into their storage: the kernels
    copy them 4 bytes at a time and give the plain versions' values."""
    shape = (2, 37, 96)
    aligned = _grads_in(shape, 29, card)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=card)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        return view

    a, b, h0, dh, dh_last = map(shifted, aligned)
    h, h_last = ops.rglru_scan(a, b, h0)
    got = (h, h_last, *ops.rglru_scan_backward(a, shifted(h), h0, dh, dh_last))
    h_ref, last_ref = rglru_scan_ref(*aligned[:3])
    want = (h_ref, last_ref, *ops.rglru_scan_backward_ref(aligned[0], h_ref, *aligned[2:]))
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert (g - x).abs().max().item() <= BWD_TOL * max(1.0, x.abs().max().item())


@pytest.mark.gpu
def test_wrapper_gradients_match_autograd_of_plain(card):
    """Fault 7: the wrapper's outputs carry a grad_fn, and its gradients are
    those of autograd through the plain recurrence; a None gradient of h_T
    counts as zeros."""
    a, b, h0, dh, dh_last = _grads_in((2, 45, 96), 17, card)
    for with_last in (True, False):
        xs = [x.clone().requires_grad_() for x in (a, b, h0)]
        h, last = ops.rglru_scan(*xs)
        assert h.grad_fn is not None
        got = torch.autograd.grad((h * dh).sum() + ((last * dh_last).sum() if with_last else 0.0),
                                  xs)
        xr = [x.clone().requires_grad_() for x in (a, b, h0)]
        hr, lr = rglru_scan_ref(*xr)
        want = torch.autograd.grad((hr * dh).sum() + ((lr * dh_last).sum() if with_last else 0.0),
                                   xr)
        for g, x in zip(got, want):
            assert (g - x).abs().max().item() <= BWD_TOL * max(1.0, x.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("full_width", [False, True], ids=["smoke", "one-full-width-layer"])
def test_model_gradients_through_kernels_match_plain(card, full_width, monkeypatch):
    """recurrentgemma at smoke size, and one recurrentgemma-9b RG-LRU block at
    full width: every leaf's gradient through the kernels within 1e-4 of its
    norm of the plain path's, every mixer leaf's gradient nonzero."""
    import dataclasses

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.tree import leaf_paths
    from repro_torch.models.model import init_params
    from repro_torch.tree import leaves
    from repro_torch.train.train_step import loss_fn

    cfg = (dataclasses.replace(get_config("recurrentgemma-9b"), n_layers=1) if full_width
           else get_smoke_config("recurrentgemma-9b"))
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0), card)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int64)).to(card)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    n_rglru = sum(blk.mixer == "rglru" for blk in cfg.block_list())
    results = []
    for plain in (False, True):
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(rglru_mod, "rglru_scan", rglru_scan_ref)
            ps = leaves(params)
            for p in ps:
                p.requires_grad_(True)
            before = (ops.rglru_scan.launches, ops.rglru_scan_backward.launches)
            loss = loss_fn(cfg, params, batch, torch.float32)
            results.append((loss.item(), torch.autograd.grad(loss, ps)))
            launched = (ops.rglru_scan.launches - before[0],
                        ops.rglru_scan_backward.launches - before[1])
            assert launched == ((0, 0) if plain else (2 * n_rglru, n_rglru))
    (loss_k, gk), (loss_p, gp) = results
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for (key, _), a, b in zip(leaf_paths(params), gk, gp):
        assert (a - b).norm() <= 1e-4 * b.norm() + 1e-12, key
        if "/mixer/" in key and "rglru" in str(cfg.block_list()[int(key.split("/")[1])]):
            assert a.abs().max() > 0, f"{key}: no gradient through the kernel path"
