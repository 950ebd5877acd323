"""The port's WKV6 backward: the plain reverse sweep
(``repro_torch.kernels.rwkv6_wkv.ref.wkv6_backward_ref``) against torch
autograd through the plain forward and against ``jax.vjp`` of the JAX
package's ``repro/kernels/rwkv6_wkv/ref.py``; the differentiable wrapper
(``ops.wkv6``, an autograd Function) on the CPU; w with exact zeros.
``test_torch_wkv6_gpu.py`` holds the backward kernel against the plain
version on the card.

Inputs are numpy arrays from a seed.  f32 throughout.  Tolerances:

* against torch autograd: rtol = atol = 1e-5 (the same sums, in another
  order: autograd accumulates each state's gradient through the einsums);
* against JAX: rtol = atol = 1e-4 (JAX's scan and its transpose take the
  contractions in other orders, over up to 37 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.kernels.rwkv6_wkv import ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_backward_ref, wkv6_ref

TORCH_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _arrays(b, t, h, n, seed, w_low=0.5):
    rng = np.random.default_rng(seed)
    f = np.float32
    args = (
        rng.normal(0, 1, (b, t, h, n)).astype(f),
        rng.normal(0, 1, (b, t, h, n)).astype(f),
        rng.normal(0, 1, (b, t, h, n)).astype(f),
        rng.uniform(w_low, 0.99, (b, t, h, n)).astype(f),
        rng.normal(0, 0.3, (h, n)).astype(f),
        rng.normal(0, 0.2, (b, h, n, n)).astype(f),
    )
    dy = rng.normal(0, 1, (b, t, h, n)).astype(f)
    ds_fin = rng.normal(0, 1, (b, h, n, n)).astype(f)
    return args, dy, ds_fin


def _t(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _autograd(args, dy, ds_fin, fn=wkv6_ref):
    xs = [x.clone().requires_grad_() for x in args]
    y, s = fn(*xs)
    loss = (y * dy).sum() + (0.0 if ds_fin is None else (s * ds_fin).sum())
    return torch.autograd.grad(loss, xs)


SHAPES = [(2, 16, 2, 16), (1, 37, 1, 8), (2, 9, 3, 64), (3, 1, 2, 16)]


@pytest.mark.parametrize("b,t,h,n", SHAPES)
def test_plain_backward_matches_torch_autograd(b, t, h, n):
    args, dy, ds_fin = _arrays(b, t, h, n, seed=3)
    args, dy, ds_fin = _t(args), torch.from_numpy(dy), torch.from_numpy(ds_fin)
    got = wkv6_backward_ref(*args, dy, ds_fin)
    for name, g, want in zip(NAMES, got, _autograd(args, dy, ds_fin)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), err_msg=name, **TORCH_TOL)


@pytest.mark.parametrize("b,t,h,n", SHAPES)
def test_plain_backward_matches_jax_vjp(b, t, h, n):
    args, dy, ds_fin = _arrays(b, t, h, n, seed=4)
    _, vjp = jax.vjp(jax_wkv6_ref, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds_fin)))
    got = wkv6_backward_ref(*_t(args), torch.from_numpy(dy), torch.from_numpy(ds_fin))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **JAX_TOL)


def test_wrapper_is_an_autograd_function_on_the_cpu():
    """Outputs carry a grad_fn; the gradients are the plain reverse sweep's,
    bit for bit, and within TORCH_TOL of autograd through the plain forward;
    no kernel counter moves on the CPU."""
    args, dy, ds_fin = _arrays(2, 11, 2, 16, seed=5)
    args, dy, ds_fin = _t(args), torch.from_numpy(dy), torch.from_numpy(ds_fin)
    before = (ops.wkv6.launches, ops.wkv6_backward.launches)
    xs = [x.clone().requires_grad_() for x in args]
    y, s = ops.wkv6(*xs)
    assert y.grad_fn is not None and s.grad_fn is not None
    got = torch.autograd.grad((y * dy).sum() + (s * ds_fin).sum(), xs)
    for name, g, want in zip(NAMES, got, wkv6_backward_ref(*args, dy, ds_fin)):
        assert torch.equal(g, want), name
    for name, g, want in zip(NAMES, got, _autograd(args, dy, ds_fin)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), err_msg=name, **TORCH_TOL)
    assert (ops.wkv6.launches, ops.wkv6_backward.launches) == before


def test_unused_final_state_counts_as_zero_gradient():
    """Training discards s_fin: its gradient arrives as None and counts as
    zeros."""
    args, dy, _ = _arrays(2, 7, 2, 16, seed=6)
    args, dy = _t(args), torch.from_numpy(dy)
    got = _autograd(args, dy, None, fn=ops.wkv6)
    want = wkv6_backward_ref(*args, dy, torch.zeros_like(args[5]))
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


def test_only_the_inputs_that_require_grad_get_one():
    args, dy, ds_fin = _arrays(1, 5, 2, 16, seed=7)
    args = _t(args)
    r = args[0].clone().requires_grad_()
    y, s = ops.wkv6(r, *args[1:])
    (dr,) = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), [r])
    want = wkv6_backward_ref(*args, torch.from_numpy(dy), torch.zeros_like(args[5]))[0]
    assert torch.equal(dr, want)


def test_saves_nothing_without_grad():
    """Under inference_mode, under no_grad, or with no input requiring grad,
    the wrapper is the plain forward: no grad_fn."""
    args, _, _ = _arrays(1, 5, 2, 16, seed=8)
    args = _t(args)
    xs = [x.clone().requires_grad_() for x in args]
    with torch.inference_mode():
        y, s = ops.wkv6(*args)
    assert y.grad_fn is None and s.grad_fn is None
    with torch.no_grad():
        y, _ = ops.wkv6(*xs)
    assert y.grad_fn is None
    y, _ = ops.wkv6(*args)
    assert y.grad_fn is None
    assert torch.equal(y, wkv6_ref(*args)[0])


def test_decay_with_exact_zeros():
    """w = 0 (and 1e-35) is a decay the recurrence takes as it is: the
    reverse sweep never divides by w, so dw stays finite and equals torch
    autograd through the plain forward; its elements where w = 0 are in
    general nonzero.  (The JAX model's chunked form clips w at 1e-12 inside
    its log, so its dw is 0 there: this case is held against torch, not
    JAX.)"""
    args, dy, ds_fin = _arrays(2, 19, 2, 16, seed=9, w_low=0.0)
    args[3].reshape(-1)[::7] = 0.0
    args[3].reshape(-1)[3::11] = 1e-35
    args, dy, ds_fin = _t(args), torch.from_numpy(dy), torch.from_numpy(ds_fin)
    got = _autograd(args, dy, ds_fin, fn=ops.wkv6)
    for name, g, want in zip(NAMES, got, _autograd(args, dy, ds_fin)):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), want.numpy(), err_msg=name, **TORCH_TOL)
    dw = got[3]
    assert (dw[args[3] == 0.0] != 0).float().mean() > 0.9


def test_backward_refuses_mismatched_gradients():
    args, dy, ds_fin = _arrays(1, 5, 2, 16, seed=10)
    args = _t(args)
    with pytest.raises(ValueError, match="do not match"):
        ops.wkv6_backward(*args, torch.from_numpy(dy)[:, :4], torch.from_numpy(ds_fin))
