"""The port's RG-LRU scan backward: the plain reverse scan
(``repro_torch.kernels.rglru_scan.ref.rglru_scan_backward_ref``) against
torch autograd through the plain forward and against ``jax.vjp`` of the
JAX package's ``repro/kernels/rglru_scan/ref.py``; the differentiable
wrapper (``ops.rglru_scan``, an autograd Function) on the CPU.
``test_torch_rglru_scan_gpu.py`` holds the backward kernel against the
plain version on the card.

Inputs are numpy arrays from a seed, f32.  Tolerances: against torch
autograd, bit for bit (the same products and sums in the same order);
against JAX, rtol = atol = 1e-5 (XLA may contract the carry's product and
sum into one FMA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_scan_ref
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_backward_ref, rglru_scan_ref

JAX_TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("da", "db", "dh0")


def _arrays(b, t, d, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.uniform(0.5, 0.999, (b, t, d)).astype(f), rng.normal(0, 0.5, (b, t, d)).astype(f),
            rng.normal(0, 1, (b, d)).astype(f), rng.normal(0, 1, (b, t, d)).astype(f),
            rng.normal(0, 1, (b, d)).astype(f))


def _t(arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _autograd(a, b, h0, dh, dh_last, fn=rglru_scan_ref):
    xs = [x.clone().requires_grad_() for x in (a, b, h0)]
    h, last = fn(*xs)
    loss = (h * dh).sum() + (0.0 if dh_last is None else (last * dh_last).sum())
    return torch.autograd.grad(loss, xs)


SHAPES = [(2, 16, 8), (1, 37, 5), (3, 1, 64), (2, 64, 96)]


@pytest.mark.parametrize("b,t,d", SHAPES)
def test_plain_backward_matches_torch_autograd(b, t, d):
    a, bb, h0, dh, dh_last = _t(_arrays(b, t, d, seed=3))
    h, _ = rglru_scan_ref(a, bb, h0)
    got = rglru_scan_backward_ref(a, h, h0, dh, dh_last)
    for name, g, want in zip(NAMES, got, _autograd(a, bb, h0, dh, dh_last)):
        assert torch.equal(g, want), name


@pytest.mark.parametrize("b,t,d", SHAPES)
def test_plain_backward_matches_jax_vjp(b, t, d):
    a, bb, h0, dh, dh_last = _arrays(b, t, d, seed=4)
    _, vjp = jax.vjp(jax_rglru_scan_ref, *(jnp.asarray(x) for x in (a, bb, h0)))
    want = vjp((jnp.asarray(dh), jnp.asarray(dh_last)))
    ta, tb, th0, tdh, tdl = _t((a, bb, h0, dh, dh_last))
    h, _ = rglru_scan_ref(ta, tb, th0)
    got = rglru_scan_backward_ref(ta, h, th0, tdh, tdl)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **JAX_TOL)


def test_wrapper_is_an_autograd_function_on_the_cpu():
    """Outputs carry a grad_fn; the gradients equal autograd through the
    plain forward; a None gradient of h_T counts as zeros; no kernel
    counter moves on the CPU."""
    a, b, h0, dh, dh_last = _t(_arrays(2, 13, 24, seed=5))
    before = (ops.rglru_scan.launches, ops.rglru_scan_backward.launches)
    for last in (dh_last, None):
        xs = [x.clone().requires_grad_() for x in (a, b, h0)]
        h, h_last = ops.rglru_scan(*xs)
        assert h.grad_fn is not None and h_last.grad_fn is not None
        loss = (h * dh).sum() + (0.0 if last is None else (h_last * last).sum())
        got = torch.autograd.grad(loss, xs)
        for name, g, want in zip(NAMES, got, _autograd(a, b, h0, dh, last)):
            assert torch.equal(g, want), name
    assert (ops.rglru_scan.launches, ops.rglru_scan_backward.launches) == before


def test_saves_nothing_without_grad():
    a, b, h0, _, _ = _t(_arrays(1, 5, 8, seed=6))
    xs = [x.clone().requires_grad_() for x in (a, b, h0)]
    with torch.inference_mode():
        h, _ = ops.rglru_scan(*xs)
    assert h.grad_fn is None
    h, _ = ops.rglru_scan(a, b, h0)
    assert h.grad_fn is None and torch.equal(h, rglru_scan_ref(a, b, h0)[0])


def test_only_b_requires_grad():
    """The RG-LRU block's b term requires grad where h0 (a zero state) does
    not: only b's gradient is computed, and it is the reverse scan's."""
    a, b, h0, dh, _ = _t(_arrays(2, 9, 8, seed=7))
    bb = b.clone().requires_grad_()
    h, _ = ops.rglru_scan(a, bb, h0)
    (db,) = torch.autograd.grad((h * dh).sum(), [bb])
    want = rglru_scan_backward_ref(a, h.detach(), h0, dh, torch.zeros_like(h0))[1]
    assert torch.equal(db, want)


def test_backward_refuses_mismatched_gradients():
    a, b, h0, dh, dh_last = _t(_arrays(1, 5, 8, seed=8))
    with pytest.raises(ValueError, match="do not match"):
        ops.rglru_scan_backward(a, a, h0, dh[:, :3], dh_last)
