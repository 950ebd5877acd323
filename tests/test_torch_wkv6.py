"""The port's WKV6 against the JAX package's: the plain recurrence
(``repro_torch.kernels.rwkv6_wkv.ref``) against JAX ``wkv6_ref`` and the
Pallas kernel in interpret mode, state continuation and the wrapper's
checks.  ``test_torch_wkv6_gpu.py`` holds the CUDA kernel against the plain
version on the card.

Inputs are numpy arrays from a seed, handed to both sides.  f32 throughout:
rtol = atol = 1e-5 (both sides run the same sequential recurrence; the sums
over the head dim are taken in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv import ops as jax_ops
from repro_torch.kernels.rwkv6_wkv import ops
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, h, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.normal(0, 1, (b, t, h, n)).astype(f),
        rng.normal(0, 1, (b, t, h, n)).astype(f),
        rng.normal(0, 1, (b, t, h, n)).astype(f),
        rng.uniform(0.5, 0.99, (b, t, h, n)).astype(f),
        rng.normal(0, 0.2, (h, n)).astype(f),
        rng.normal(0, 0.1, (b, h, n, n)).astype(f),
    )


def _torch(args, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in args)


@pytest.mark.parametrize("b,t,h,n", [(2, 16, 2, 16), (1, 37, 1, 8), (2, 8, 4, 64)])
def test_plain_matches_jax_ref_and_interpret_kernel(b, t, h, n):
    args = _inputs(b, t, h, n, seed=5)
    y, s = wkv6_ref(*_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    y_ref, s_ref = jax_ops.wkv6_ref(*jargs)
    y_pal, s_pal = jax_ops.wkv6(*jargs, use_kernel=True, interpret=True)
    for want_y, want_s in ((y_ref, s_ref), (y_pal, s_pal)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)


def _factored_chunked(r, k, v, w, u, s0, chunk=8, row_groups=8):
    """The CUDA kernel's order of operations, in numpy f32: per chunk of
    ``chunk`` steps (the last one ragged), the serial loop keeps one partial
    y per row group, y_j = sum_i r_i S_ij over its rows, then updates
    S_ij <- w_i S_ij + k_i v_j; after it, a_t = sum_i r_i u_i k_i for each
    step and y_t = the sum of the row-group partials + a_t v_t."""
    b, t, h, n = r.shape
    rows = n // row_groups
    s = s0.copy()
    y = np.empty_like(r)
    for c0 in range(0, t, chunk):
        steps = range(c0, min(c0 + chunk, t))
        partials = {}
        for ti in steps:
            partials[ti] = [
                np.einsum("bhi,bhij->bhj", r[:, ti, :, g * rows:(g + 1) * rows],
                          s[:, :, g * rows:(g + 1) * rows])
                for g in range(row_groups)
            ]
            s = w[:, ti, :, :, None] * s + k[:, ti, :, :, None] * v[:, ti, :, None, :]
        for ti in steps:
            a = np.einsum("bhn,bhn->bh", r[:, ti], u[None] * k[:, ti])
            acc = partials[ti][0]
            for part in partials[ti][1:]:
                acc = acc + part
            y[:, ti] = acc + a[..., None] * v[:, ti]
    return y, s


@pytest.mark.parametrize(
    "b,t,h,n,w_zeros",
    [
        pytest.param(2, 24, 2, 16, True, id="w-with-zeros"),
        pytest.param(2, 37, 3, 16, False, id="ragged-t37"),
        pytest.param(3, 1, 2, 64, False, id="t1"),
    ],
)
def test_factored_chunked_order_matches_jax(b, t, h, n, w_zeros):
    """The algebra the CUDA kernel relies on (factored update, row-group
    partials of y, chunks with a ragged tail) against JAX's ``wkv6_ref`` and
    its Pallas kernel in interpret mode; ``w_zeros`` draws w over [0, 1)
    with every 5th element 0."""
    r, k, v, w, u, s0 = _inputs(b, t, h, n, seed=9)
    if w_zeros:
        w = np.random.default_rng(9).uniform(0.0, 1.0, w.shape).astype(np.float32)
        w.reshape(-1)[::5] = 0.0
    y, s = _factored_chunked(r, k, v, w, u, s0)
    assert y.dtype == s.dtype == np.float32
    jargs = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    y_ref, s_ref = jax_ops.wkv6_ref(*jargs)
    y_pal, s_pal = jax_ops.wkv6(*jargs, use_kernel=True, interpret=True)
    for want_y, want_s in ((y_ref, s_ref), (y_pal, s_pal)):
        np.testing.assert_allclose(y, np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s, np.asarray(want_s), **TOL)


def test_state_continuation():
    """[0, t1) then [t1, T) with the carried state == one pass."""
    r, k, v, w, u, s0 = _torch(_inputs(2, 40, 2, 16, seed=7))
    y_full, s_full = ops.wkv6(r, k, v, w, u, s0)
    t1 = 15
    y1, s1 = ops.wkv6(r[:, :t1], k[:, :t1], v[:, :t1], w[:, :t1], u, s0)
    y2, s2 = ops.wkv6(r[:, t1:], k[:, t1:], v[:, t1:], w[:, t1:], u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **TOL)


def test_wrapper_takes_plain_path_on_cpu():
    args = _torch(_inputs(1, 5, 2, 16, seed=3))
    before = ops.wkv6.launches
    y, s = ops.wkv6(*args)
    y_ref, s_ref = wkv6_ref(*args)
    assert ops.wkv6.launches == before          # the counter is for kernel launches only
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    assert y.dtype == s.dtype == torch.float32


@pytest.mark.parametrize("bad", ["k_shape", "u_shape", "state_shape", "empty_t", "meta_device"])
def test_wrapper_rejects_malformed_input(bad):
    r, k, v, w, u, s0 = _torch(_inputs(1, 4, 2, 16, seed=4))
    if bad == "k_shape":
        k = k[:, :3]
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "state_shape":
        s0 = s0[..., :8]
    elif bad == "empty_t":
        r, k, v, w = (x[:, :0] for x in (r, k, v, w))
    else:
        r = r.to("meta")
    with pytest.raises(ValueError):
        ops.wkv6(r, k, v, w, u, s0)
