"""The port's RG-LRU scan against the JAX package's: the plain recurrence
(``repro_torch.kernels.rglru_scan.ref``) against JAX ``rglru_scan_ref`` and
the Pallas kernel in interpret mode, state continuation and the wrapper's
checks.  ``test_torch_rglru_scan_gpu.py`` holds the CUDA kernel against the
plain version on the card.

Inputs are numpy arrays from a seed, handed to both sides.  f32 throughout:
rtol = atol = 1e-5 (both sides sweep the same sequential recurrence; the
JAX side may contract a * h + b into one FMA where the port rounds twice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan import ops as jax_ops
from repro_torch.kernels.rglru_scan import ops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, d, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.uniform(0.5, 0.999, (b, t, d)).astype(f),
        rng.normal(0, 0.5, (b, t, d)).astype(f),
        rng.normal(0, 1, (b, d)).astype(f),
    )


def _torch(args):
    return tuple(torch.from_numpy(a) for a in args)


# T not a multiple of the Pallas time chunk (256), D not a multiple of its
# channel block (512)
@pytest.mark.parametrize("b,t,d", [(2, 300, 96), (1, 37, 100), (3, 64, 64)])
def test_plain_matches_jax_ref_and_interpret_kernel(b, t, d):
    args = _inputs(b, t, d, seed=5)
    h, h_last = rglru_scan_ref(*_torch(args))
    jargs = [jnp.asarray(a) for a in args]
    for want_h, want_last in (jax_ops.rglru_scan_ref(*jargs),
                              jax_ops.rglru_scan(*jargs, use_kernel=True, interpret=True)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last), **TOL)


def test_state_continuation():
    """[0, t1) then [t1, T) with the carried state == one pass."""
    a, b, h0 = _torch(_inputs(2, 50, 40, seed=7))
    h_full, last_full = ops.rglru_scan(a, b, h0)
    t1 = 19
    h1, last1 = ops.rglru_scan(a[:, :t1], b[:, :t1], h0)
    h2, last2 = ops.rglru_scan(a[:, t1:], b[:, t1:], last1)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), h_full.numpy(), **TOL)
    np.testing.assert_allclose(last2.numpy(), last_full.numpy(), **TOL)


def test_wrapper_takes_plain_path_on_cpu():
    args = _torch(_inputs(2, 5, 24, seed=3))
    before = ops.rglru_scan.launches
    h, h_last = ops.rglru_scan(*args)
    h_ref, last_ref = rglru_scan_ref(*args)
    assert ops.rglru_scan.launches == before       # the counter is for kernel launches only
    assert torch.equal(h, h_ref) and torch.equal(h_last, last_ref)
    assert h.dtype == h_last.dtype == torch.float32


@pytest.mark.parametrize("bad", ["b_shape", "h0_shape", "empty_t", "meta_device"])
def test_wrapper_rejects_malformed_input(bad):
    a, b, h0 = _torch(_inputs(2, 4, 16, seed=4))
    if bad == "b_shape":
        b = b[:, :3]
    elif bad == "h0_shape":
        h0 = h0[:1]
    elif bad == "empty_t":
        a, b = a[:, :0], b[:, :0]
    else:
        a = a.to("meta")
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b, h0)
