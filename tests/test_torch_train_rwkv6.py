"""The port's training step against the JAX reference on the CPU, for
rwkv6-7b's smoke config: the RWKV-6 time mix (WKV6 through its autograd Function and the plain reverse sweep) and channel mix.

The trajectories, what is compared and the tolerances are those of
``test_torch_train_dense.py``, whose helpers run both sides: the step-1
gradients leaf by leaf against the norm, the 8 losses, and the parameters
after 8 steps of AdamW, in f32 and in bf16 compute.

One tolerance differs: f32 gradients within 1e-3 of each leaf's norm, not
1e-4.  The JAX model takes WKV6's chunked form (cumulative log-decays) where
the port runs the sequential recurrence; the two forwards agree to ~1e-5
(``test_torch_rwkv6_serve.py`` holds them to 1e-4), and the per-head group
norm after WKV6 amplifies that in ``u``'s gradient, which at batch 4 goes
past 1e-4 of its norm while the port's own two paths (its autograd Function
and autograd through its plain recurrence) stay together
(``test_torch_wkv6_grad.py`` holds the reverse sweep itself to 1e-5).
"""

import pytest

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro_torch.configs.registry import get_smoke_config
from test_torch_train_dense import check_trajectories

ARCH = "rwkv6-7b"
F32_GRAD_TOL = 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trajectory_matches_reference(dtype):
    tols = {"grad": F32_GRAD_TOL} if dtype == "float32" else {}
    check_trajectories(get_smoke_config(ARCH), jax_get_smoke_config(ARCH), dtype, **tols)


def test_trajectory_with_two_microbatches():
    check_trajectories(get_smoke_config(ARCH), jax_get_smoke_config(ARCH), "float32", batch=4,
                       microbatches=2, grad=F32_GRAD_TOL)
