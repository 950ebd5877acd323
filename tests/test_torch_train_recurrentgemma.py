"""The port's training step against the JAX reference on the CPU, for
recurrentgemma-9b's smoke config: two RG-LRU blocks (the scan through its autograd Function and the plain reverse scan) and a local-attention block.

The trajectories, what is compared and the tolerances are those of
``test_torch_train_dense.py``, whose helpers run both sides: the step-1
gradients leaf by leaf against the norm, the 8 losses, and the parameters
after 8 steps of AdamW, in f32 and in bf16 compute.
"""

import pytest

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro_torch.configs.registry import get_smoke_config
from test_torch_train_dense import check_trajectories

ARCH = "recurrentgemma-9b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trajectory_matches_reference(dtype):
    check_trajectories(get_smoke_config(ARCH), jax_get_smoke_config(ARCH), dtype)


def test_trajectory_with_two_microbatches():
    check_trajectories(get_smoke_config(ARCH), jax_get_smoke_config(ARCH), "float32", batch=4,
                       microbatches=2)
