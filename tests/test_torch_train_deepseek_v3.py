"""The port's training step against the JAX reference on the CPU, for
deepseek-v3-671b's smoke config: MLA (its autograd backward), a dense
block, then MoE blocks with a shared expert (dense dispatch, capacity
factor 8.0 at this size).

The trajectories, what is compared and the tolerances are those of
``test_torch_train_dense.py``, whose helpers run both sides: the step-1
gradients leaf by leaf against the norm, the 8 losses, and the parameters
after 8 steps of AdamW, in f32 and in bf16 compute.

Routing is discrete.  In bf16 the two frameworks round the hidden state at
other places, so a token whose top-2 choice is a near tie can pick another
expert on each side, and one token of the 32 moves an expert's gradient by
up to 20% of its norm (in the smoke config at seed 0, against a gate of
10%).  So bf16 also runs on a copy of the config whose tokens each take
all 8 experts (top_k = n_experts): no choice is left to rounding, and the
router, the gates, the dispatch and combine, the shared expert and MLA are
all still on the gradient's path.  f32 runs the smoke config as it is, where
no choice flips.  Also: ``train()``
refuses the models that read frames or an image context, which the
synthetic pipeline (the reference's ``SyntheticLM``) cannot feed.
"""

import dataclasses

import pytest

from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as train_mod
from repro_torch.train.train_step import TrainConfig
from test_torch_train_dense import check_trajectories

ARCH = "deepseek-v3-671b"


def every_expert(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.n_experts))


def test_trajectory_matches_reference_f32():
    check_trajectories(get_smoke_config(ARCH), jax_get_smoke_config(ARCH), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trajectory_with_every_expert_matches_reference(dtype):
    check_trajectories(every_expert(get_smoke_config(ARCH)),
                       every_expert(jax_get_smoke_config(ARCH)), dtype)


@pytest.mark.parametrize("arch, what", [("hubert-xlarge", "frames"),
                                        ("llama-3.2-vision-90b", "an image context")])
def test_train_refuses_frames_and_image_models(arch, what):
    cfg = get_smoke_config(arch)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(NotImplementedError, match=f"reads {what}.*tokens only"):
        train_mod.train(cfg, TrainConfig(), data, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="tokens only"):
        train_mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1"])
