"""rwkv6-7b [ssm]: Finch, data-dependent decay, attention-free
(arXiv:2404.05892; hf).

32L d_model=4096 d_ff=14336 vocab=65536.
"""

from .base import Block, ModelConfig

ARCH_ID = "rwkv6-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,            # d_model / rwkv_head_dim
        n_kv_heads=64,
        d_ff=14336,
        vocab_size=65_536,
        rwkv_head_dim=64,
        blocks_pattern=(Block("rwkv", "rwkv_cmix"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        rwkv_head_dim=16,
        blocks_pattern=(Block("rwkv", "rwkv_cmix"),),
    )
