"""qwen2.5-32b [dense]: GQA with QKV bias (hf:Qwen/Qwen2.5-0.5B; hf).

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""

from .base import Block, ModelConfig

ARCH_ID = "qwen2.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152_064,
        qkv_bias=True,
        blocks_pattern=(Block("attn", "dense"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        qkv_bias=True,
        blocks_pattern=(Block("attn", "dense"),),
    )
