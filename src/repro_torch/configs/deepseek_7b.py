"""deepseek-7b [dense]: llama-arch (arXiv:2401.02954; hf).

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.
"""

from .base import Block, ModelConfig

ARCH_ID = "deepseek-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=30,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=102_400,
        blocks_pattern=(Block("attn", "dense"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        blocks_pattern=(Block("attn", "dense"),),
    )
