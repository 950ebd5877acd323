"""deepseek-coder-33b [dense]: llama-arch (arXiv:2401.14196; hf).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""

from .base import Block, ModelConfig

ARCH_ID = "deepseek-coder-33b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32_256,
        blocks_pattern=(Block("attn", "dense"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=3,
        d_model=56,          # 4 heads of 14: a head dim that is no power of two
        n_heads=4,
        n_kv_heads=2,
        d_ff=112,
        vocab_size=512,
        blocks_pattern=(Block("attn", "dense"),),
    )
