"""minitron-8b [dense]: pruned Nemotron (arXiv:2407.14679; hf).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""

from .base import Block, ModelConfig

ARCH_ID = "minitron-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256_000,
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
        d_ff=128,
        vocab_size=512,
        blocks_pattern=(Block("attn", "dense"),),
    )
