"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 pattern
(arXiv:2402.19427; unverified).

38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000,
local attention window 2048.
"""

from .base import Block, ModelConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab_size=256_000,
        local_window=2048,
        rglru_lru_width=4096,
        blocks_pattern=(
            Block("rglru", "dense"),
            Block("rglru", "dense"),
            Block("attn_local", "dense"),
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        local_window=32,
        rglru_lru_width=64,
        blocks_pattern=(
            Block("rglru", "dense"),
            Block("rglru", "dense"),
            Block("attn_local", "dense"),
        ),
    )
