"""granite-moe-3b-a800m [moe]: 40 experts top-8
(hf:ibm-granite/granite-3.0-1b-a400m-base; hf).

32L d_model=1536 24H (GQA kv=8) d_expert=512 vocab=49155.
"""

from .base import Block, ModelConfig, MoEConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49_155,
        blocks_pattern=(Block("attn", "moe"),),
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, capacity_factor=1.25),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        blocks_pattern=(Block("attn", "moe"),),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0),
        tie_embeddings=True,
    )
