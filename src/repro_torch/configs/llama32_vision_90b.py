"""llama-3.2-vision-90b [vlm]: cross-attn image layers
(hf:meta-llama/Llama-3.2-11B-Vision; unverified).

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer
cross-attends to stub image-token embeddings (the vision tower is a STUB per
the assignment: ``input_specs()`` supplies precomputed patch embeddings).
"""

from .base import Block, ModelConfig

ARCH_ID = "llama-3.2-vision-90b"

N_IMG_TOKENS = 1601  # (448/14)^2 patches + CLS, one tile


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128_256,
        n_img_tokens=N_IMG_TOKENS,
        blocks_pattern=(
            Block("attn", "dense"),
            Block("attn", "dense"),
            Block("attn", "dense"),
            Block("attn", "dense"),
            Block("attn_cross", "dense"),
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        n_img_tokens=16,
        blocks_pattern=(
            Block("attn", "dense"),
            Block("attn", "dense"),
            Block("attn", "dense"),
            Block("attn", "dense"),
            Block("attn_cross", "dense"),
        ),
    )
