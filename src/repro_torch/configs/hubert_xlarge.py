"""hubert-xlarge [audio]: encoder-only transformer backbone
(arXiv:2106.07447; unverified).

48L d_model=1280 16H d_ff=5120 vocab=504 (codebook targets).  The conv
waveform frontend is a STUB per the assignment: ``input_specs()`` supplies
precomputed frame embeddings.  Encoder-only -> no decode shapes.
"""

from .base import Block, ModelConfig

ARCH_ID = "hubert-xlarge"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        frontend="frames",
        blocks_pattern=(Block("attn", "dense"),),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=64,
        causal=False,
        frontend="frames",
        blocks_pattern=(Block("attn", "dense"),),
    )
