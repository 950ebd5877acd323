"""deepseek-v3-671b [moe]: MLA + 1 shared + 256 routed top-8
(arXiv:2412.19437; hf).

61L d_model=7168 128H d_expert=2048 vocab=129280.  First 3 layers dense
(d_ff 18432) per the DeepSeek-V3 architecture; the MTP head is out of scope
(noted in DESIGN.md).
"""

from .base import Block, MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,                       # dense layers' hidden dim
        vocab_size=129_280,
        blocks_prefix=(Block("mla", "dense"),) * 3,
        blocks_pattern=(Block("mla", "moe"),),
        moe=MoEConfig(
            n_experts=256, top_k=8, d_expert=2048, n_shared=1, d_shared=2048,
            capacity_factor=1.25,
        ),
        mla=MLAConfig(
            q_lora_rank=1536, kv_lora_rank=512,
            qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        ),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        blocks_prefix=(Block("mla", "dense"),),
        blocks_pattern=(Block("mla", "moe"),),
        # high capacity factor: no token drops -> decode/full-forward parity
        # is exactly testable (drops are a capacity artifact, not semantics)
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1, d_shared=32,
                      capacity_factor=8.0),
        mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        ),
    )
