"""Model / shape configuration dataclasses (the port's own copy of
``repro.configs.base``)."""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["MoEConfig", "MLAConfig", "Block", "ModelConfig", "ShapeSpec", "SHAPES",
           "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0             # shared-expert hidden dim (0 -> d_expert)
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    @property
    def shared_hidden(self) -> int:
        return self.d_shared or self.d_expert


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dimensions."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


# mixer:  attn | attn_local | attn_cross | mla | rwkv | rglru
# ffn:    dense | moe | rwkv_cmix | none
@dataclasses.dataclass(frozen=True)
class Block:
    mixer: str = "attn"
    ffn: str = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | ssm | moe | audio | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    causal: bool = True           # False for encoder-only (hubert)
    blocks_prefix: tuple[Block, ...] = ()
    blocks_pattern: tuple[Block, ...] = (Block(),)
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    local_window: int = 0
    n_img_tokens: int = 0         # vlm: image-context length of the cross blocks
    frontend: Literal["token", "frames", "patches"] = "token"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    rwkv_head_dim: int = 64
    rglru_conv_width: int = 4
    rglru_lru_width: int = 0      # 0 -> d_model
    # training: recompute each block's activations in the backward
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def block_list(self) -> tuple[Block, ...]:
        """The full, explicit per-layer block sequence."""
        blocks = list(self.blocks_prefix)
        pat = self.blocks_pattern
        while len(blocks) < self.n_layers:
            blocks.extend(pat)
        return tuple(blocks[: self.n_layers])

    def scan_partition(self) -> tuple[tuple[Block, ...], int, tuple[Block, ...], tuple[Block, ...]]:
        """Partition layers into (prefix, n_scan_superblocks, pattern, suffix),
        as the JAX package stacks them; the converter uses it to unstack."""
        pre = self.blocks_prefix
        rest = self.n_layers - len(pre)
        p = len(self.blocks_pattern)
        n_scan = rest // p
        suffix = self.blocks_pattern[: rest % p]
        return pre, n_scan, self.blocks_pattern, suffix

    @property
    def is_attention_free(self) -> bool:
        mixers = {b.mixer for b in self.block_list()}
        return mixers <= {"rwkv", "rglru"}

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing: SSM / hybrid / windowed-only attn."""
        mixers = {b.mixer for b in self.block_list()}
        quadratic = {"attn", "mla", "attn_cross"}
        return not (mixers & quadratic)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[ShapeSpec]:
    """The shape cells this architecture runs: an encoder has no decode,
    and only a model without quadratic attention decodes at 500k."""
    out = []
    for s in SHAPES.values():
        if s.kind == "decode" and cfg.is_encoder_only:
            continue
        if s.name == "long_500k" and not cfg.supports_long_context:
            continue
        out.append(s)
    return out
