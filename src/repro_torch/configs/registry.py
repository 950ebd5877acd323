"""Architecture registry: ``--arch <id>`` resolution for the port's entry
points.  It holds the reference's ten architectures."""

from __future__ import annotations

from . import (
    deepseek_7b,
    deepseek_coder_33b,
    deepseek_v3_671b,
    granite_moe_3b,
    hubert_xlarge,
    llama32_vision_90b,
    minitron_8b,
    qwen2_5_32b,
    recurrentgemma_9b,
    rwkv6_7b,
)
from .base import ModelConfig, ShapeSpec, applicable_shapes

_MODULES = {
    m.ARCH_ID: m
    for m in (
        rwkv6_7b,
        recurrentgemma_9b,
        minitron_8b,
        deepseek_7b,
        qwen2_5_32b,
        deepseek_coder_33b,
        granite_moe_3b,
        deepseek_v3_671b,
        llama32_vision_90b,
        hubert_xlarge,
    )
}

ARCHS: tuple[str, ...] = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def cells(archs: tuple[str, ...] = ARCHS) -> list[tuple[str, ShapeSpec]]:
    """Every (arch, shape) cell the dry-run covers, after
    :func:`~.base.applicable_shapes`' skips."""
    return [(a, s) for a in archs for s in applicable_shapes(get_config(a))]
