"""Model and shape configurations (the port's own copy of ``repro.configs``)."""

from .base import SHAPES, ModelConfig, ShapeSpec, applicable_shapes
from .registry import ARCHS, cells, get_config, get_smoke_config

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "applicable_shapes", "cells",
           "get_config", "get_smoke_config"]
