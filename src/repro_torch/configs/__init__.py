from .base import SHAPES, InputShape, LayerSpec, ModelConfig, reduced
from .registry import ARCHS, get_config

__all__ = ["SHAPES", "InputShape", "LayerSpec", "ModelConfig", "reduced",
           "ARCHS", "get_config"]
