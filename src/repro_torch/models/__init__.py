"""Model substrate: configs, layers, and the dense LM assembly."""
from .config import (SHAPES, SHAPES_BY_NAME, MLAConfig, ModelConfig,
                     MoEConfig, ShapeSpec, SSMConfig, XLSTMConfig,
                     applicable_shapes, torch_dtype)
from .convert import from_jax_params
from .model import decode_step, forward, init_cache, init_params, prefill

__all__ = [
    "SHAPES", "SHAPES_BY_NAME", "MLAConfig", "ModelConfig", "MoEConfig",
    "ShapeSpec", "SSMConfig", "XLSTMConfig", "applicable_shapes",
    "torch_dtype", "from_jax_params", "decode_step", "forward", "init_cache",
    "init_params", "prefill",
]
