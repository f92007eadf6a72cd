"""Model substrate: configs, layers (GQA and MLA attention), Mamba-2,
xLSTM, MoE, and the dense, MoE, xLSTM and hybrid LM assembly."""
from .config import (SHAPES, SHAPES_BY_NAME, MLAConfig, ModelConfig,
                     MoEConfig, ShapeSpec, SSMConfig, XLSTMConfig,
                     applicable_shapes, torch_dtype)
from .convert import from_jax_params
from .dist import get_mesh, set_mesh
from .model import (TrainBatch, decode_step, forward, init_cache, init_params,
                    loss_fn, prefill)

__all__ = [
    "SHAPES", "SHAPES_BY_NAME", "MLAConfig", "ModelConfig", "MoEConfig",
    "ShapeSpec", "SSMConfig", "XLSTMConfig", "applicable_shapes",
    "torch_dtype", "from_jax_params", "TrainBatch", "decode_step", "forward",
    "init_cache", "init_params", "loss_fn", "prefill", "get_mesh", "set_mesh",
]
