"""granite-34b [dense] — llama-arch MQA (kv=1), code model [arXiv:2405.04324; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, d_ff=24576, vocab=49152,
    fsdp=True, remat="full", train_microbatches=16,
)
