"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv=4, d_ff=11008, vocab=64000,
    rope_theta=5_000_000.0,
    fsdp=True, remat="full", train_microbatches=8,
)
