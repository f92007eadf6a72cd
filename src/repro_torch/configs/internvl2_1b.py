"""internvl2-1b [vlm] — InternViT (stub frontend) + InternLM2/Qwen2 backbone
[arXiv:2404.16821; hf].  input_specs() provides precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864, vocab=151655,
    n_patches=256, rope_theta=1_000_000.0,
    remat="full", train_microbatches=8, fsdp=True,
)
