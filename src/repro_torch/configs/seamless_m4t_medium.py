"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].
input_specs() provides precomputed audio-frame embeddings (stub frontend)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv=16, d_ff=4096, vocab=256206,
    n_enc_layers=12, enc_len=1024,
    remat="full", train_microbatches=2,
)
