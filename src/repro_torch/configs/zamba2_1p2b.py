"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32, d_ff=8192, vocab=32000,
    ssm=SSMConfig(d_state=64, expand=2, d_head=64, chunk=256),
    attn_every=6,
    remat="full", train_microbatches=4,
)
