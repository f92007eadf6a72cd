"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]."""
from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    xlstm=XLSTMConfig(slstm_every=6),
    tie_embeddings=True,
    remat="full", train_microbatches=4, fsdp=True,
)
