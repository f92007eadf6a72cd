"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf]."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv=128, d_ff=1536,
    vocab=102400, d_head=128,
    mla=MLAConfig(kv_lora=512, q_lora=1536, d_nope=128, d_rope=64, d_v=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_dense=1, d_first_dense=12288, token_chunk=8192),
    fsdp=True, remat="full", train_microbatches=8,
)
