"""Reduced same-family configs for CPU smoke tests.

Each assigned architecture gets a shrunken sibling — same family, block
structure, and code paths; small widths, few layers/experts, tiny vocab —
so one forward step runs on CPU in seconds.  A copy of
`repro.configs.reduced`; in the port the full configs run on the GPU.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

from . import get_config


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv > 1 else 1,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        attn_block_q=64, attn_block_kv=64,
        remat="none", fsdp=False, train_microbatches=1,
        # f32 so cached-vs-direct formulations must agree to fp precision
        # (bf16 numerics are exercised by the kernel test sweeps)
        param_dtype="float32", compute_dtype="float32",
    )
    if cfg.moe:
        # capacity_factor high enough that smoke tests never drop tokens
        # (dropping makes prefill/forward outputs differ by construction)
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=64, capacity_factor=4.0,
            d_first_dense=256 if cfg.moe.first_dense else 0)
    if cfg.mla:
        kw["mla"] = dataclasses.replace(
            cfg.mla, kv_lora=64, q_lora=96, d_nope=32, d_rope=16, d_v=32)
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, d_head=32,
                                        chunk=32)
        kw["attn_every"] = 2
        kw["n_layers"] = 4
    if cfg.xlstm:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_every=2)
    if cfg.is_encdec:
        kw["n_enc_layers"] = 2
        kw["enc_len"] = 32
    if cfg.n_patches:
        kw["n_patches"] = 8
    return cfg.with_(**kw)


def reduced(name: str) -> ModelConfig:
    return reduce_config(get_config(name))
