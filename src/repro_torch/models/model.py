"""Dense decoder LM: init / forward / prefill / decode.

The port's counterpart of the dense branch of `repro.models.model`:
[GQA attention + SwiGLU] blocks with pre-RMSNorm, per-layer params stacked
on axis 0 under the reference's keys, and a Python loop over layers in place
of `lax.scan`.  The KV cache is a pair of stacked (L, B, S, K, Dh) tensors;
`decode_step` writes each layer's new row into it in place.

Other families raise `NotImplementedError` naming the ROADMAP item (queue 1)
that ports them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .config import ModelConfig, torch_dtype
from .layers import (embed, gqa_fwd, init_embedding, init_gqa, init_rmsnorm,
                     init_swiglu, rmsnorm, swiglu_fwd, unembed)

Params = Dict[str, Any]


def check_family(cfg: ModelConfig) -> None:
    """Raise unless cfg is a dense GQA model, the family this port serves."""
    if cfg.moe or cfg.family == "moe":
        item = "MoE"
    elif cfg.mla:
        item = "MLA"
    elif cfg.family in ("ssm", "hybrid"):
        item = "recurrent families"
    elif cfg.family in ("vlm", "audio"):
        item = "VLM and audio"
    else:
        return
    raise NotImplementedError(f"{cfg.name} ({cfg.family}) is not ported yet: "
                              f"ROADMAP queue 1, {item}")


def _layer(stacked: Params, i: int) -> Params:
    """Layer i's params, as views into the (L, ...) stacks."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ============================================================== block
def _block_fwd(p: Params, x, cfg: ModelConfig, *, positions, cache=None,
               cache_index=None, causal=True, return_kv=False):
    h, new_cache = gqa_fwd(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                           positions=positions, cache=cache,
                           cache_index=cache_index, causal=causal,
                           return_kv=return_kv)
    x = x + h
    h = swiglu_fwd(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                   cfg.compute_dtype)
    return x + h, new_cache


# ================================================================== init
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random params from a seeded `torch.Generator` on `device`, with the
    reference's keys and shapes.  The numbers differ from `jax.random`'s;
    tests carry JAX params over with `convert.from_jax_params`."""
    check_family(cfg)
    device = torch.device(device)
    gen = None  # the meta device has no generator: shapes only
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    L, d = cfg.n_layers, cfg.d_model
    return {
        "embed": init_embedding(gen, cfg),
        "ln_f": init_rmsnorm(d, dt, device),
        "layers": {
            "ln1": init_rmsnorm(d, dt, device, lead=(L,)),
            "ln2": init_rmsnorm(d, dt, device, lead=(L,)),
            "attn": init_gqa(gen, cfg, lead=(L,)),
            "ffn": init_swiglu(gen, d, cfg.d_ff, dt, lead=(L,)),
        },
    }


def _positions(B: int, start: int, S: int, device) -> torch.Tensor:
    return torch.arange(start, start + S, device=device)[None].expand(B, S)


# ============================================================ forward
def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab)."""
    check_family(cfg)
    x = embed(params["embed"], tokens, cfg)
    positions = _positions(tokens.shape[0], 0, tokens.shape[1], tokens.device)
    for i in range(cfg.n_layers):
        x, _ = _block_fwd(_layer(params["layers"], i), x, cfg, positions=positions)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg)


# ======================================================== caches + decode step
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zero-filled cache {"layers": (k, v)}, each (L, B, max_seq, K, Dh)."""
    check_family(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.d_head)
    ct = torch_dtype(cfg.compute_dtype)
    return {"layers": (torch.zeros(shape, dtype=ct, device=device),
                       torch.zeros(shape, dtype=ct, device=device))}


def decode_step(params: Params, cache, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One token for every sequence.  tokens: (B, 1); pos: the cache index
    it is written at.  Updates cache in place; returns (logits (B, V), cache)."""
    check_family(cfg)
    x = embed(params["embed"], tokens, cfg)
    positions = _positions(x.shape[0], pos, 1, x.device)
    ck, cv = cache["layers"]
    for i in range(cfg.n_layers):
        x, _ = _block_fwd(_layer(params["layers"], i), x, cfg, positions=positions,
                          cache=(ck[i], cv[i]), cache_index=pos)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x[:, 0], cfg)[..., :cfg.vocab]
    return logits, cache


# ---------------------------------------------------------------- prefill
def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """Process a full prompt; returns (last-token logits (B, V), cache) with
    the cache {"layers": (k, v)} of shape (L, B, S, K, Dh)."""
    check_family(cfg)
    x = embed(params["embed"], tokens, cfg)
    positions = _positions(tokens.shape[0], 0, tokens.shape[1], tokens.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _block_fwd(_layer(params["layers"], i), x, cfg,
                               positions=positions, return_kv=True)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = unembed(params["embed"], x[:, 0], cfg)[..., :cfg.vocab]
    return logits, {"layers": (torch.stack(ks), torch.stack(vs))}
