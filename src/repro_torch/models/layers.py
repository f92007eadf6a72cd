"""Shared dense-LM layers: norms, rotary embeddings, GQA attention, SwiGLU.

The port's counterpart of `repro.models.layers`, with the same parameter
dictionaries and layouts (`wq` is (d, H, Dh), `wo` is (H, Dh, d)), so JAX
params load with no transposes.  `init_*` builds a param dict from a seeded
`torch.Generator`; `*_fwd` applies it.  `lead` prepends stacking dims, e.g.
(L,) for the model's per-layer stacks.  MLA and cross-attention come with
their slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .config import ModelConfig, torch_dtype

Params = Dict[str, torch.Tensor]


def _init(gen: Optional[torch.Generator], shape, scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """Scaled normal init on gen's device; gen None gives shapes only, on
    the meta device."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device if gen is not None else "meta")
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype: torch.dtype, device, lead=()) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * p["scale"].float()).to(dt)


# ----------------------------------------------------------------------- rope
def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                        device=device) / d_rot)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the first `fraction` of head dims (interleaved
    pairs).  x: (..., S, H, D); positions: (..., S) broadcastable."""
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)            # (d_rot/2,)
    ang = positions[..., None].float() * freqs            # (..., S, d_rot/2)
    ang = ang[..., None, :]                               # head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., 0::2].float(), xr[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = out.reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if d_rot < d else out


# ------------------------------------------------------------------ embedding
def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    v = cfg.padded_vocab
    p = {"tok": _init(gen, (v, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = _init(gen, (v, cfg.d_model), cfg.d_model ** -0.5, dt)
    return p


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"].to(torch_dtype(cfg.compute_dtype))[tokens]


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p.get("unembed", p["tok"]).to(torch_dtype(cfg.compute_dtype))
    return x @ w.T


# -------------------------------------------------------------- GQA attention
def init_gqa(gen: torch.Generator, cfg: ModelConfig, lead=()) -> Params:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    dt = torch_dtype(cfg.param_dtype)
    s = d ** -0.5
    return {
        "wq": _init(gen, (*lead, d, H, Dh), s, dt),
        "wk": _init(gen, (*lead, d, K, Dh), s, dt),
        "wv": _init(gen, (*lead, d, K, Dh), s, dt),
        "wo": _init(gen, (*lead, H, Dh, d), (H * Dh) ** -0.5, dt),
    }


def gqa_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            positions: torch.Tensor,
            cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            cache_index: Optional[int] = None,
            causal: bool = True, return_kv: bool = False):
    """GQA/MQA self-attention.  Modes:
       * train/prefill: cache is None, full self-attention over x; with
         return_kv the new (k, v) come back as the cache content.
       * decode: cache=(k, v), each (B, S, K, Dh); the new k/v are written
         in place at cache_index and attention runs over the valid prefix.
    Returns (out, cache or None).
    """
    ct = torch_dtype(cfg.compute_dtype)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ct))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(ct))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(ct))
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if cache is None:
        out = kops.attention(q, k, v, causal=causal, block_q=cfg.attn_block_q,
                             block_kv=cfg.attn_block_kv)
        new_cache = (k, v) if return_kv else None
    else:
        ck, cv = cache
        end = cache_index + x.shape[1]
        if end > ck.shape[1]:
            raise ValueError(f"cache of length {ck.shape[1]} cannot take "
                             f"positions up to {end}")
        ck[:, cache_index:end] = k
        cv[:, cache_index:end] = v
        out = kops.attention(q, ck, cv, causal=False, kv_valid_len=end,
                             block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
        new_cache = (ck, cv)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(ct))
    return out, new_cache


# ---------------------------------------------------------------- dense FFN
def init_swiglu(gen: torch.Generator, d: int, d_ff: int, dtype: torch.dtype,
                lead=()) -> Params:
    return {
        "w_gate": _init(gen, (*lead, d, d_ff), d ** -0.5, dtype),
        "w_up": _init(gen, (*lead, d, d_ff), d ** -0.5, dtype),
        "w_down": _init(gen, (*lead, d_ff, d), d_ff ** -0.5, dtype),
    }


def swiglu_fwd(p: Params, x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    ct = torch_dtype(compute_dtype)
    g = x @ p["w_gate"].to(ct)
    u = x @ p["w_up"].to(ct)
    return (F.silu(g) * u) @ p["w_down"].to(ct)
