"""Shared dense-LM layers: norms, rotary embeddings, GQA attention, SwiGLU.

The port's counterpart of `repro.models.layers`, with the same parameter
dictionaries and layouts (`wq` is (d, H, Dh), `wo` is (H, Dh, d)), so JAX
params load with no transposes.  `init_*` builds a param dict from a seeded
`torch.Generator`; `*_fwd` applies it.  `lead` prepends stacking dims, e.g.
(L,) for the model's per-layer stacks.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from . import dist
from .config import SLICE_ELEMS, ModelConfig, torch_dtype

Params = Dict[str, torch.Tensor]


def _init(gen: Optional[torch.Generator], shape, scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """Scaled normal init on gen's device; gen None gives shapes only, on
    the meta device.  The leaf is drawn in f32 and scaled in place a block
    of leading-axis slices at a time, each block of at most SLICE_ELEMS
    elements (at least one slice), straight into `dtype`: so at most one
    block's f32 copy lives (drawn whole, an f32 copy of 7 layers of
    deepseek-v2's w1, 8.81e9 elements, could not sit beside a full-width
    model's weights).  A leaf of SLICE_ELEMS or fewer is one block."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, SLICE_ELEMS // max(1, math.prod(shape[1:])))
    for i in range(0, shape[0], rows):
        x = torch.randn((min(rows, shape[0] - i), *shape[1:]), generator=gen,
                        dtype=torch.float32, device=gen.device)
        out[i:i + rows] = x.mul_(scale)
        del x  # before the next block is drawn
    return out


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
    cos, sin = (dist.replicated(t, x) for t in (torch.cos(ang), torch.sin(ang)))
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
    w = dist.unshard_dp(p["tok"]).to(torch_dtype(cfg.compute_dtype))
    # an embedding op, whose DTensor rules cover its backward (those of
    # indexing, an index_put, fail in torch 2.11); under a mesh the lookup
    # in a vocab-sharded table is a masked partial sum, reduced here once
    return dist.constrain_batch(F.embedding(tokens, w))


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = dist.unshard_dp(p.get("unembed", p["tok"])).to(torch_dtype(cfg.compute_dtype))
    return x @ w.T


# -------------------------------------------------------------- GQA attention
def init_gqa(gen: torch.Generator, cfg: ModelConfig, lead=()) -> Params:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    dt = torch_dtype(cfg.param_dtype)
    s = d ** -0.5
    p = {
        "wq": _init(gen, (*lead, d, H, Dh), s, dt),
        "wk": _init(gen, (*lead, d, K, Dh), s, dt),
        "wv": _init(gen, (*lead, d, K, Dh), s, dt),
        "wo": _init(gen, (*lead, H, Dh, d), (H * Dh) ** -0.5, dt),
    }
    if cfg.qk_norm:   # RMSNorm scales over the flat projections, drawing nothing
        device = "meta" if gen is None else gen.device
        p["q_norm"] = torch.ones((*lead, H * Dh), dtype=dt, device=device)
        p["k_norm"] = torch.ones((*lead, K * Dh), dtype=dt, device=device)
    return p


def _qk_normed(t: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """QK-norm: `rmsnorm` of t (B, S, H, Dh) over its flat H * Dh."""
    flat = rmsnorm({"scale": scale}, t.reshape(*t.shape[:2], -1), eps)
    return flat.reshape(t.shape)


def gqa_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            positions: torch.Tensor,
            cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            cache_index: Optional[int] = None,
            kv_source: Optional[torch.Tensor] = None,
            causal: bool = True, return_kv: bool = False):
    """GQA/MQA attention.  Modes:
       * train/prefill: cache is None, full self-attention over x; with
         return_kv the new (k, v) come back as the cache content.
       * cross: kv_source (B, Skv, d) given (the encoder's memory): k and v
         are projected from it, with no RoPE on q or k, and every query
         sees every row (plain torch, as the reference's is jnp).
       * decode: cache=(k, v), each (B, S, K, Dh); the new k/v are written
         in place at min(cache_index, S - Sq), as JAX's
         dynamic_update_slice clamps, and attention runs over the first
         min(cache_index + Sq, S) rows.
    With cfg.qk_norm, q and k are normed over their flat projections before
    any RoPE, in every mode (so decode caches the normed k).
    Returns (out, cache or None).
    """
    ct = torch_dtype(cfg.compute_dtype)
    q = dist.constrain_heads(torch.einsum("bsd,dhk->bshk", x, p["wq"].to(ct)))
    src = x if kv_source is None else kv_source
    k = dist.constrain_heads(torch.einsum("bsd,dhk->bshk", src, p["wk"].to(ct)))
    v = dist.constrain_heads(torch.einsum("bsd,dhk->bshk", src, p["wv"].to(ct)))
    if cfg.qk_norm:
        q = _qk_normed(q, p["q_norm"], cfg.norm_eps)
        k = _qk_normed(k, p["k_norm"], cfg.norm_eps)
    if kv_source is not None:
        out = dist.local_heads(lambda q, k, v: kops.attention(
            q, k, v, causal=False, block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv),
            q, k, v)
        return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(ct)), None
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    if cache is None:
        out = dist.local_heads(lambda q, k, v: kops.attention(
            q, k, v, causal=causal, block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv),
            q, k, v)
        new_cache = (k, v) if return_kv else None
    else:
        # the reference's dynamic_update_slice: a write past the end of the
        # cache is clamped to its last Sq rows, and every row stays valid
        ck, cv = cache
        Sq, Skv = x.shape[1], ck.shape[1]
        start = min(cache_index, Skv - Sq)
        ck[:, start:start + Sq] = k
        cv[:, start:start + Sq] = v
        out = dist.local_heads(lambda q, k, v: kops.attention(
            q, k, v, causal=False, kv_valid_len=min(cache_index + Sq, Skv),
            block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv), q, ck, cv)
        new_cache = (ck, cv)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(ct))
    return out, new_cache


# -------------------------------------------------------------- MLA attention
def init_mla(gen: torch.Generator, cfg: ModelConfig, lead=()) -> Params:
    """Multi-head latent attention's projections, in the reference's draw
    order: wq_a (d, q_lora), wq_b (q_lora, H, d_nope + d_rope), wkv_a (d,
    kv_lora), wk_rope (d, d_rope), wkv_b (kv_lora, H, d_nope + d_v), wo
    (H, d_v, d)."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    dt = torch_dtype(cfg.param_dtype)
    return {
        "wq_a": _init(gen, (*lead, d, m.q_lora), d ** -0.5, dt),
        "wq_b": _init(gen, (*lead, m.q_lora, H, m.d_nope + m.d_rope),
                      m.q_lora ** -0.5, dt),
        "wkv_a": _init(gen, (*lead, d, m.kv_lora), d ** -0.5, dt),
        "wk_rope": _init(gen, (*lead, d, m.d_rope), d ** -0.5, dt),
        "wkv_b": _init(gen, (*lead, m.kv_lora, H, m.d_nope + m.d_v),
                       m.kv_lora ** -0.5, dt),
        "wo": _init(gen, (*lead, H, m.d_v, d), (H * m.d_v) ** -0.5, dt),
    }


def mla_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
            positions: torch.Tensor,
            cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            cache_index: Optional[int] = None,
            causal: bool = True, return_kv: bool = False):
    """Multi-head latent attention (DeepSeek-V2).  Modes:
       * train/prefill: cache is None; the direct form, k = [c_kv @ wkv_b's
         nope half, k_rope on every head], v from wkv_b's other half, through
         `kops.attention` (flash_attention's Dv != D instance on the card,
         its plain version on the CPU); with
         return_kv the latents (c_kv (B, S, kv_lora), k_rope (B, S, d_rope))
         come back as the cache content.
       * decode: cache=(c_kv, k_rope); the new rows are written in place at
         min(cache_index, S - Sq) of each leaf, as JAX's dynamic_update_slice
         clamps, then the reference's absorbed form in f32: wkv_b folded into
         the query and the output, scores over the whole cache masked by
         t <= cache_index + i.
    RoPE takes no `rope_fraction` here, as in the reference.  Returns (out,
    cache or None).
    """
    m = cfg.mla
    ct = torch_dtype(cfg.compute_dtype)
    q = torch.einsum("bsd,dq->bsq", x, p["wq_a"].to(ct))
    q = dist.constrain_heads(torch.einsum("bsq,qhk->bshk", q, p["wq_b"].to(ct)))
    q_nope, q_rope = q[..., :m.d_nope], q[..., m.d_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = torch.einsum("bsd,dc->bsc", x, p["wkv_a"].to(ct))
    k_rope = torch.einsum("bsd,dr->bsr", x, p["wk_rope"].to(ct))
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    scale = 1.0 / math.sqrt(m.d_nope + m.d_rope)

    if cache is None:
        kv = dist.constrain_heads(torch.einsum("bsc,chk->bshk", c_kv, p["wkv_b"].to(ct)))
        k_nope, v = kv[..., :m.d_nope], kv[..., m.d_nope:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], m.d_rope)],
                      dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = dist.local_heads(lambda q, k, v: kops.attention(
            q, k, v, causal=causal, scale=scale, block_q=cfg.attn_block_q,
            block_kv=cfg.attn_block_kv), qf, k, v)
        out = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(ct))
        return out, ((c_kv, k_rope) if return_kv else None)

    # ---- decode: absorbed attention in the latent space, f32 -------------
    cc, cr = cache
    Sq = x.shape[1]
    for leaf, new in ((cc, c_kv), (cr, k_rope)):
        start = min(cache_index, leaf.shape[1] - Sq)
        leaf[:, start:start + Sq] = new
    f32 = torch.float32
    wb = p["wkv_b"].to(f32)
    wb_k, wb_v = wb[..., :m.d_nope], wb[..., m.d_nope:]     # (c, H, d_nope / d_v)
    q_abs = torch.einsum("bshk,chk->bshc", q_nope.to(f32), wb_k)
    scores = (torch.einsum("bshc,btc->bhst", q_abs, cc.to(f32))
              + torch.einsum("bshr,btr->bhst", q_rope.to(f32), cr.to(f32))) * scale
    t = torch.arange(cc.shape[1], device=x.device)
    qpos = cache_index + torch.arange(Sq, device=x.device)
    scores = scores.masked_fill(~(t[None, :] <= qpos[:, None]), float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btc->bshc", attn, cc.to(f32))
    out = torch.einsum("bshc,chv->bshv", ctx, wb_v).to(ct)
    out = torch.einsum("bshv,hvd->bsd", out, p["wo"].to(ct))
    return out, (cc, cr)


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
    g = dist.constrain_hidden(x @ p["w_gate"].to(ct))
    u = dist.constrain_hidden(x @ p["w_up"].to(ct))
    return (F.silu(g) * u) @ p["w_down"].to(ct)
