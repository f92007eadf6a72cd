"""Plain reference of a decoder LM whose FFN is a routed mixture of experts
(OLMoE, arXiv:2409.02060, as the configuration file states it), in float32.

Blocks: pre-RMSNorm GQA attention with rotary embeddings on interleaved
pairs, then pre-RMSNorm routed experts (SwiGLU each), both residual; a final
RMSNorm and an untied unembedding.  Routing is top-k of the softmax of
float32 router logits, the k weights renormalised to sum to 1, and
dispatch keeps GShard's capacity: each expert takes at most C assignments,
claimed in token-major order (token t's k picks before token t + 1's) over
every token the call routes together, C = max(8, 8 * ceil(ceil(T * k / E *
capacity_factor) / 8)) for T tokens; an assignment past C adds nothing.
So the tokens that share a call decide which are dropped: `prefill` routes
a whole padded batch at once, and each `decode_step` the batch's one new
token per row, exactly as the served engine groups them.

The serving engine left-pads prompts with token 0 and attends to the pads;
so does this reference, which is handed the padded batch.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import (EXACT, Matmul, causal_attention, proj, rmsnorm, rope,
                     unproj)

F32 = torch.float32


def padded_vocab(m: Dict) -> int:
    return -(-m["vocab"] // 128) * 128


def param_specs(m: Dict) -> List[Tuple[str, tuple, str, tuple]]:
    """(path, shape, dtype name, init) of every weight, in the program's
    tree: stacked (L, ...) per-layer leaves, `wq` (d, H, Dh), `wo` (H, Dh,
    d).  init is ("normal", std) or ("const", value)."""
    L, d, H, K, V = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv"], padded_vocab(m)
    Dh = m.get("d_head") or d // H
    E, f = m["moe"]["n_experts"], m["moe"]["d_expert"]
    pd = m["param_dtype"]
    return [
        ("embed.tok", (V, d), pd, ("normal", 0.02)),
        ("embed.unembed", (V, d), pd, ("normal", d ** -0.5)),
        ("ln_f.scale", (d,), pd, ("const", 1.0)),
        ("layers.ln1.scale", (L, d), pd, ("const", 1.0)),
        ("layers.ln2.scale", (L, d), pd, ("const", 1.0)),
        ("layers.attn.wq", (L, d, H, Dh), pd, ("normal", d ** -0.5)),
        ("layers.attn.wk", (L, d, K, Dh), pd, ("normal", d ** -0.5)),
        ("layers.attn.wv", (L, d, K, Dh), pd, ("normal", d ** -0.5)),
        ("layers.attn.wo", (L, H, Dh, d), pd, ("normal", (H * Dh) ** -0.5)),
        ("layers.moe.router", (L, d, E), "float32", ("normal", d ** -0.5)),
        ("layers.moe.w1", (L, E, d, f), pd, ("normal", d ** -0.5)),
        ("layers.moe.w3", (L, E, d, f), pd, ("normal", d ** -0.5)),
        ("layers.moe.w2", (L, E, f, d), pd, ("normal", f ** -0.5)),
    ]


def capacity(n_tokens: int, moe: Dict) -> int:
    c = math.ceil(n_tokens * moe["top_k"] / moe["n_experts"] * moe["capacity_factor"])
    return max(8, -(-c // 8) * 8)


def moe_ffn(h: torch.Tensor, lp: Dict, moe: Dict, mm: Matmul) -> torch.Tensor:
    """The routed experts over the T rows of h (T, d), all routed together."""
    T, d = h.shape
    k, E = moe["top_k"], moe["n_experts"]
    probs = torch.softmax(h.float() @ lp["router"].float(), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = (top_w / top_w.sum(dim=-1, keepdim=True)).reshape(-1)
    eid = top_e.reshape(-1)
    pos = torch.cumsum(F.one_hot(eid, E), dim=0).gather(1, eid[:, None])[:, 0] - 1
    keep = pos < capacity(T, moe)
    tok = torch.arange(T * k, device=h.device) // k
    y = torch.zeros((T, d), dtype=F32, device=h.device)
    for e in range(E):
        a = torch.nonzero((eid == e) & keep)[:, 0]
        if a.numel() == 0:
            continue
        xe = h[tok[a]]
        out = mm(F.silu(mm(xe, lp["w1"][e])) * mm(xe, lp["w3"][e]), lp["w2"][e])
        y.index_add_(0, tok[a], out * top_w[a, None])
    return y


def _layer(params: Dict, i: int) -> Dict:
    lay = params["layers"]
    return {"ln1": lay["ln1"]["scale"][i], "ln2": lay["ln2"]["scale"][i],
            **{n: t[i] for n, t in lay["attn"].items()},
            **{n: t[i] for n, t in lay["moe"].items()}}


def _block(x, lp, m, positions, kv, start: int, mm: Matmul):
    """One block over x (B, Sq, d) at positions start.., writing its k / v
    into kv (each (B, rows, K, Dh) float32) and attending over rows
    0 .. start + Sq - 1."""
    eps, theta = m["norm_eps"], m["rope_theta"]
    B, Sq, d = x.shape
    h = rmsnorm(x, lp["ln1"], eps)
    q = rope(proj(mm, h, lp["wq"]), positions, theta)
    kk = rope(proj(mm, h, lp["wk"]), positions, theta)
    vv = proj(mm, h, lp["wv"])
    kv[0][:, start:start + Sq] = kk
    kv[1][:, start:start + Sq] = vv
    o = causal_attention(q, kv[0][:, :start + Sq], kv[1][:, :start + Sq], q_start=start)
    x = x + unproj(mm, o, lp["wo"], 2)
    h = rmsnorm(x, lp["ln2"], eps)
    return x + moe_ffn(h.reshape(B * Sq, d), lp, m["moe"], mm).reshape(B, Sq, d)


def _logits(params, x, m, mm: Matmul):
    x = rmsnorm(x, params["ln_f"]["scale"], m["norm_eps"])
    return mm(x, params["embed"]["unembed"].T)[..., :m["vocab"]]


def prefill(params: Dict, tokens: torch.Tensor, m: Dict, rows: int,
            mm: Matmul = EXACT):
    """tokens (B, S) -> (last-position logits (B, vocab) float32, the
    float32 k / v cache, `rows` long, per layer)."""
    B, S = tokens.shape
    L, K = m["n_layers"], m["n_kv"]
    Dh = m.get("d_head") or m["d_model"] // m["n_heads"]
    x = params["embed"]["tok"][tokens].float()
    positions = torch.arange(S, device=tokens.device)
    cache = []
    for i in range(L):
        kv = tuple(torch.zeros((B, rows, K, Dh), dtype=F32, device=tokens.device)
                   for _ in range(2))
        x = _block(x, _layer(params, i), m, positions, kv, 0, mm)
        cache.append(kv)
    return _logits(params, x[:, -1], m, mm), cache


def decode_step(params: Dict, cache, tokens: torch.Tensor, pos: int, m: Dict,
                mm: Matmul = EXACT) -> torch.Tensor:
    """tokens (B,) at position pos -> logits (B, vocab) float32; the cache
    takes the new rows."""
    x = params["embed"]["tok"][tokens[:, None]].float()
    positions = torch.tensor([pos], device=tokens.device)
    for i in range(m["n_layers"]):
        x = _block(x, _layer(params, i), m, positions, cache[i], pos, mm)
    return _logits(params, x[:, 0], m, mm)


def model_flops_per_token(m: Dict, context: int, with_logits: bool) -> float:
    """Matrix-product FLOPs of one token's forward at `context` positions
    of causal attention: 2 per multiply-add over the active weights (the
    router, the attention projections, top_k experts), the QK and PV
    products over `context` keys, and the unembedding when the token's
    logits are computed."""
    d, H = m["d_model"], m["n_heads"]
    K, Dh = m["n_kv"], m.get("d_head") or d // m["n_heads"]
    moe = m["moe"]
    per_layer = (d * (H + 2 * K) * Dh + H * Dh * d + d * moe["n_experts"]
                 + moe["top_k"] * 3 * d * moe["d_expert"])
    flops = 2 * m["n_layers"] * per_layer + 4 * m["n_layers"] * H * Dh * context
    return flops + (2 * d * m["vocab"] if with_logits else 0)
