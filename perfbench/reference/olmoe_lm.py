"""Plain reference of OLMoE as published (allenai/OLMoE-1B-7B-0924,
arXiv:2409.02060, as the configuration file states it): its loss, its
gradients and its AdamW steps, in float32.

Blocks: pre-RMSNorm multi-head attention whose q and k projections are each
RMSNormed over their flat width (QK-norm) before rotary embeddings on
interleaved pairs, then pre-RMSNorm routed experts, both residual; a final
RMSNorm and an untied unembedding.  The router is the softmax of float32
logits over every expert; each token takes its top k, the gates are those
probabilities as they are (renormalised to sum to 1 only where the file's
`norm_topk` says so; the published `norm_topk_prob` is false), and every
assignment is computed: nothing is dropped.  Each expert is a SwiGLU (w1
the gate, w3 the up projection, w2 the down projection).

The loss is the program's objective: the mean next-token cross-entropy over
the (padded) vocabulary, 1e-4 times the mean squared log-partition, and
0.01 times the Switch load-balance loss summed over the layers, each
layer's n_experts * sum_e P_e f_e, P_e the mean router probability of
expert e and f_e its share of the assignments, both over the whole batch
the step routes together.

The gradient is autograd's over these float32 functions, taken a block of
batch rows at a time, every layer recomputed in the backward pass
(`torch.utils.checkpoint`), so that the full-width model fits beside
nothing else.  The sums are the same as over the whole batch: f_e carries
no gradient, so each layer's assignment counts over the whole batch are
counted first, by a forward pass without gradients, and each block's loss
then holds P_e of its own rows times the whole batch's f_e.  Each weight is
read in float32 where it is used, inside the recomputed layer, and its
gradient is added into a float32 buffer of the leaf's shape: no float32
copy of the whole model is kept.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (EXACT, Matmul, adamw_step, causal_attention, exact_matmuls, leaves,
                     proj, rmsnorm, rope, unproj)

F32 = torch.float32
AUX_COEF = 0.01      # the program's `loss_fn` default, OLMoE's router_aux_loss_coef
ZLOSS_COEF = 1e-4    # the program's `loss_fn`: on the output logits' log-partition
SLICE = 1 << 27      # elements: a larger leaf is updated a leading-axis slice at a time


def padded_vocab(m: Dict) -> int:
    return -(-m["vocab"] // 128) * 128


def _dims(m: Dict):
    d, H = m["d_model"], m["n_heads"]
    return d, H, m["n_kv"], m.get("d_head") or d // H


def param_specs(m: Dict) -> List[Tuple[str, tuple, str, tuple]]:
    """(path, shape, dtype name, init) of every weight, in the program's
    tree: stacked (L, ...) per-layer leaves, `wq` (d, H, Dh), `wo` (H, Dh,
    d), the QK-norm scales `q_norm` (L, H Dh) and `k_norm` (L, K Dh), the
    router (L, d, E) in float32, the experts w1 / w3 (L, E, d, f) and w2
    (L, E, f, d).  init is ("normal", std) or ("const", value): the
    program's init scales."""
    L, V = m["n_layers"], padded_vocab(m)
    d, H, K, Dh = _dims(m)
    E, f = m["moe"]["n_experts"], m["moe"]["d_expert"]
    pd = m["param_dtype"]
    specs = [
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
    if m.get("qk_norm"):
        specs += [("layers.attn.q_norm", (L, H * Dh), pd, ("const", 1.0)),
                  ("layers.attn.k_norm", (L, K * Dh), pd, ("const", 1.0))]
    return specs


class _Float32(torch.autograd.Function):
    """A weight read in float32 whose gradient is added into `buf`, a
    float32 tensor of its shape, and goes no further.  `anchor` is a scalar
    that requires a gradient, so that autograd calls the backward."""

    @staticmethod
    def forward(ctx, anchor, w, buf):
        ctx.buf = buf
        return w.to(F32, copy=True)

    @staticmethod
    def backward(ctx, g):
        ctx.buf.add_(g)
        return None, None, None


def _reader(bufs: Optional[Dict[str, torch.Tensor]], anchor):
    """read(path, tensor, i=None): the tensor (layer i of it) in float32,
    its gradient going into bufs[path] (layer i of it); with no bufs, a
    plain float32 copy."""
    def read(path, t, i=None):
        t = t if i is None else t[i]
        if bufs is None:
            return t.float()
        return _Float32.apply(anchor, t, bufs[path] if i is None else bufs[path][i])
    return read


def attention(x, lp: Dict, m: Dict, positions, mm: Matmul):
    """QK-normed multi-head attention of x (b, s, d), rotary on q and k."""
    eps, theta = m["norm_eps"], m["rope_theta"]
    q, k = proj(mm, x, lp["wq"]), proj(mm, x, lp["wk"])
    if m.get("qk_norm"):
        q = rmsnorm(q.reshape(*q.shape[:2], -1), lp["q_norm"], eps).reshape(q.shape)
        k = rmsnorm(k.reshape(*k.shape[:2], -1), lp["k_norm"], eps).reshape(k.shape)
    o = causal_attention(rope(q, positions, theta), rope(k, positions, theta),
                         proj(mm, x, lp["wv"]))
    return unproj(mm, o, lp["wo"], 2)


def experts(h, lp: Dict, moe: Dict, mm: Matmul):
    """Every assignment of the rows of h (T, d) through its expert.  Returns
    (y (T, d), the mean router probability of each expert (E,), each
    expert's assignment count (E,))."""
    k, E = moe["top_k"], moe["n_experts"]
    probs = torch.softmax(h @ lp["router"], dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if moe.get("norm_topk", True):
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(E):
        tok, j = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        out = mm(F.silu(mm(xe, lp["w1"][e])) * mm(xe, lp["w3"][e]), lp["w2"][e])
        y = y.index_add(0, tok, out * top_w[tok, j, None])
    counts = torch.bincount(top_e.reshape(-1), minlength=E).to(F32)
    return y, probs.mean(dim=0), counts


def block(x, lp: Dict, m: Dict, f_full, mm: Matmul):
    """One block over x (b, s, d).  Returns (x, this block's aux term:
    n_experts * sum_e P_e f_full_e over these rows, 0 without f_full, the
    assignment counts (E,))."""
    eps = m["norm_eps"]
    positions = torch.arange(x.shape[1], device=x.device)
    x = x + attention(rmsnorm(x, lp["ln1"], eps), lp, m, positions, mm)
    h = rmsnorm(x, lp["ln2"], eps)
    y, p_mean, counts = experts(h.reshape(-1, h.shape[-1]), lp, m["moe"], mm)
    aux = (m["moe"]["n_experts"] * (p_mean * f_full).sum() if f_full is not None
           else x.new_zeros(()))
    return x + y.reshape(x.shape), aux, counts


def _layer_params(params: Dict, read, i: int) -> Dict:
    lay = params["layers"]
    lp = {"ln1": read("layers.ln1.scale", lay["ln1"]["scale"], i),
          "ln2": read("layers.ln2.scale", lay["ln2"]["scale"], i)}
    for group in ("attn", "moe"):
        for n, t in lay[group].items():
            lp[n] = read(f"layers.{group}.{n}", t, i)
    return lp


def _layer(params, bufs, anchor, x, i, m, f_full, mm):
    return block(x, _layer_params(params, _reader(bufs, anchor), i), m, f_full, mm)


def _trunk(params: Dict, tokens, m: Dict, mm: Matmul, f_full=None, bufs=None, anchor=None):
    """(the final hidden (b, s, d) normed, the unembedding in float32, the
    summed aux term, each layer's assignment counts); with bufs, every
    layer checkpointed."""
    read = _reader(bufs, anchor)
    x = read("embed.tok", params["embed"]["tok"])[tokens]
    aux, counts = x.new_zeros(()), []
    for i in range(m["n_layers"]):
        fi = None if f_full is None else f_full[i]
        if bufs is None:
            x, a, c = _layer(params, None, None, x, i, m, fi, mm)
        else:
            x, a, c = checkpoint(_layer, params, bufs, anchor, x, i, m, fi, mm,
                                 use_reentrant=False)
        aux, counts = aux + a, counts + [c]
    x = rmsnorm(x, read("ln_f.scale", params["ln_f"]["scale"]), m["norm_eps"])
    return x, read("embed.unembed", params["embed"]["unembed"]), aux, counts


def _shares(params: Dict, tokens, m: Dict, mm: Matmul, rows: int):
    """Each layer's f_e over the whole batch: its assignment counts, from a
    forward pass without gradients `rows` batch rows at a time, over every
    assignment."""
    with torch.no_grad():
        counts = None
        for r in range(0, tokens.shape[0], rows):
            c = _trunk(params, tokens[r:r + rows], m, mm)[3]
            counts = c if counts is None else [a + b for a, b in zip(counts, c)]
    return [c / (tokens.numel() * m["moe"]["top_k"]) for c in counts]


def forward(params: Dict, tokens, m: Dict, mm: Matmul = EXACT):
    """tokens (b, s) -> (logits (b, s, padded vocab) float32, the summed aux
    loss of these rows routed together)."""
    f_full = _shares(params, tokens, m, mm, tokens.shape[0])
    x, unembed, aux, _ = _trunk(params, tokens, m, mm, f_full)
    return mm(x, unembed.T), aux


def objective(logits, aux, labels):
    """The program's loss from logits (b, s, V) and the summed aux loss."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean() + ZLOSS_COEF * (logz ** 2).mean() + AUX_COEF * aux


def grads(params: Dict, bufs: Dict[str, torch.Tensor], tokens, labels, m: Dict,
          mm: Matmul = EXACT, rows: int = 2) -> float:
    """The loss of the whole batch; its gradient added into bufs ({path:
    float32 tensor of the leaf's shape}), `rows` batch rows at a time, each
    block's loss weighted by its share of the rows."""
    B = tokens.shape[0]
    f_full = _shares(params, tokens, m, mm, rows)
    anchor = torch.zeros((), device=tokens.device, requires_grad=True)
    total = 0.0
    for r in range(0, B, rows):
        x, unembed, aux, _ = _trunk(params, tokens[r:r + rows], m, mm, f_full, bufs, anchor)
        lb = objective(mm(x, unembed.T), aux, labels[r:r + rows]) * (min(rows, B - r) / B)
        lb.backward()
        total += float(lb.detach())
    return total


def _slices(flat: Dict[str, torch.Tensor], *trees: Dict[str, torch.Tensor]):
    """The dicts with every leaf over SLICE elements split into views of its
    leading-axis slices, so that an update's float32 temporaries stay one
    slice large (the same arithmetic, leaf by leaf)."""
    out = [{} for _ in (flat, *trees)]
    for k, t in flat.items():
        parts = range(t.shape[0]) if t.numel() > SLICE else [None]
        for i in parts:
            for o, tree in zip(out, (flat, *trees)):
                o[k if i is None else f"{k}#{i}"] = tree[k] if i is None else tree[k][i]
    return out


def train(params: Dict, batches, m: Dict, opt: Dict, mm: Matmul = EXACT, rows: int = 2):
    """AdamW steps from params (nested, updated in place), one a batch of
    (tokens, labels).  Returns (each step's loss, {path: the first step's
    gradient as the update takes it, clipped by the global norm, in host
    memory})."""
    exact_matmuls()
    flat = dict(leaves(params))
    bufs = {k: torch.zeros(t.shape, dtype=F32, device=t.device) for k, t in flat.items()}
    m1 = {k: torch.zeros_like(t) for k, t in bufs.items()}
    v1 = {k: torch.zeros_like(t) for k, t in bufs.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        for b in bufs.values():
            b.zero_()
        losses.append(grads(params, bufs, tokens, labels, m, mm, rows))
        gnorm = adamw_step(*_slices(flat, bufs, m1, v1), step, opt)
        if first is None:
            scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
            first = {k: (t * scale).cpu() for k, t in bufs.items()}
    return losses, first


def model_flops_per_token(m: Dict, seq: int) -> float:
    """Training FLOPs of one token at sequence length seq: 6 per active
    weight of every matrix product (the attention projections, the router,
    top_k experts, the unembedding: forward, and the backward's two), and 3
    times the forward's of causal attention (QK and PV over (seq + 1) / 2
    keys on average); no recomputation."""
    L = m["n_layers"]
    d, H, K, Dh = _dims(m)
    moe = m["moe"]
    per_layer = (d * (H + 2 * K) * Dh + H * Dh * d + d * moe["n_experts"]
                 + moe["top_k"] * 3 * d * moe["d_expert"])
    weights = L * per_layer + d * padded_vocab(m)
    attn = L * 4 * H * Dh * (seq + 1) / 2
    return 6 * weights + 3 * attn
