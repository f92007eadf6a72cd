"""Plain reference of a Zamba-style hybrid LM (Zamba2, arXiv:2411.15242, as
the configuration file states it): its loss, its gradients and its AdamW
steps, in float32.

The stack is groups of `attn_every` Mamba-2 blocks, each group followed by
one shared-weight block (pre-RMSNorm GQA attention with rotary embeddings,
then a pre-RMSNorm SwiGLU, both residual; the same weights at every
application), then the layers left over; a final RMSNorm and an untied
unembedding.  A Mamba-2 block: x, z, (B, C) and dt projections; depthwise
causal convolutions (width 4) on x and on (B, C); SiLU; the SSD recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t + D x_t per head,
computed here in its chunked form (one chunk's quadratic form plus the
state carried between chunks, the same sums in another order); a gated
RMSNorm y * silu(z); the output projection.  dt = softplus(dt + dt_bias),
A = -exp(a_log).  The loss is the mean next-token cross-entropy over the
(padded) vocabulary plus 1e-4 times the mean squared log-partition.

The gradient is autograd's over these float32 functions, taken a block of
batch rows at a time and every block recomputed in the backward pass
(`torch.utils.checkpoint`), so the full-width model fits beside nothing
else; the sums it forms are the same.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import (EXACT, Matmul, adamw_step, causal_attention, proj,
                     rmsnorm, rope, swiglu, unproj)

F32 = torch.float32


def padded_vocab(m: Dict) -> int:
    return -(-m["vocab"] // 128) * 128


def _dims(m: Dict):
    s = m["ssm"]
    d_in = s["expand"] * m["d_model"]
    return d_in, d_in // s["d_head"], s["d_state"], s["conv_width"]


def param_specs(m: Dict) -> List[Tuple[str, tuple, str, tuple]]:
    """(path, shape, dtype name, init) of every weight, in the program's
    tree.  init is ("normal", std), ("const", value) or ("log_linspace",
    lo, hi) along the last axis.  The program's init scales, but every
    projection that writes into the residual stream (Mamba-2's w_out, the
    shared block's wo and w_down) is scaled down by 1 / sqrt(2 L) more, as
    GPT-2 and Megatron initialise deep stacks: at the plain scales the
    38-layer stack is chaotic at initialisation, and bfloat16 rounding
    alone turns its first gradient 84-97 % away from float32's (PERF.md),
    so no comparison could tell bfloat16 from a lower precision."""
    L, d, H, K, V = m["n_layers"], m["d_model"], m["n_heads"], m["n_kv"], padded_vocab(m)
    Dh = m.get("d_head") or d // H
    d_in, nh, N, W = _dims(m)
    pd = m["param_dtype"]
    res = (2 * L) ** -0.5
    return [
        ("embed.tok", (V, d), pd, ("normal", 0.02)),
        ("embed.unembed", (V, d), pd, ("normal", d ** -0.5)),
        ("ln_f.scale", (d,), pd, ("const", 1.0)),
        ("layers.w_x", (L, d, d_in), pd, ("normal", d ** -0.5)),
        ("layers.w_z", (L, d, d_in), pd, ("normal", d ** -0.5)),
        ("layers.w_bc", (L, d, 2 * N), pd, ("normal", d ** -0.5)),
        ("layers.w_dt", (L, d, nh), pd, ("normal", d ** -0.5)),
        ("layers.conv_x_w", (L, W, d_in), pd, ("normal", 0.5)),
        ("layers.conv_x_b", (L, d_in), pd, ("const", 0.0)),
        ("layers.conv_bc_w", (L, W, 2 * N), pd, ("normal", 0.5)),
        ("layers.conv_bc_b", (L, 2 * N), pd, ("const", 0.0)),
        ("layers.a_log", (L, nh), "float32", ("log_linspace", 1.0, 16.0)),
        ("layers.d_skip", (L, nh), "float32", ("const", 1.0)),
        ("layers.dt_bias", (L, nh), "float32", ("const", 0.0)),
        ("layers.norm", (L, d_in), pd, ("const", 1.0)),
        ("layers.w_out", (L, d_in, d), pd, ("normal", res * d_in ** -0.5)),
        ("shared_attn.ln1.scale", (d,), pd, ("const", 1.0)),
        ("shared_attn.ln2.scale", (d,), pd, ("const", 1.0)),
        ("shared_attn.attn.wq", (d, H, Dh), pd, ("normal", d ** -0.5)),
        ("shared_attn.attn.wk", (d, K, Dh), pd, ("normal", d ** -0.5)),
        ("shared_attn.attn.wv", (d, K, Dh), pd, ("normal", d ** -0.5)),
        ("shared_attn.attn.wo", (H, Dh, d), pd, ("normal", res * (H * Dh) ** -0.5)),
        ("shared_attn.ffn.w_gate", (d, m["d_ff"]), pd, ("normal", d ** -0.5)),
        ("shared_attn.ffn.w_up", (d, m["d_ff"]), pd, ("normal", d ** -0.5)),
        ("shared_attn.ffn.w_down", (m["d_ff"], d), pd,
         ("normal", res * m["d_ff"] ** -0.5)),
    ]


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """y of the SSD recurrence over x (b, s, h, p), dt (b, s, h), A (h,),
    B, C (b, s, n), D (h,), from a zero state, in float32."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    c = min(chunk, s)
    nc = s // c
    xf = x.reshape(b, nc, c, h, p)
    dtf = dt.reshape(b, nc, c, h)
    Bf, Cf = B.reshape(b, nc, c, n), C.reshape(b, nc, c, n)
    cs = torch.cumsum(dtf * A[None, None, None, :], dim=2)      # (b, nc, c, h)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]           # (b, nc, t, u, h)
    idx = torch.arange(c, device=x.device)
    causal = (idx[None, :] <= idx[:, None])[None, None, :, :, None]
    gate = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    w = torch.einsum("bktn,bkun->bktu", Cf, Bf)[..., None] * gate
    y = torch.einsum("bktuh,bkuhp->bkthp", w, xf * dtf[..., None])
    total = cs[:, :, -1, :]
    states = torch.einsum("bkch,bkcn,bkchp->bkhpn",
                          torch.exp(total[:, :, None, :] - cs) * dtf, Bf, xf)
    st = x.new_zeros((b, h, p, n))
    prev = []
    for k in range(nc):
        prev.append(st)
        st = st * torch.exp(total[:, k])[:, :, None, None] + states[:, k]
    y = y + torch.einsum("bkcn,bkch,bkhpn->bkchp", Cf, torch.exp(cs), torch.stack(prev, 1))
    return y.reshape(b, s, h, p) + x * D[None, None, :, None]


def _conv(x, w, b):
    W = w.shape[0]
    xp = torch.cat([x.new_zeros((x.shape[0], W - 1, x.shape[2])), x], dim=1)
    return sum(xp[:, i:i + x.shape[1]] * w[i].float() for i in range(W)) + b.float()


def mamba2(x, lp: Dict, m: Dict, mm: Matmul):
    d_in, nh, N, _ = _dims(m)
    s = m["ssm"]
    xi, z = mm(x, lp["w_x"]), mm(x, lp["w_z"])
    bc, dt = mm(x, lp["w_bc"]), mm(x, lp["w_dt"])
    xs = F.silu(_conv(xi, lp["conv_x_w"], lp["conv_x_b"]))
    Bm, Cm = torch.chunk(F.silu(_conv(bc, lp["conv_bc_w"], lp["conv_bc_b"])), 2, dim=-1)
    dt = F.softplus(dt + lp["dt_bias"].float())
    y = ssd_chunked(xs.reshape(*xs.shape[:2], nh, s["d_head"]), dt,
                    -torch.exp(lp["a_log"].float()), Bm, Cm, lp["d_skip"].float(),
                    s["chunk"])
    y = rmsnorm(y.reshape(*y.shape[:2], d_in) * F.silu(z), lp["norm"], m["norm_eps"])
    return mm(y, lp["w_out"])


def shared_block(x, sp: Dict, m: Dict, mm: Matmul):
    eps = m["norm_eps"]
    positions = torch.arange(x.shape[1], device=x.device)
    h = rmsnorm(x, sp["ln1"]["scale"], eps)
    a = sp["attn"]
    q = rope(proj(mm, h, a["wq"]), positions, m["rope_theta"])
    k = rope(proj(mm, h, a["wk"]), positions, m["rope_theta"])
    o = causal_attention(q, k, proj(mm, h, a["wv"]))
    x = x + unproj(mm, o, a["wo"], 2)
    h = rmsnorm(x, sp["ln2"]["scale"], eps)
    f = sp["ffn"]
    return x + swiglu(mm, h, f["w_gate"], f["w_up"], f["w_down"])


def loss(params: Dict, tokens, labels, m: Dict, mm: Matmul = EXACT):
    """The mean loss over the rows of tokens (b, s), every Mamba-2 block
    and every application of the shared block checkpointed."""
    lay = params["layers"]
    x = params["embed"]["tok"].float()[tokens]
    k = m["attn_every"]
    for i in range(m["n_layers"]):
        lp = {n: t[i] for n, t in lay.items()}
        x = x + checkpoint(mamba2, x, lp, m, mm, use_reentrant=False)
        if (i + 1) % k == 0 and i + 1 <= m["n_layers"] // k * k:
            x = checkpoint(shared_block, x, params["shared_attn"], m, mm, use_reentrant=False)
    x = rmsnorm(x, params["ln_f"]["scale"], m["norm_eps"])
    logits = mm(x, params["embed"]["unembed"].T)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean() + 1e-4 * (logz ** 2).mean()


def grads(params: Dict, tokens, labels, m: Dict, mm: Matmul = EXACT, rows: int = 2):
    """(loss, {path: float32 gradient}) of the whole batch, `rows` batch
    rows at a time: each block's loss weighted by its share of the rows."""
    from .common import leaves
    flat = dict(leaves(params))
    live = {k: t.detach().float().requires_grad_(True) for k, t in flat.items()}
    tree = _unflatten(live)
    B = tokens.shape[0]
    total = 0.0
    acc = {k: torch.zeros_like(t) for k, t in live.items()}
    for r in range(0, B, rows):
        lb = loss(tree, tokens[r:r + rows], labels[r:r + rows], m, mm) * (
            min(rows, B - r) / B)
        gs = torch.autograd.grad(lb, list(live.values()))
        for key, g in zip(live, gs):
            acc[key].add_(g)
        total += float(lb.detach())
    return total, acc


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = t
    return out


def train(params: Dict, batches, m: Dict, opt: Dict, mm: Matmul = EXACT, rows: int = 2):
    """AdamW steps from params (nested, updated in place), one a batch of
    (tokens, labels).  Returns (each step's loss, {path: the first step's
    gradient as the update takes it: clipped by the global norm})."""
    from .common import leaves
    flat = dict(leaves(params))
    m1 = {k: torch.zeros(t.shape, dtype=F32, device=t.device) for k, t in flat.items()}
    v1 = {k: torch.zeros_like(t) for k, t in m1.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        lval, g = grads(params, tokens, labels, m, mm, rows)
        losses.append(lval)
        gnorm = adamw_step(flat, g, m1, v1, step, opt)
        if first is None:
            scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
            first = {k: t * scale for k, t in g.items()}
        del g
    return losses, first


def model_flops_per_token(m: Dict, seq: int) -> float:
    """Training FLOPs of one token at sequence length seq: 6 per
    weight of every matrix product (forward, and the backward's two), and
    3 times the forward's of causal attention (QK and PV over (seq + 1) / 2
    keys on average) and of the SSD scan (the quadratic form within a
    chunk over its causal pairs, the chunk states and their reads); no
    recomputation."""
    L, d, H = m["n_layers"], m["d_model"], m["n_heads"]
    K, Dh = m["n_kv"], m.get("d_head") or d // H
    d_in, nh, N, _ = _dims(m)
    s = m["ssm"]
    c, p = s["chunk"], s["d_head"]
    n_shared = L // m["attn_every"]
    mamba = d * (2 * d_in + 2 * N + nh) + d_in * d
    shared = d * (H + 2 * K) * Dh + H * Dh * d + 3 * d * m["d_ff"]
    weights = L * mamba + n_shared * shared + d * padded_vocab(m)
    attn = n_shared * 4 * H * Dh * (seq + 1) / 2
    pairs = (c + 1) / 2
    ssd = L * (2 * pairs * N + nh * (2 * pairs * p + 4 * N * p))
    return 6 * weights + 3 * (attn + ssd)
