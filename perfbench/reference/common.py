"""Plain float32 building blocks shared by the references.

Every function computes in float32 from whatever dtype its weights are
stored in.  Matrix products go through a `Matmul`, so that one object
decides the precision of every product: `exact` (float32, TF32 off) for the
reference, `fp8` for the control, the precision below the bfloat16 the
configurations state: each operand of every product, forward and backward,
rounded to float8 e4m3 under a per-tensor scale, then multiplied in
float32.  Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale that maps its largest
    magnitude to 448, back in float32."""
    tf = t.detach().float()
    scale = tf.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (tf / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ w with every operand in fp8: the forward's a and w, and the
    backward's incoming gradient with w (for a's) and with a (for w's)."""

    @staticmethod
    def forward(ctx, a, w):
        qa, qw = fp8_round(a), fp8_round(w)
        ctx.save_for_backward(qa, qw)
        return qa @ qw

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = fp8_round(g)
        ga = qg @ qw.T
        gw = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        return ga, gw


class Matmul:
    """a (..., k) @ w (k, n) in float32, or with every operand in fp8."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        a, w = a.float(), w.float()
        return _Fp8Matmul.apply(a, w) if self.fp8 else a @ w


EXACT = Matmul()


def exact_matmuls() -> None:
    """Float32 products in float32: TF32 off, as a reference needs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on interleaved pairs of every head dim.  x (B, S,
    H, D); positions (S,) or (B, S)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32, device=x.device) / d)
    ang = positions.to(F32)[..., None] * freqs          # (.., S, d/2)
    ang = ang[..., None, :]                             # head axis
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_start: int = 0) -> torch.Tensor:
    """Softmax attention of q (B, Sq, H, D) over k, v (B, Skv, K, D), H a
    multiple of K; query i sits at position q_start + i and sees keys at
    positions up to its own.  One batch row at a time, so the (H, Sq, Skv)
    scores of one row are the largest temporary."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qi = q_start + torch.arange(Sq, device=q.device)
    ti = torch.arange(k.shape[1], device=q.device)
    mask = ti[None, :] <= qi[:, None]
    out = []
    for b in range(B):
        qb = q[b].float().reshape(Sq, K, G, D)
        s = torch.einsum("skgd,tkd->kgst", qb, k[b].float()) * scale
        s = s.masked_fill(~mask, float("-inf"))
        a = torch.softmax(s, dim=-1)
        out.append(torch.einsum("kgst,tkd->skgd", a, v[b].float()).reshape(Sq, H, D))
    return torch.stack(out)


def proj(mm: Matmul, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) times a weight whose first axis is d and whose other axes
    are the output's: (d, H, D) gives (..., H, D)."""
    return mm(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def unproj(mm: Matmul, o: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """o (..., *w.shape[:n_in]) contracted with w over its first n_in axes."""
    lead = o.shape[:o.dim() - n_in]
    return mm(o.reshape(*lead, -1), w.reshape(-1, w.shape[-1]))


def swiglu(mm: Matmul, x, w_gate, w_up, w_down) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def leaves(params: Dict, prefix: str = ""):
    """(dotted path, tensor) of every leaf of nested dicts, in key order."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], step: int,
               opt: Dict[str, float]) -> float:
    """One AdamW step over flat dicts keyed by path, the update computed in
    float32 and each parameter stored back in its own dtype: clip by the
    global norm, warmup then cosine schedule, bias correction, decoupled
    weight decay on every leaf.  Returns the global gradient norm."""
    gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads.values()))
    scale = min(opt["clip_norm"] / (gnorm + 1e-9), 1.0)
    warm = min(step / max(opt["warmup"], 1), 1.0)
    t = min(max((step - opt["warmup"]) / max(opt["total_steps"] - opt["warmup"], 1), 0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * t))
    lr = opt["lr"] * warm * cos
    c1, c2 = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
    for k, p in params.items():
        g = grads[k].float() * scale
        m[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
        v[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
        u = (m[k] / c1) / (torch.sqrt(v[k] / c2) + opt["eps"]) + opt["weight_decay"] * p.float()
        p.copy_(p.float() - lr * u)
    return gnorm


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """|got - ref| of each leaf's norm, against the larger of that leaf's
    reference norm and the median leaf's, over the leaves in `keep` (all by
    default)."""
    keys = list(keep if keep is not None else ref)
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}
