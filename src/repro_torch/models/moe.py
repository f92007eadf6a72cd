"""Mixture-of-Experts FFN on one device.

The port's counterpart of `repro.models.moe`, its single-device branch:
top-k routing from f32 router logits, capacity-based dispatch (GShard-style
token dropping) into an (E, C+1, d) buffer whose last slot takes the
overflow, the experts as three batched GEMMs, the gated combine, the
Switch load-balance aux loss, and optional shared (always-on) experts.
Expert parallelism (the reference's `shard_map` branch) comes with the
sharding slice.

The reference scatters with `.at[].add`; the port keeps every step
deterministic on the card instead.  Each kept (expert, slot) pair is
unique, so dispatch is a plain indexed write (only the trash slot, which
is never read, takes repeated writes), and the combine gathers each
assignment's row and sums a token's k rows (the reference's grouping), so
no float atomics run and a second serve gives the same tokens.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, torch_dtype
from .layers import _init, init_swiglu, swiglu_fwd

Params = Dict[str, torch.Tensor]


def init_moe(gen, cfg: ModelConfig, lead=()) -> Params:
    """The router in f32 whatever cfg.param_dtype is; w1 / w3 (E, d, f) and
    w2 (E, f, d); with n_shared, a SwiGLU of width n_shared * d_expert."""
    m, d = cfg.moe, cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    E, f = m.n_experts, m.d_expert
    p = {
        "router": _init(gen, (*lead, d, E), d ** -0.5, torch.float32),
        "w1": _init(gen, (*lead, E, d, f), d ** -0.5, dt),
        "w3": _init(gen, (*lead, E, d, f), d ** -0.5, dt),
        "w2": _init(gen, (*lead, E, f, d), f ** -0.5, dt),
    }
    if m.n_shared:
        p["shared"] = init_swiglu(gen, d, m.n_shared * f, dt, lead=lead)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: n_tokens * top_k / n_experts * capacity_factor,
    rounded up to a multiple of 8 and at least 8."""
    m = cfg.moe
    c = math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           capacity: int):
    """Top-k routing of x2d (T, d).  Assignments are flattened token-major
    (a = t * k + j), so earlier tokens claim an expert's slots first.
    Returns (probs (T, E) f32, gate (A,) f32 renormalised over each token's
    k, eid (A,), keep (A,) bool, slot (A,): the assignment's position in
    its expert, or `capacity` (the trash slot) where it overflowed)."""
    m = cfg.moe
    logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    eid = top_e.reshape(-1)
    onehot = F.one_hot(eid, m.n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, eid[:, None])[:, 0]
    keep = pos < capacity
    slot = torch.where(keep, pos, capacity).long()
    return probs, top_w.reshape(-1), eid, keep, slot


def _moe_local(x2d: torch.Tensor, p: Params, cfg: ModelConfig, capacity: int):
    """Route x2d (T, d), run every expert over its slots, combine.  Returns
    (y (T, d) in x2d's dtype, frac_prob (E,), assigned (E,), T)."""
    m = cfg.moe
    T, d = x2d.shape
    k, E = m.top_k, m.n_experts
    ct = x2d.dtype
    probs, gate, eid, keep, slot = _route(x2d, p["router"], cfg, capacity)
    # dispatch: each token's row, k times (a = t * k + j), into its slot
    xs = x2d[:, None, :].expand(T, k, d).reshape(T * k, d)
    buf = torch.index_put(x2d.new_zeros((E, capacity + 1, d)), (eid, slot), xs)
    buf = buf[:, :capacity]
    # the experts, batched
    g = torch.bmm(buf, p["w1"].to(ct))
    u = torch.bmm(buf, p["w3"].to(ct))
    h = torch.bmm(F.silu(g) * u, p["w2"].to(ct))                  # (E, C, d)
    # combine: a dropped assignment reads a real row and contributes 0,
    # as the reference's zero trash row does
    rows = h[eid, slot.clamp(max=capacity - 1)]
    contrib = torch.where(keep[:, None], rows * gate.to(ct)[:, None], 0)
    y = contrib.reshape(T, k, d).sum(dim=1)
    frac_prob = probs.mean(dim=0)
    assigned = torch.bincount(eid, minlength=E).float()
    return y, frac_prob, assigned, T


def moe_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts (+ the shared ones).  x (B, S, d) -> (y (B, S, d),
    the f32 aux loss n_experts * sum(frac_prob * frac_tokens)).  Capacity
    counts all B * S tokens, pads included."""
    m = cfg.moe
    B, S, d = x.shape
    y, frac_prob, assigned, T = _moe_local(x.reshape(B * S, d), p,
                                           cfg, _capacity(B * S, cfg))
    y = y.reshape(B, S, d)
    frac_tokens = assigned / max(T * m.top_k, 1)
    aux = m.n_experts * torch.sum(frac_prob * frac_tokens)
    if m.n_shared:
        y = y + swiglu_fwd(p["shared"], x, cfg.compute_dtype)
    return y, aux
