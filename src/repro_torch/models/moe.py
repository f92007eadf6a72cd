"""Mixture-of-Experts FFN, on one device or expert-parallel over a mesh.

The port's counterpart of `repro.models.moe`: top-k routing from f32 router
logits, capacity-based dispatch (GShard-style token dropping) into an (E,
C+1, d) buffer whose last slot takes the overflow, the experts as three
batched GEMMs, the gated combine, the Switch load-balance aux loss, and
optional shared (always-on) experts.

With a mesh that has a `model` axis (`models.dist.set_mesh`), the
reference's `shard_map` branch: the experts are sharded over `model` and
the batch over the dp axes (`local_map`); each rank routes its local
tokens, runs its n_experts / ep experts over them at the reference's
capacity (per `token_chunk` tokens when the config chunks its dispatch),
and the outputs are summed over `model`.  Without a mesh the single-device
branch runs.

The reference scatters with `.at[].add`; the port keeps every step
deterministic on the card instead.  Each kept (expert, slot) pair is
unique, so dispatch is a plain indexed write (only the trash slot, which
is never read, takes repeated writes), and the combine gathers each
assignment's row and sums a token's k rows (the reference's grouping), so
no float atomics run and a second serve gives the same tokens.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import dist
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
    # the one-hot by comparison (no value check that reads the data, so a
    # trace on fake tensors runs it)
    onehot = (eid[:, None] == torch.arange(m.n_experts, device=eid.device)).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, eid[:, None])[:, 0]
    keep = pos < capacity
    slot = torch.where(keep, pos, capacity).long()
    return probs, top_w.reshape(-1), eid, keep, slot


def _moe_local(x2d: torch.Tensor, p: Params, cfg: ModelConfig, capacity: int,
               e_start: int = 0, n_local: Optional[int] = None):
    """Route x2d (T, d), run the experts p holds over their slots, combine.
    p's expert weights are experts e_start .. e_start + n_local - 1 (all of
    them by default); an assignment to another expert contributes 0 here.
    An expert's slots are claimed in token order whichever experts a rank
    holds, so a rank's slots are the single-device branch's.  Returns (y
    (T, d) in x2d's dtype, the partial sum over these experts; frac_prob
    (E,); assigned (E,), every assignment counted; T)."""
    m = cfg.moe
    T, d = x2d.shape
    k, E = m.top_k, n_local or m.n_experts
    ct = x2d.dtype
    probs, gate, eid, keep, slot = _route(x2d, p["router"], cfg, capacity)
    # each expert's assignments, summed as exact small integers (bincount's
    # output size reads the data)
    assigned = torch.zeros(m.n_experts, device=eid.device).index_add_(
        0, eid, torch.ones(eid.shape, device=eid.device))
    if E != m.n_experts:   # this rank's slice of the experts
        keep = keep & (eid >= e_start) & (eid < e_start + E)
        slot = torch.where(keep, slot, capacity)
        eid = torch.where(keep, eid - e_start, 0)
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
    return y, frac_prob, assigned, T


def _moe_ep(p: Params, x, cfg: ModelConfig, mesh):
    """The expert-parallel branch: `local_map` of the reference's shard_fn
    over the mesh.  x (B, S, d) is sharded over the dp axes (dim 0) and
    replicated over `model`, which shards the experts.  Returns (y (B, S,
    d) as x, frac_prob (E,), assigned (E,), T), the last three replicated
    and summed (frac_prob averaged) over the ranks as the reference's
    collectives do.

    Each rank's outputs leave `local_map` as partial sums (y over `model`,
    the rest over every axis; frac_prob, the same on every `model` rank,
    as its 1/ep share) and DTensor sums them, so the backward is autograd's:
    each input's gradient is the partial sum of the ranks that used it (x's
    and the router's over `model`, theirs and the experts' over the dp
    axes)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import placements
    m = cfg.moe
    B, S, d = x.shape
    names = mesh.mesh_dim_names
    ba = dist.batch_axes()
    ep = mesh.shape[names.index("model")]
    n_local = m.n_experts // ep
    n_dp = math.prod(mesh.shape[names.index(a)] for a in ba)
    cap = _capacity(B * S // n_dp, cfg)

    def shard_fn(xs, router, w1, w3, w2):
        T = xs.shape[0] * xs.shape[1]
        j = mesh.get_local_rank("model")
        lp = {"router": router, "w1": w1, "w3": w3, "w2": w2}
        tc = m.token_chunk
        if tc and T > tc and T % tc == 0:
            # chunked dispatch: capacity and the (T k, d) gather / scatter
            # buffers scale with the chunk, not the batch
            cap_c = max(8, -(-cap * tc // T // 8) * 8)
            outs = [_moe_local(xc, lp, cfg, cap_c, j * n_local, n_local)
                    for xc in xs.reshape(T // tc, tc, d)]
            y = torch.cat([o[0] for o in outs])
            fp = torch.stack([o[1] for o in outs]).mean(dim=0)
            asg = torch.stack([o[2] for o in outs]).sum(dim=0)
        else:
            y, fp, asg, _ = _moe_local(xs.reshape(T, d), lp, cfg, cap, j * n_local, n_local)
        t = torch.tensor(float(T), device=xs.device)
        return y.reshape(xs.shape), fp / (n_dp * ep), asg, t

    def over(pl, axes, kind):
        return tuple(kind if a in axes else q for a, q in zip(names, pl))
    x_pl = placements((dist._flat(ba), None, None), mesh)
    rep = tuple(Replicate() for _ in names)
    ex = placements(("model", None, None), mesh)
    x_part = over(x_pl, ("model",), Partial())
    total = over(rep, names, Partial())
    y, fp, asg, t = local_map(
        shard_fn, out_placements=(x_part, total, total, total),
        in_placements=(x_pl, rep, ex, ex, ex),
        in_grad_placements=(x_part, total, *(over(ex, ba, Partial()),) * 3),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"], p["w1"], p["w3"], p["w2"])
    return (y.redistribute(mesh, x_pl), fp.redistribute(mesh, rep),
            asg.redistribute(mesh, rep), t.redistribute(mesh, rep))


def moe_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed experts (+ the shared ones).  x (B, S, d) -> (y (B, S, d),
    the f32 aux loss n_experts * sum(frac_prob * frac_tokens)).  Capacity
    counts all B * S tokens of a rank, pads included."""
    m = cfg.moe
    B, S, d = x.shape
    mesh = dist.get_mesh()
    if mesh is not None and "model" in mesh.mesh_dim_names:
        y, frac_prob, assigned, T = _moe_ep(p, x, cfg, mesh)
    else:
        y, frac_prob, assigned, T = _moe_local(x.reshape(B * S, d), p,
                                               cfg, _capacity(B * S, cfg))
        y = y.reshape(B, S, d)
    n_assigned = T * m.top_k   # an int, or (expert-parallel) a 0-d tensor
    frac_tokens = assigned / (n_assigned.clamp(min=1) if torch.is_tensor(n_assigned)
                              else max(n_assigned, 1))
    aux = m.n_experts * torch.sum(frac_prob * frac_tokens)
    if m.n_shared:
        y = y + swiglu_fwd(p["shared"], x, cfg.compute_dtype)
    return y, aux
