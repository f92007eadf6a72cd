"""AdamW with warmup + cosine schedule over a dict of tensors (no
torch.optim).

The port's counterpart of `repro.training.optimizer`: the same schedule,
clipping, bias correction and decoupled weight decay, with f32 moments
whatever the param dtype.  The step counter and every scalar live on the
params' device as f32 / int32 tensors, so a step needs no host sync.
`update` writes the moments and params in place (the port may: it saves
holding two copies of the 3x-params-sized state).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor

from .. import tracing
from ..models.config import SLICE_ELEMS

Tree = Dict[str, Any]

# `update` holds about five f32 temporaries of the leaf it updates; a leaf
# larger than this (an MoE model's stacked experts: 8 layers of olmoe's w1
# are 1.07e9 elements, 4.3 GB in f32; seamless-m4t-medium's 256,256-row
# embedding, 2.6e8) is updated a block of leading-axis slices at a time,
# each block of at most this many elements (at least one slice), the same
# elementwise arithmetic.  One slice at a time would be one update per
# embedding row: 5e5 rows, 1e7 launches, over 100 s a step on the card.
UPDATE_SLICE_ELEMS = SLICE_ELEMS


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of nested dicts of the same keys."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree: Tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    m: Tree
    v: Tree


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0

    # -- schedule -------------------------------------------------------------
    def lr_at(self, step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(self.warmup, 1), max=1.0)
        t = torch.clamp((step - self.warmup) / max(self.total_steps - self.warmup, 1),
                        0.0, 1.0)
        cos = self.min_lr_frac + (1 - self.min_lr_frac) * 0.5 * \
            (1 + torch.cos(math.pi * t))
        return self.lr * warm * cos

    # -- state ---------------------------------------------------------------
    def init(self, params: Tree) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        device = next(tree_leaves(params)).device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                          m=tree_map(zeros, params), v=tree_map(zeros, params))

    # -- update ----------------------------------------------------------------
    @torch.no_grad()
    @tracing.spanned("training.optimizer", device_time=True)
    def update(self, grads: Tree, state: AdamWState, params: Tree
               ) -> Tuple[Tree, AdamWState, torch.Tensor]:
        """One step: clip by the global norm, update m and v, apply the
        bias-corrected update with weight decay.  Writes m, v and params
        in place and returns (params, new state, grad norm)."""
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self.lr_at(step)
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(self.b1, device=stepf.device), stepf)
        c2 = 1 - torch.pow(torch.tensor(self.b2, device=stepf.device), stepf)
        tracing.count("host_syncs", 2)   # each scalar a blocking copy to the device

        def upd(g, m, v, p):
            # a big leaf in blocks of rows (a DTensor's shards are each
            # rank's already, and its rows may be sharded)
            if p.dim() > 1 and p.numel() > UPDATE_SLICE_ELEMS and not isinstance(p, DTensor):
                rows = UPDATE_SLICE_ELEMS // math.prod(p.shape[1:])
                if rows <= 1:                         # views along axis 0
                    blocks = zip(g, m, v, p)
                else:
                    blocks = ((t[i:i + rows] for t in (g, m, v, p))
                              for i in range(0, p.shape[0], rows))
                for parts in blocks:
                    upd(*parts)
                return p
            g = g.float() * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = u + self.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
            return p

        tree_map(upd, grads, state.m, state.v, params)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))
