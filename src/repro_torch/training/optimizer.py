"""AdamW with warmup + cosine schedule over a dict of tensors (no
torch.optim).

The port's counterpart of `repro.training.optimizer`: the same schedule,
clipping, bias correction and decoupled weight decay, with f32 moments
whatever the param dtype.  The step counter and every scalar live on the
params' device as f32 / int32 tensors, so a step needs no host sync.
`update` writes the moments and params in place (the port may: it saves
holding two copies of the 3x-params-sized state) through
`kernels.adamw.adamw_update`: the hand-written kernels on a CUDA leaf, the
plain torch arithmetic on a CPU leaf, and either on each rank's shards of a
mesh job's DTensor leaves.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from .. import tracing
from ..kernels import adamw as adamw_kernels

Tree = Dict[str, Any]


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
        step = state.step + 1
        lr = self.lr_at(step)
        stepf = step.to(torch.float32)
        c1 = 1 - self.b1 ** stepf
        c2 = 1 - self.b2 ** stepf
        quads = []
        tree_map(lambda g, m, v, p: quads.append((g, m, v, p)), grads, state.m, state.v,
                 params)
        gnorm = adamw_kernels.adamw_update(
            quads, lr, c1, c2, b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, clip_norm=self.clip_norm)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def global_norm(tree: Tree) -> torch.Tensor:
    return adamw_kernels.global_norm_plain(list(tree_leaves(tree)))
