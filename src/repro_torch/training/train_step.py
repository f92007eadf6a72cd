"""Train step: grad + AdamW, with microbatch accumulation and optional int8
gradient compression with error feedback.

The port's counterpart of `repro.training.train_step`.  Under a mesh
(`models.dist.set_mesh`) the microbatches and the accumulated grads are
pinned as the reference pins them; with none (one card) those constraints
are the identity:

  * microbatches > 1 -- gradient accumulation: each microbatch's grads are
    added into f32 zeros, and the sum is divided by `microbatches`; the
    metrics are the last microbatch's, the loss the mean.
  * compress_grads   -- per-tensor int8 quantize / dequantize of the grads,
    the quantization error kept in f32 state and added back next step.

The step updates the state's tensors in place (see `AdamW.update`).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tracing
from repro_torch.models import TrainBatch, dist, loss_fn
from repro_torch.models.config import ModelConfig
from .optimizer import AdamW, AdamWState, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[Any] = None   # error-feedback residuals (compression only)


def make_train_state(params, opt: AdamW, compress: bool = False) -> TrainState:
    ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                  params) if compress else None
    return TrainState(params=params, opt=opt.init(params), ef=ef)


def _quantize_int8(g):
    amax = torch.max(torch.abs(g)) + 1e-12
    q = torch.clamp(torch.round(g / amax * 127.0), -127, 127).to(torch.int8)
    return q, amax


def _dequantize_int8(q, amax):
    return q.float() * (amax / 127.0)


def compress(grads, ef):
    """int8 error feedback: quantize g + ef per tensor, keep the error in ef
    (in place), and return the dequantized grads."""
    def comp(g, e):
        g = g.float() + e
        q, amax = _quantize_int8(g)
        gq = _dequantize_int8(q, amax)
        e.copy_(g - gq)
        return gq
    return tree_map(comp, grads, ef)


def make_train_step(cfg: ModelConfig, opt: AdamW, *, microbatches: int = 1,
                    compress_grads: bool = False, grad_shardings=None):
    """Returns train_step(state, batch) -> (state, metrics); metrics are
    f32 scalar tensors on the params' device.  `grad_shardings` (placements
    matching params, `sharding.tree_shardings`) pins the accumulated grads
    under a mesh."""

    def grads_of(params, batch: TrainBatch):
        leaves = list(tree_leaves(params))
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        with tracing.span("training.forward", device_time=True):
            loss, metrics = loss_fn(tree_map(lambda _: next(it), params), batch, cfg)
        with tracing.span("training.backward", device_time=True):
            grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(it), params))

    @tracing.spanned("training.step", device_time=True)
    def train_step(state: TrainState, batch: TrainBatch):
        params = state.params
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def split(x):  # None (no extra) stays None, as jax.tree.map skips it
                if x is None:
                    return None
                # under a mesh the rows are gathered first: microbatch i is
                # rows i b / n .. (i + 1) b / n, which a reshape of the
                # batch-sharded dim cannot cut evenly
                x = dist.constrain(x, *([None] * x.ndim))
                x = x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])
                # microbatch dim replicated; per-microbatch batch stays
                # sharded over pod x data
                return dist.constrain(x, None, "batch", *([None] * (x.ndim - 2)))
            parts = TrainBatch(*(split(x) for x in batch))
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            grads = dist.constrain_tree(grads, grad_shardings)
            loss = torch.zeros((), dtype=torch.float32, device=batch.tokens.device)
            for i in range(microbatches):
                mb = TrainBatch(*(dist.constrain_batch(None if x is None else x[i])
                                  for x in parts))
                l_i, metrics, g_i = grads_of(params, mb)
                loss = loss + l_i
                tree_map(lambda a, g: a.add_(g), grads, g_i)
                grads = dist.constrain_tree(grads, grad_shardings)
                del g_i
            loss = loss / microbatches
            tree_map(lambda g: g.div_(microbatches), grads)

        if compress_grads:
            grads = compress(grads, state.ef)

        new_params, new_opt, gnorm = opt.update(grads, state.opt, params)
        metrics = dict(metrics)
        metrics.update(loss=loss, grad_norm=gnorm, lr=opt.lr_at(new_opt.step))
        return TrainState(new_params, new_opt, state.ef), metrics

    return train_step
