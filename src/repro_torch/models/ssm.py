"""Mamba-2 block (the SSM half of the hybrid family), stateless branch.

The port's counterpart of the Mamba-2 part of `repro.models.ssm`, with the
same param dict and layouts.  Training and the hybrid forward run the
chunked SSD scan (`kernels.ops.ssd_scan`, the hand-written kernel on the
card).  The recurrent branches (`state` / `return_state`: hybrid prefill
and decode, `ssd_step`, `init_mamba_state`) and xLSTM come with their
slices.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .config import ModelConfig, torch_dtype
from .layers import _init, init_rmsnorm, rmsnorm

Params = Dict[str, torch.Tensor]


def init_mamba2(gen: Optional[torch.Generator], cfg: ModelConfig,
                lead=()) -> Params:
    """Projections split (x / BC / dt / z) as in the reference.  Every
    matrix takes its own draw from gen (the reference draws `w_x` and
    `w_out` from one key, ROADMAP queue 3).  `a_log`, `d_skip` and
    `dt_bias` stay float32 whatever cfg.param_dtype is."""
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.d_head
    dt = torch_dtype(cfg.param_dtype)
    device = gen.device if gen is not None else "meta"
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    return {
        "w_x": _init(gen, (*lead, d, d_in), d ** -0.5, dt),
        "w_z": _init(gen, (*lead, d, d_in), d ** -0.5, dt),
        "w_bc": _init(gen, (*lead, d, 2 * s.d_state), d ** -0.5, dt),
        "w_dt": _init(gen, (*lead, d, nh), d ** -0.5, dt),
        "conv_x_w": _init(gen, (*lead, s.conv_width, d_in), 0.5, dt),
        "conv_x_b": torch.zeros((*lead, d_in), dtype=dt, device=device),
        "conv_bc_w": _init(gen, (*lead, s.conv_width, 2 * s.d_state), 0.5, dt),
        "conv_bc_b": torch.zeros((*lead, 2 * s.d_state), dtype=dt, device=device),
        "a_log": a_log.expand(*lead, nh).clone(),
        "d_skip": torch.ones((*lead, nh), **f32),
        "dt_bias": torch.zeros((*lead, nh), **f32),
        "norm": init_rmsnorm(d_in, dt, device, lead=lead)["scale"],
        "w_out": _init(gen, (*lead, d_in, d), d_in ** -0.5, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time.  x: (B, S, C); w: (W, C).
    state (B, W-1, C) carries the tail for decode; returns (y, new_state)."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(W))
    return y + b[None, None], xp[:, -(W - 1):]


def mamba2_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               state=None, return_state: bool = False):
    """Stateless Mamba-2 block: x (B, S, d) -> (out (B, S, d), None)."""
    if state is not None or return_state:
        raise NotImplementedError("mamba2_fwd with a recurrent state is not "
                                  "ported yet: ROADMAP queue 1, hybrid serving")
    s = cfg.ssm
    ct = torch_dtype(cfg.compute_dtype)
    d_in = s.expand * cfg.d_model
    nh = d_in // s.d_head
    xi = x @ p["w_x"].to(ct)
    z = x @ p["w_z"].to(ct)
    bc = x @ p["w_bc"].to(ct)
    dt = x @ p["w_dt"].to(ct)
    conv_x, _ = _causal_conv(xi, p["conv_x_w"].to(ct), p["conv_x_b"].to(ct), None)
    conv_bc, _ = _causal_conv(bc, p["conv_bc_w"].to(ct), p["conv_bc_b"].to(ct), None)
    xs = F.silu(conv_x)
    B, C = torch.chunk(F.silu(conv_bc), 2, dim=-1)
    xh = xs.reshape(*xs.shape[:2], nh, s.d_head)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["a_log"])
    y = kops.ssd_scan(xh, dt, A, B, C, p["d_skip"], chunk=s.chunk)
    y = y.reshape(*y.shape[:2], d_in)
    y = rmsnorm({"scale": p["norm"]}, y * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"].to(ct), None

