"""Mamba-2 block (the SSM half of the hybrid family).

The port's counterpart of the Mamba-2 part of `repro.models.ssm`, with the
same param dict, layouts and recurrent state (`MambaState`).  Training, the
hybrid forward and hybrid prefill run the chunked SSD scan
(`kernels.ops.ssd_scan`, the hand-written kernel on the card; prefill asks
it for the final state), decode the one-token recurrence `ops.ssd_step`.
xLSTM comes with its slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .config import ModelConfig, torch_dtype
from .layers import _init, init_rmsnorm, rmsnorm

Params = Dict[str, torch.Tensor]


class MambaState(NamedTuple):
    conv_x: torch.Tensor   # (B, W-1, d_in)
    conv_bc: torch.Tensor  # (B, W-1, 2*d_state)
    ssm: torch.Tensor      # (B, H, P, N) f32


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
               state: Optional[MambaState] = None, return_state: bool = False
               ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    """Mamba-2 block: x (B, S, d) -> (out (B, S, d), new state).

    Without `state`: the chunked scan over the whole sequence; the new state
    is None, or with `return_state` the conv tails and the SSD state after
    the last token (prefill).  With `state`: one token (S == 1) through the
    recurrence (decode), returning the advanced state."""
    s = cfg.ssm
    ct = torch_dtype(cfg.compute_dtype)
    d_in = s.expand * cfg.d_model
    nh = d_in // s.d_head
    xi = x @ p["w_x"].to(ct)
    z = x @ p["w_z"].to(ct)
    bc = x @ p["w_bc"].to(ct)
    dt = x @ p["w_dt"].to(ct)
    conv_x, cx_state = _causal_conv(xi, p["conv_x_w"].to(ct), p["conv_x_b"].to(ct),
                                    state.conv_x if state is not None else None)
    conv_bc, cbc_state = _causal_conv(bc, p["conv_bc_w"].to(ct), p["conv_bc_b"].to(ct),
                                      state.conv_bc if state is not None else None)
    xs = F.silu(conv_x)
    B, C = torch.chunk(F.silu(conv_bc), 2, dim=-1)
    xh = xs.reshape(*xs.shape[:2], nh, s.d_head)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["a_log"])
    if state is None:
        if return_state:
            y, ssm = kops.ssd_scan(xh, dt, A, B, C, p["d_skip"], chunk=s.chunk,
                                   return_final_state=True)
            new_state = MambaState(conv_x=cx_state, conv_bc=cbc_state, ssm=ssm)
        else:
            y = kops.ssd_scan(xh, dt, A, B, C, p["d_skip"], chunk=s.chunk)
            new_state = None
    else:
        ssm, y = kops.ssd_step(state.ssm, xh[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                               p["d_skip"])
        y = y[:, None]
        new_state = MambaState(conv_x=cx_state, conv_bc=cbc_state, ssm=ssm)
    y = y.reshape(*y.shape[:2], d_in)
    y = rmsnorm({"scale": p["norm"]}, y * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"].to(ct), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, device="cuda") -> MambaState:
    """Zero state of one Mamba-2 layer: conv tails in the compute dtype, the
    SSD state in f32."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.d_head
    ct = torch_dtype(cfg.compute_dtype)
    return MambaState(
        conv_x=torch.zeros((batch, s.conv_width - 1, d_in), dtype=ct, device=device),
        conv_bc=torch.zeros((batch, s.conv_width - 1, 2 * s.d_state), dtype=ct,
                            device=device),
        ssm=torch.zeros((batch, nh, s.d_head, s.d_state), dtype=torch.float32,
                        device=device))

