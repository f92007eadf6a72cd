"""State-space and recurrent blocks: Mamba-2 (SSD) and xLSTM (mLSTM/sLSTM).

The port's counterpart of `repro.models.ssm`, with the same param dicts,
layouts and recurrent states (`MambaState`, `MLSTMState`, `SLSTMState`).
Mamba-2 (the SSM half of the hybrid family): training, the hybrid forward
and hybrid prefill run the chunked SSD scan (`kernels.ops.ssd_scan`, the
hand-written kernel on the card; prefill asks it for the final state),
decode the one-token recurrence `ops.ssd_step`.  xLSTM (the ssm family):
the mLSTM runs the chunked scan `ops.mlstm_scan` (plain torch, as the
reference's is jnp alone) and the one-token `_mlstm_step`; the sLSTM a
Python loop over time, one card only (the reference's batch-sharded
`shard_map` branch needs a mesh).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from . import dist
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
    xh = dist.constrain_heads(xs.reshape(*xs.shape[:2], nh, s.d_head))
    dt = dist.constrain_heads(F.softplus(dt.float() + p["dt_bias"][None, None]))
    A = -torch.exp(p["a_log"])
    if state is None:
        if return_state:
            y, ssm = dist.local_ssd(lambda *a: kops.ssd_scan(
                *a, chunk=s.chunk, return_final_state=True),
                xh, dt, A, B, C, p["d_skip"], final_state=True)
            new_state = MambaState(conv_x=cx_state, conv_bc=cbc_state, ssm=ssm)
        else:
            y = dist.local_ssd(lambda *a: kops.ssd_scan(*a, chunk=s.chunk),
                               xh, dt, A, B, C, p["d_skip"])
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


# ==================================================================== mLSTM
class MLSTMState(NamedTuple):
    conv: torch.Tensor   # (B, W-1, f) in the compute dtype
    C: torch.Tensor      # (B, H, Dh, Dh) f32 matrix memory
    n: torch.Tensor      # (B, H, Dh) f32
    m: torch.Tensor      # (B, H) f32 stabilizer


def _xlstm_widths(cfg: ModelConfig) -> Tuple[int, int]:
    """(f, Dh) of the mLSTM: the up-projected width and its head dim."""
    f = int(cfg.xlstm.proj_factor_m * cfg.d_model)
    return f, f // cfg.n_heads


def init_mlstm(gen: Optional[torch.Generator], cfg: ModelConfig, lead=()) -> Params:
    x = cfg.xlstm
    d = cfg.d_model
    H = cfg.n_heads
    f, _ = _xlstm_widths(cfg)
    dt = torch_dtype(cfg.param_dtype)
    device = gen.device if gen is not None else "meta"
    b_if = torch.cat([torch.zeros(H, device=device),
                      torch.linspace(3.0, 6.0, H, device=device)]).to(dt)
    return {
        "w_up": _init(gen, (*lead, d, 2 * f), d ** -0.5, dt),
        "conv_w": _init(gen, (*lead, x.conv_width, f), 0.5, dt),
        "conv_b": torch.zeros((*lead, f), dtype=dt, device=device),
        "wq": _init(gen, (*lead, f, f), f ** -0.5, dt),
        "wk": _init(gen, (*lead, f, f), f ** -0.5, dt),
        "wv": _init(gen, (*lead, f, f), f ** -0.5, dt),
        "w_if": _init(gen, (*lead, f, 2 * H), f ** -0.5, dt),
        "b_if": b_if.expand(*lead, 2 * H).clone(),
        "norm": init_rmsnorm(f, dt, device, lead=lead)["scale"],
        "w_down": _init(gen, (*lead, f, d), f ** -0.5, dt),
    }


def mlstm_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[MLSTMState] = None, return_state: bool = False
              ) -> Tuple[torch.Tensor, Optional[MLSTMState]]:
    """mLSTM block: x (B, S, d) -> (out (B, S, d), new state), in the modes
    of `mamba2_fwd`: the chunked scan (its final state with
    `return_state`), or one token from `state`.  A prompt longer than
    `xlstm.chunk` must be a multiple of it, as in the reference."""
    ct = torch_dtype(cfg.compute_dtype)
    H = cfg.n_heads
    f, dh = _xlstm_widths(cfg)
    up = x @ p["w_up"].to(ct)
    xi, z = torch.chunk(up, 2, dim=-1)
    conv_out, conv_state = _causal_conv(xi, p["conv_w"].to(ct), p["conv_b"].to(ct),
                                        state.conv if state is not None else None)
    xq = F.silu(conv_out)
    # the scale rounded to the compute dtype, as the reference's weak-typed
    # python float is (a host value: no copy to the device)
    scale = float(torch.tensor(dh ** -0.5, dtype=ct))
    q = (xq @ p["wq"].to(ct)) * scale
    k = (xq @ p["wk"].to(ct)) * scale
    v = xi @ p["wv"].to(ct)
    gates = xq @ p["w_if"].to(ct) + p["b_if"].to(ct)[None, None]
    ig, fg = gates[..., :H], gates[..., H:]
    qh = q.reshape(*q.shape[:2], H, dh)
    kh = k.reshape(*k.shape[:2], H, dh)
    vh = v.reshape(*v.shape[:2], H, dh)
    if state is None:
        if return_state:
            y, (C2, n2, m2) = kops.mlstm_scan(qh, kh, vh, ig, fg, chunk=cfg.xlstm.chunk,
                                              return_final_state=True)
            new_state = MLSTMState(conv=conv_state, C=C2, n=n2, m=m2)
        else:
            y = kops.mlstm_scan(qh, kh, vh, ig, fg, chunk=cfg.xlstm.chunk)
            new_state = None
    else:
        y, C2, n2, m2 = _mlstm_step(state, qh[:, 0], kh[:, 0], vh[:, 0],
                                    ig[:, 0], fg[:, 0])
        y = y[:, None]
        new_state = MLSTMState(conv=conv_state, C=C2, n=n2, m=m2)
    y = y.reshape(*y.shape[:2], f)
    y = rmsnorm({"scale": p["norm"]}, y, cfg.norm_eps) * F.silu(z)
    return y @ p["w_down"].to(ct), new_state


def _mlstm_step(st: MLSTMState, q, k, v, ig, fg):
    """One token of the mLSTM recurrence in f32: q, k, v (B, H, Dh); ig, fg
    (B, H).  Returns (y in q's dtype, C, n, m)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    logf = F.logsigmoid(fg.float())
    i_ = ig.float()
    m_new = torch.maximum(logf + st.m, i_)
    fd = torch.exp(logf + st.m - m_new)
    id_ = torch.exp(i_ - m_new)
    C = st.C * fd[..., None, None] + id_[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = st.n * fd[..., None] + id_[..., None] * kf
    num = (qf[..., None, :] @ C)[..., 0, :]
    den = torch.abs((qf * n).sum(dim=-1))
    y = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    return y.to(q.dtype), C, n, m_new


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda") -> MLSTMState:
    """Zero state of one mLSTM layer: the conv tail in the compute dtype,
    the matrix memory in f32, the stabilizer at -1e30."""
    f, dh = _xlstm_widths(cfg)
    H = cfg.n_heads
    ct = torch_dtype(cfg.compute_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(
        conv=torch.zeros((batch, cfg.xlstm.conv_width - 1, f), dtype=ct, device=device),
        C=torch.zeros((batch, H, dh, dh), **f32),
        n=torch.zeros((batch, H, dh), **f32),
        m=torch.full((batch, H), -1e30, **f32))


# ==================================================================== sLSTM
class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, H, Dh) f32
    n: torch.Tensor  # (B, H, Dh) f32
    h: torch.Tensor  # (B, H, Dh) in the compute dtype
    m: torch.Tensor  # (B, H, Dh) f32 stabilizer


def init_slstm(gen: Optional[torch.Generator], cfg: ModelConfig, lead=()) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    f = int(cfg.xlstm.proj_factor_s * d)
    dt = torch_dtype(cfg.param_dtype)
    device = gen.device if gen is not None else "meta"
    b = torch.cat([torch.zeros(d, device=device), torch.linspace(3.0, 6.0, d, device=device),
                   torch.zeros(2 * d, device=device)]).to(dt)
    return {
        # input projections for 4 gates (i, f, z, o)
        "w_x": _init(gen, (*lead, d, 4 * d), d ** -0.5, dt),
        # block-diagonal recurrent weights per head
        "w_r": _init(gen, (*lead, 4, H, dh, dh), dh ** -0.5, dt),
        "b": b.expand(*lead, 4 * d).clone(),
        "norm": init_rmsnorm(d, dt, device, lead=lead)["scale"],
        "w_ff1": _init(gen, (*lead, d, f), d ** -0.5, dt),
        "w_ff2": _init(gen, (*lead, f, d), f ** -0.5, dt),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda") -> SLSTMState:
    """Zero state of one sLSTM layer (the reference builds it inline, in
    `slstm_fwd` and `init_cache`): h in the compute dtype, the rest f32,
    the stabilizer at -1e30 per channel."""
    H = cfg.n_heads
    shape = (batch, H, cfg.d_model // H)
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(c=torch.zeros(shape, **f32), n=torch.zeros(shape, **f32),
                      h=torch.zeros(shape, dtype=torch_dtype(cfg.compute_dtype),
                                    device=device),
                      m=torch.full(shape, -1e30, **f32))


def _slstm_cell(w_rt: torch.Tensor, carry: SLSTMState, gx: torch.Tensor):
    """One sLSTM step.  w_rt: the (4, H, Dh, Dh) recurrent weights laid out
    (H, Dh, 4 * Dh); gx: (B, 4, H, Dh) f32 input-gate preactivations.  The
    recurrent product is computed in h's (the compute) dtype and widened,
    as the reference's einsum is."""
    c, n, h, m = carry
    B, H, dh = h.shape
    r = torch.bmm(h.transpose(0, 1), w_rt)              # (H, B, 4 * Dh)
    g = gx + r.reshape(H, B, 4, dh).permute(1, 2, 0, 3).float()
    i_, f_, z_, o_ = g.unbind(dim=1)
    logf = F.logsigmoid(f_)
    m_new = torch.maximum(logf + m, i_)
    fd = torch.exp(logf + m - m_new)
    id_ = torch.exp(i_ - m_new)
    c = c * fd + id_ * torch.tanh(z_)
    n = n * fd + id_
    h_new = torch.sigmoid(o_) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c, n, h_new.to(h.dtype), m_new), h_new


def _slstm_scan(w_r: torch.Tensor, st: SLSTMState, gx: torch.Tensor):
    """Time loop over (B, S, 4, H, Dh) gate preactivations: (final state,
    h (B, S, H, Dh) f32).  The weights are laid out once, so each step's
    product is one batched matmul over heads with no copy of them."""
    g, H, dh, _ = w_r.shape
    w_rt = w_r.permute(1, 2, 0, 3).reshape(H, dh, g * dh)
    gx = gx.float()
    ys = []
    for t in range(gx.shape[1]):
        st, y = _slstm_cell(w_rt, st, gx[:, t])
        ys.append(y)
    return st, torch.stack(ys, dim=1)


def slstm_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[SLSTMState] = None, return_state: bool = False
              ) -> Tuple[torch.Tensor, Optional[SLSTMState]]:
    """sLSTM block: the recurrence from `state` (zeros without one) over
    x's S tokens, then RMSNorm and a tanh-GELU FFN (`jax.nn.gelu`'s
    default).  Returns (out (B, S, d), the state after the last token when
    `state` or `return_state` is given, else None)."""
    ct = torch_dtype(cfg.compute_dtype)
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    gx = (x @ p["w_x"].to(ct) + p["b"].to(ct)[None, None]).reshape(B, S, 4, H, dh)
    st = state if state is not None else init_slstm_state(cfg, B, x.device)
    st, ys = _slstm_scan(p["w_r"].to(ct), st, gx)
    y = rmsnorm({"scale": p["norm"]}, ys.to(ct).reshape(B, S, d), cfg.norm_eps)
    ff = y @ p["w_ff1"].to(ct)
    y = F.gelu(ff, approximate="tanh") @ p["w_ff2"].to(ct)
    return y, (st if state is not None or return_state else None)
