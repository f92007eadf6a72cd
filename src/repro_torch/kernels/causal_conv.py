"""Causal depthwise conv along time, then SiLU: the Hopper kernels' wrapper
and its plain version.

The depthwise conv that a Mamba-2 layer (`conv_x`, `conv_bc`) and an mLSTM
block run before their SiLU, fused with it:

    y[b, t, c] = silu(bias[c] + sum_{i < W} w[i, c] x[b, t - (W - 1) + i, c])

with zero history before t = 0 in every batch row.  It replaces no TPU
kernel: the reference writes it in jnp (`repro.models.ssm._causal_conv`, then
`jax.nn.silu`).  `csrc/causal_conv.cu` computes it in one pass forward and one
backward (dx, dw, dbias; dw and dbias through per-CTA partials summed in a
fixed order, so a backward repeats bit for bit); a `torch.autograd.Function`
joins them and saves x, w and bias alone.

A CUDA tensor launches the kernels (a shape or dtype `supports` refuses
raises `ValueError` first); a CPU tensor takes `causal_conv_silu_plain`, the
shifted multiplies of `causal_conv_plain` and `F.silu`, and autograd through
them.  The tests and `chip_smoke.py` hold the kernels against it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

MAX_WIDTH = 4          # the kernels take W <= 4 taps
VEC = 8                # channels a forward thread owns: C must be a multiple of it
CTA_SEGMENTS = 8       # segments a CTA walks at once (csrc/causal_conv.cu's kTy)
_FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def segment_rows(C: int) -> int:
    """Times a backward thread walks: 32 where the channels alone give the
    card many threads (the 3 rows it recomputes after its segment are then
    a tenth), 8 where they are few (zamba2's 128 B and C channels)."""
    return 32 if C >= 1024 else 8


def backward_parts(B: int, S: int, C: int) -> int:
    """Rows of f32 partials of dw and dbias the backward writes: its CTAs
    along the segments, a function of the shape alone, so they are summed
    in the same order every run."""
    segments = B * math.ceil(S / segment_rows(C))
    return min(math.ceil(segments / CTA_SEGMENTS), 65535)


def causal_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time, before the SiLU: x (B, S, C), w
    (W, C), b (C,).  state (B, W-1, C) carries the tail for decode (zeros
    without one); returns (y, the new tail: the last W-1 rows of the state
    followed by x)."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None] for i in range(W))
    return y + b[None, None], xp[:, -(W - 1):]


def causal_conv_silu_plain(x, w, b):
    """silu of `causal_conv_plain` from zero history: the kernels' function."""
    return F.silu(causal_conv_plain(x, w, b)[0])


def supports(x, w, b) -> bool:
    """Whether the kernels take these inputs: x (B, S, C) with B, S >= 1 and
    C a multiple of 8, w (W, C) with 1 <= W <= 4, b (C,), all float32 or all
    bfloat16."""
    if x.dim() != 3 or w.dim() != 2:
        return False
    B, S, C = x.shape
    return (B >= 1 and S >= 1 and C % VEC == 0 and C > 0
            and 1 <= w.shape[0] <= MAX_WIDTH and w.shape[1] == C and tuple(b.shape) == (C,)
            and x.dtype in _build.DTYPE_CODES and w.dtype == b.dtype == x.dtype)


def refuse(x, w, b) -> None:
    """Raise `ValueError` unless the kernels take these inputs on a CUDA
    device."""
    if not supports(x, w, b):
        raise ValueError(f"causal_conv: unsupported inputs x{tuple(x.shape)} {x.dtype} "
                         f"w{tuple(w.shape)} {w.dtype} b{tuple(b.shape)} {b.dtype} "
                         f"(W <= {MAX_WIDTH}, C % {VEC} == 0, float32 or bfloat16 alike)")
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv: no kernel for device {x.device}")


def _check(x, w, b) -> int:
    refuse(x, w, b)
    return _build.check_inputs("causal_conv", x, w, b)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous, 16-byte aligned tensor (a view into stacked
    params, or a column slice of a projection, need be neither)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_fwd(x, w, b):
    code = _check(x, w, b)
    B, S, C = x.shape
    y = torch.empty_like(x)
    fn = _build.load("causal_conv", "causal_conv_silu_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, S, C, w.shape[0],
                 code, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"causal_conv kernel launch failed: cudaError {err}")
    causal_conv_silu.launches += 1
    return y


def _launch_bwd(x, w, b, dy):
    """(dx, dw, db) of `causal_conv_silu` for the upstream gradient dy, on
    CUDA tensors, each in its input's dtype."""
    code = _check(x, w, b)
    _build.check_inputs("causal_conv_bwd", x, dy)
    if dy.shape != x.shape:
        raise ValueError(f"causal_conv_bwd: dy{tuple(dy.shape)} != x{tuple(x.shape)}")
    B, S, C = x.shape
    W = w.shape[0]
    parts = backward_parts(B, S, C)
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    part = torch.empty((parts, MAX_WIDTH + 1, C), device=x.device, dtype=torch.float32)
    fn = _build.load("causal_conv", "causal_conv_silu_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in (x, w, b, dy, dx, dw, db, part)), B, S, C, W,
                 segment_rows(C), parts, code, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"causal_conv_bwd kernel launch failed: cudaError {err}")
    _launch_bwd.launches += 1
    return dx, dw, db


class _CausalConvSilu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ins = [_fresh(t) for t in (x, w, b)]
        ctx.save_for_backward(*ins)
        return _launch_fwd(*ins)

    @staticmethod
    def backward(ctx, dy):
        return _launch_bwd(*ctx.saved_tensors, _fresh(dy))


def causal_conv_silu(x, w, b):
    """silu(causal depthwise conv): x (B, S, C), w (W, C), b (C,), one
    dtype.  Returns y (B, S, C) in x's dtype, differentiable in all three."""
    _build.refuse_dtensors("causal_conv", x, w, b)
    if x.device.type == "cpu":
        return causal_conv_silu_plain(x, w, b)
    refuse(x, w, b)
    return _CausalConvSilu.apply(x, w, b)


causal_conv_silu.launches = 0  # forward calls that launched the kernel since the last reset
_launch_bwd.launches = 0       # backward calls that launched the kernels since the last
                               # reset (one a call: a pass and the sum of its partials)
