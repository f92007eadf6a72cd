"""Causal flash attention: the Hopper kernel's wrapper and its plain version.

Counterpart of `repro.kernels.flash_attention.flash_attention` (a Pallas TPU
kernel).  The forward kernel is `csrc/flash_attention.cu`: an f32 online
softmax over K/V tiles that stops at the causal diagonal, on the tensor
cores (wgmma, TMA) in bf16 and on the SIMT pipe in f32; it also writes
each row's logsumexp.  The backward (`csrc/flash_attention_bwd.cu`, which
the reference lacks) is a dQ kernel and a dK/dV kernel, likewise in both
dtypes, joined to the forward by a `torch.autograd.Function`.  Unlike the
Pallas kernel they take any Sq / Skv (ragged tails are masked), so they
have no block-size arguments.  The forward also takes a value head
narrower than the query / key head (Dv != D: multi-head latent attention's
prefill and training), which the Pallas kernel does not: both kernels
take the pairs of MLA_HEAD_DIMS beside D == Dv in HEAD_DIMS, and any other
pair raises before any launch.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes `flash_attention_plain` (and autograd through it), which the tests and
`chip_smoke.py` also use as the kernels' reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import naive_attention

HEAD_DIMS = (32, 64, 128)  # the kernels' template instances with Dv == D
# the instances with Dv != D, (D, Dv), forward and backward: deepseek-v2's
# MLA (d_nope + d_rope, d_v) at full width and at its reduced widths
MLA_HEAD_DIMS = ((192, 128), (48, 32))
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain torch: materialized f32 softmax."""
    return naive_attention(q, k, v, causal=causal, scale=scale)


def flash_attention_bwd_plain(q, k, v, do, *, causal: bool = True,
                              scale: Optional[float] = None):
    """(dq, dk, dv) of `flash_attention_plain` for the upstream gradient do,
    by autograd, each in its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_plain(*ins, causal=causal, scale=scale)
        return torch.autograd.grad(o, ins, do)


def supports(q, k, v) -> bool:
    """Whether the kernels (forward and backward alike) take these shapes:
    q (B, Sq, H, D), k (B, Skv, K, D) and v (B, Skv, K, Dv) with H % K == 0
    and either D == Dv in HEAD_DIMS or (D, Dv) in MLA_HEAD_DIMS.  Exactly
    the shape test of `_check`, which raises for any other shape on the
    card."""
    B, _, H, D = q.shape
    Dv = v.shape[3]
    pair_ok = (D == Dv and D in HEAD_DIMS) or (D, Dv) in MLA_HEAD_DIMS
    return (k.shape[0] == B and k.shape[3] == D and v.shape[:3] == k.shape[:3]
            and H % k.shape[2] == 0 and pair_ok)


def _check(kernel: str, q, k, v) -> int:
    if not supports(q, k, v):
        raise ValueError(f"{kernel}: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"(D == Dv in {HEAD_DIMS} or (D, Dv) in {MLA_HEAD_DIMS}, "
                         f"H % K == 0)")
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {q.device}")
    return _build.check_inputs(kernel, q, k, v)


def flash_attention_fwd(q, k, v, *, causal: bool, scale: float,
                        with_lse: bool = True):
    """The forward kernel alone, on CUDA tensors: returns (o, lse), where
    o is (B, Sq, H, Dv) and lse (B, H, Sq) f32 is the per-row logsumexp of
    the scaled scores that the backward reads, or None when with_lse is
    false."""
    code = _check("flash_attention", q, k, v)
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    Dv = v.shape[3]
    o = q.new_empty((B, Sq, H, Dv))
    lse = (torch.empty((B, H, Sq), device=q.device, dtype=torch.float32)
           if with_lse else None)
    fn = _build.load("flash_attention", "flash_attention_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(), B, Sq, Skv, H, K, D, Dv,
                 int(causal), scale, code, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    if Dv != D:
        flash_attention.mla_launches += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float):
    """(dq, dk, dv) of `flash_attention` for the upstream gradient do, given
    the forward's o and lse: the dQ and dK/dV kernels, on CUDA tensors.
    o and do are (B, Sq, H, Dv)."""
    code = _check("flash_attention_bwd", q, k, v)
    _build.check_inputs("flash_attention_bwd", q, o, do, (lse, torch.float32))
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    Dv = v.shape[3]
    if o.shape != (B, Sq, H, Dv) or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd: o{tuple(o.shape)} / "
                         f"do{tuple(do.shape)} != {(B, Sq, H, Dv)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    fn = _build.load("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(), B, Sq, Skv, H, K, D, Dv,
                 int(causal), scale, code, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    _launch_bwd.launches += 1
    if Dv != D:
        _launch_bwd.mla_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, o, lse, do.contiguous(),
                                 causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k: (B, Skv, K, D); v: (B, Skv, K, Dv) with
    H % K == 0.  Returns (B, Sq, H, Dv) in q's dtype, differentiable in q,
    k and v (the backward is `_launch_bwd`'s kernels).  With no gradient to
    follow, as in serving, the forward writes no logsumexp."""
    _build.refuse_dtensors("flash_attention", q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale, with_lse=False)[0]


flash_attention.launches = 0  # forward kernel launches since the last reset
flash_attention.mla_launches = 0  # those of them with Dv != D (MLA's prefill)
_launch_bwd.launches = 0      # backward launches (dQ + dK/dV kernels) since the last reset
_launch_bwd.mla_launches = 0  # those of them with Dv != D (MLA's training)
