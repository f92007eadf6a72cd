"""Causal flash attention: the Hopper kernel's wrapper and its plain version.

Counterpart of `repro.kernels.flash_attention.flash_attention` (a Pallas TPU
kernel).  The kernel is `csrc/flash_attention.cu`: one CTA per (64-row query
tile, query head, batch) with an f32 online softmax over 64-row K/V tiles
that stops at the causal diagonal.  Unlike the Pallas kernel it takes any
Sq / Skv (ragged tails are masked), so it has no block-size arguments.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes `flash_attention_plain`, which the tests and `chip_smoke.py` also use
as the kernel's reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import naive_attention

HEAD_DIMS = (32, 64, 128)  # the kernel's template instances
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain torch: materialized f32 softmax."""
    return naive_attention(q, k, v, causal=causal, scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D) with H % K == 0.
    Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    _, Skv, K, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    code = _build.check_inputs("flash_attention", q, k, v)
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or H % K or D not in HEAD_DIMS):
        raise ValueError(f"flash_attention: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"(head dim in {HEAD_DIMS}, Dv == D, H % K == 0)")
    o = torch.empty_like(q)
    fn = _build.load("flash_attention", "flash_attention_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, Sq, Skv, H, K, D, int(causal), scale, code,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0  # kernel launches since the last reset
