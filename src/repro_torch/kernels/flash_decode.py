"""Flash decode: the Hopper kernel's wrapper and its plain version.

Counterpart of `repro.kernels.flash_decode.flash_decode` (a Pallas TPU
kernel): one query token per sequence against a KV cache whose first
`kv_valid_len` positions are valid.  The kernel is `csrc/flash_decode.cu`:
one CTA per (kv head, batch, up to 8 query heads of its group), so a cache
row is read once per GQA group, and rows past the valid length are never
read.  It applies the softmax scale in f32 inside the kernel, where the
Pallas kernel pre-scales q in q's dtype; in bf16 the two round differently.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes `flash_decode_plain`, which the tests and `chip_smoke.py` also use as
the kernel's reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import naive_attention

HEAD_DIMS = (32, 64, 128)  # the kernel's template instances, for D and Dv
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_valid_len, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain torch: materialized f32 softmax."""
    return naive_attention(q, k, v, scale=scale, kv_valid_len=kv_valid_len)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_valid_len, *, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, D); k: (B, S, K, D); v: (B, S, K, Dv); kv_valid_len: an
    int (a 0-d tensor is read to the host).  Returns (B, 1, H, Dv)."""
    B, sq, H, D = q.shape
    _, S, K, Dv = v.shape
    if sq != 1:
        raise ValueError(f"flash_decode is single-token; got Sq={sq}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    code = _build.check_inputs("flash_decode", q, k, v)
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != D
            or H % K or D not in HEAD_DIMS or Dv not in HEAD_DIMS):
        raise ValueError(f"flash_decode: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"(head dims in {HEAD_DIMS}, H % K == 0)")
    o = q.new_empty((B, 1, H, Dv))
    fn = _build.load("flash_decode", "flash_decode_fwd", _ARGTYPES)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, H, K, D, Dv, int(kv_valid_len), scale, code,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0  # kernel launches since the last reset
