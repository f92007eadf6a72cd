"""Flash decode: the Hopper kernel's wrapper and its plain version.

Counterpart of `repro.kernels.flash_decode.flash_decode` (a Pallas TPU
kernel): one query token per sequence against a KV cache whose first
`kv_valid_len` positions are valid.  The kernel is `csrc/flash_decode.cu`,
split-KV: the valid prefix is cut into runs (`split_plan`), one CTA serves
one (run, kv head, batch, up to 8 query heads of its group), so a cache row
is read once per GQA group and rows past the valid length are never read;
the last CTA of each group merges the runs' partial softmaxes in run order.
It applies the softmax scale in f32 inside the kernel, where the Pallas
kernel pre-scales q in q's dtype; in bf16 the two round differently.

A CUDA tensor launches the kernel (or the wrapper raises); a CPU tensor
takes `flash_decode_plain`, which the tests and `chip_smoke.py` also use as
the kernel's reference.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .ref import naive_attention

HEAD_DIMS = (32, 64, 128)  # the kernel's template instances, for D and Dv
ROWS = 32                  # cache rows per shared-memory stage (csrc kT)
GROUP = 8                  # query heads per CTA (csrc kGMax)
MAX_SPLITS = 128           # runs a launch merges, at most (csrc Ring::kMaxSplits >= 256)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# (q, k, v shapes, dtype, device) -> (dtype code, entry point, SM count),
# filled on the first call of each shape so later calls skip validation
_SHAPES: Dict[Tuple, Tuple] = {}
# (device, stream) -> the kernel's run counters (int32, kept at 0 by the
# kernel): one buffer per stream, so launches in flight never share one
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_valid_len, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain torch: materialized f32 softmax."""
    return naive_attention(q, k, v, scale=scale, kv_valid_len=kv_valid_len)


def split_plan(B: int, K: int, G: int, vlen: int, sms: int) -> Tuple[int, int]:
    """(splits, rows): how the kernel cuts the valid prefix [0, vlen) into
    runs of `rows` positions (a multiple of ROWS), enough that the grid of
    B * K * ceil(G / GROUP) CTAs a run covers the `sms` SMs at least twice,
    and no run empty; one run at vlen <= ROWS."""
    ctas = B * K * -(-G // GROUP)
    stages = max(1, -(-vlen // ROWS))
    splits = min(max(1, -(-2 * sms // ctas)), stages, MAX_SPLITS)
    rows = -(-stages // splits) * ROWS
    return max(1, -(-vlen // rows)), rows


def supports(q, k, v) -> bool:
    """Whether the kernel takes these shapes: q (B, 1, H, D), k (B, S, K, D)
    and v (B, S, K, Dv) with D and Dv in HEAD_DIMS and H % K == 0.  Exactly
    the shape test of `_validate`, which raises for any other shape on
    the card."""
    B, sq, H, D = q.shape
    return (sq == 1 and k.shape[:3] == v.shape[:3] and k.shape[0] == B
            and k.shape[3] == D and H % k.shape[2] == 0 and D in HEAD_DIMS
            and v.shape[3] in HEAD_DIMS)


def _validate(q, k, v):
    if not supports(q, k, v):
        raise ValueError(f"flash_decode: unsupported shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"(head dims in {HEAD_DIMS}, H % K == 0)")
    code = _build.check_inputs("flash_decode", q, k, v)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return code, _build.load("flash_decode", "flash_decode_fwd", _ARGTYPES), sms


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_valid_len, *, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, H, D); k: (B, S, K, D); v: (B, S, K, Dv); kv_valid_len: an
    int (a 0-d tensor is read to the host).  Returns (B, 1, H, Dv).

    `flash_decode.launches` counts the calls that launch the kernel (one a
    call), so a serve counts layers x decode steps."""
    B, sq, H, D = q.shape
    _, S, K, Dv = v.shape
    if sq != 1:
        raise ValueError(f"flash_decode is single-token; got Sq={sq}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_valid_len, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    key = (q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype, q.device, k.device,
           v.device)
    known = _SHAPES.get(key)
    if known is None:
        known = _SHAPES[key] = _validate(q, k, v)
    code, fn, sms = known
    for t in (q, k, v):  # per call: the same shape can come as a strided view
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_decode: inputs must be contiguous and 16-byte aligned")
    vlen = min(max(int(kv_valid_len), 0), S)
    splits, rows = split_plan(B, K, H // K, vlen, sms)
    dev = q.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    o = q.new_empty((B, 1, H, Dv))
    part = counters = None
    if splits > 1:
        part = torch.empty(splits * B * H * (Dv + 2), device=q.device, dtype=torch.float32)
        counters = _COUNTERS.get((dev, stream))
        if counters is None or counters.numel() < B * H:
            counters = _COUNTERS[(dev, stream)] = torch.zeros(
                B * H, device=q.device, dtype=torch.int32)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            part.data_ptr() if part is not None else None,
            counters.data_ptr() if counters is not None else None, B, S, H, K, D, Dv,
            vlen, splits, rows, scale, code, stream)
    if dev == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0  # calls that launched the kernel since the last reset
