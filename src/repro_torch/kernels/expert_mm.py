"""Grouped matrix products over the experts: rows sorted by expert, each
group times its own expert's weight.

    y[r] = x[r] @ w[e(r)],   e(r) the expert whose group holds row r

x (R, K) holds the rows of expert 0, then those of expert 1, ..., and
offsets (E,) int32 on the device holds each group's end (the inclusive
cumulative sum of the per-expert counts); a group may be empty.  The
dropless MoE dispatch (`models/moe.py`) calls it three times a layer, for
w1, w3 and w2.  It replaces no TPU kernel: the reference's MoE runs batched
GEMMs over a capacity buffer.

On a CUDA tensor the products are `torch._grouped_mm` (CUTLASS grouped GEMMs
on sm_90, a library product like the cuBLAS GEMMs beside them): the forward,
and a backward of two launches, dX = dY @ w^T per group and dW = x^T @ dY
grouped along R.  Nothing reads the offsets on the host.  Inputs that
`supports` refuses raise `ValueError` before any launch.  On a CPU tensor
`expert_mm_plain` loops over the experts with per-expert matmuls (the
offsets read on the host, which on the CPU waits for nothing), autograd
through them.
"""
from __future__ import annotations

import torch

from . import _build

ALIGN = 8   # K and N: rows of 16 bytes in bf16, as the grouped GEMM's layouts need


def expert_mm_plain(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """The per-expert loop: x (R, K), w (E, K, N), offsets (E,) -> (R, N) in
    x's dtype."""
    ends = offsets.tolist()
    starts = [0] + ends[:-1]
    parts = [x[s:e] @ w[i].to(x.dtype) for i, (s, e) in enumerate(zip(starts, ends))]
    return torch.cat(parts) if parts else x.new_zeros((0, w.shape[-1]))


def supports(x, w, offsets) -> bool:
    """Whether the grouped GEMMs take these inputs: x (R, K) and w (E, K, N)
    bfloat16 with K and N multiples of 8, offsets (E,) int32, one device."""
    return (x.dim() == 2 and w.dim() == 3 and offsets.dim() == 1
            and w.shape[1] == x.shape[1] and offsets.shape[0] == w.shape[0] >= 1
            and x.shape[1] % ALIGN == 0 and w.shape[2] % ALIGN == 0
            and x.dtype == w.dtype == torch.bfloat16 and offsets.dtype == torch.int32
            and x.device == w.device == offsets.device)


def refuse(x, w, offsets) -> None:
    """Raise `ValueError` unless the grouped GEMMs take these inputs on a
    CUDA device."""
    if not supports(x, w, offsets):
        raise ValueError(f"expert_mm: unsupported inputs x{tuple(x.shape)} {x.dtype} "
                         f"w{tuple(w.shape)} {w.dtype} offsets{tuple(offsets.shape)} "
                         f"{offsets.dtype} (bfloat16, K and N multiples of {ALIGN}, int32 "
                         f"offsets, one device)")
    if x.device.type != "cuda":
        raise ValueError(f"expert_mm: no kernel for device {x.device}")


def _launch_fwd(x, w, offsets):
    y = torch._grouped_mm(x, w, offs=offsets)
    expert_mm.launches += 1
    return y


def _launch_bwd(x, w, offsets, dy):
    """(dx, dw) of `expert_mm` for the upstream gradient dy."""
    dx = torch._grouped_mm(dy, w.transpose(-2, -1), offs=offsets)
    dw = torch._grouped_mm(x.transpose(0, 1), dy, offs=offsets)
    _launch_bwd.launches += 1
    return dx, dw


class _ExpertMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, offsets):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w, offsets)
        return _launch_fwd(x, w, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        dx, dw = _launch_bwd(x, w, offsets, dy.contiguous())
        return dx, dw, None


def expert_mm(x, w, offsets):
    """Rows x (R, K), sorted by expert, times each group's expert weight w
    (E, K, N); offsets (E,) int32 the groups' ends.  Returns (R, N) in x's
    dtype, differentiable in x and w."""
    _build.refuse_dtensors("expert_mm", x, w, offsets)
    if x.device.type == "cpu":
        return expert_mm_plain(x, w, offsets)
    refuse(x, w, offsets)
    return _ExpertMM.apply(x, w, offsets)


expert_mm.launches = 0    # forward calls that launched the grouped GEMM since the last reset
_launch_bwd.launches = 0  # backward calls (dX and dW, two grouped GEMMs) since the last reset
