"""AdamW over the leaves of a params' tree: the Hopper kernels' wrapper and
its plain version.

One step, with the clip scale s = min(clip / (||g|| + 1e-9), 1) from the
global norm of every gradient leaf, the schedule's lr and the bias
corrections c1 = 1 - b1^t and c2 = 1 - b2^t, updates each leaf in place:

    m = b1 m + (1 - b1) g s
    v = b2 v + (1 - b2) (g s)^2
    p = p - lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)

with f32 moments and p kept in its own dtype.  It replaces no TPU kernel: the
reference's AdamW is plain jnp (`repro.training.optimizer`).
`csrc/adamw.cu` reads each gradient leaf once for the norm (f64 partials a
CTA, summed in a fixed order: a step repeats bit for bit) and makes one pass
a leaf for the update, which reads g, p, m and v once and writes p, m and v
once, whole leaves at 64-bit offsets; s, lr, c1 and c2 stay on the device.

A CUDA leaf launches the kernels (p and g each float32 or bfloat16, m and v
float32; anything else raises `ValueError` before any launch); a CPU leaf
takes `adamw_update_plain`: per leaf about 20 torch elementwise passes, a
large leaf a block of rows at a time.  A mesh job's leaves are DTensors:
each rank updates its own shards, on the card through the kernels, and a
leaf split over mesh dims adds its shards' sums of squares across those
dims before the norm, so every rank clips by the whole tree's norm.  The
tests and `chip_smoke.py` hold the kernels against the plain version.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor, Replicate

from . import _build

Quad = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]  # (g, m, v, p)
Split = Tuple[int, ...]   # the mesh dims a leaf is split over; () if whole

# The plain update holds about five f32 temporaries of the leaf it updates;
# a leaf larger than this (an MoE model's stacked experts: 8 layers of
# olmoe's w1 are 1.07e9 elements, 4.3 GB in f32; seamless-m4t-medium's
# 256,256-row embedding, 2.6e8) is updated a block of leading-axis slices at
# a time, each block of at most this many elements (at least one slice), the
# same elementwise arithmetic.  One slice at a time would be one update per
# embedding row: 5e5 rows, 1e7 launches.  The kernels hold no temporaries
# and take whole leaves.
UPDATE_SLICE_ELEMS = 1 << 27

THREADS, VEC, MAX_PARTS = 256, 8, 1024   # csrc/adamw.cu's kThreads, kVec, kNormMaxParts
_SUMSQ_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_FINISH_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_void_p]
_SUM_PARTS_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_UPDATE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 3
                    + [ctypes.c_float] * 6 + [ctypes.c_void_p] * 5)


def norm_parts(n: int) -> int:
    """f64 partials of an n-element leaf's sum of squares: one a CTA of 256
    threads x 8 elements, at most 1024, a function of n alone."""
    return min(math.ceil(n / (THREADS * VEC)), MAX_PARTS)


# ------------------------------------------------------------- mesh shards
def _by_split(split: Optional[Sequence[Split]], n: int) -> Dict[Split, List[int]]:
    """Leaf indices grouped by the mesh dims they are split over, groups in
    the order of their first leaf (the same on every rank)."""
    groups: Dict[Split, List[int]] = {}
    for i, dims in enumerate(split or [()] * n):
        groups.setdefault(dims, []).append(i)
    return groups


def _local_shards(quads: List[Quad]):
    """A mesh job's DTensor (g, m, v, p) leaves as each rank's own shards:
    (plain quads, each leaf's `Split`, the mesh).  A gradient in other
    placements than its param's (a partial sum over the batch ranks) is
    redistributed to them first; m and v must sit as p does.  Plain leaves
    come back as they are, with no split and no mesh."""
    p0 = quads[0][3]
    if not isinstance(p0, DTensor):
        return quads, None, None
    mesh = p0.device_mesh
    local, split = [], []
    for i, (g, m, v, p) in enumerate(quads):
        if not (all(isinstance(t, DTensor) and t.device_mesh == mesh for t in (g, m, v, p))
                and m.placements == v.placements == p.placements):
            raise ValueError(f"adamw: leaf {i} mixes DTensors and tensors, meshes, or "
                             f"placements of p, m and v")
        if g.placements != p.placements:
            g = g.redistribute(mesh, p.placements)
        local.append(tuple(t.to_local() for t in (g, m, v, p)))
        split.append(tuple(d for d, pl in enumerate(p.placements) if pl.is_shard()))
    return local, split, mesh


def _add_across(t: torch.Tensor, dims: Split, mesh) -> None:
    """t summed in place over the ranks along each of the mesh dims."""
    for d in dims:
        tdist.all_reduce(t, group=mesh.get_group(d))


# -------------------------------------------------------------------- plain
def global_norm_plain(leaves: Sequence[torch.Tensor], split: Optional[Sequence[Split]] = None,
                      mesh=None) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf; leaves split over mesh
    dims add their shards' sums across those dims, one sum a group."""
    total = 0
    for dims, idx in _by_split(split, len(leaves)).items():
        s = sum(torch.sum(torch.square(leaves[i].float())) for i in idx)
        _add_across(s, dims, mesh)
        total = total + s
    return torch.sqrt(total)


def _update_leaf_plain(g, m, v, p, scale, lr, c1, c2, b1, b2, eps, wd) -> None:
    if p.dim() > 1 and p.numel() > UPDATE_SLICE_ELEMS:    # a big leaf in blocks of rows
        rows = UPDATE_SLICE_ELEMS // math.prod(p.shape[1:])
        if rows <= 1:                         # views along axis 0
            blocks = zip(g, m, v, p)
        else:
            blocks = ((t[i:i + rows] for t in (g, m, v, p))
                      for i in range(0, p.shape[0], rows))
        for parts in blocks:
            _update_leaf_plain(*parts, scale, lr, c1, c2, b1, b2, eps, wd)
        return
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    u = (m / c1) / (torch.sqrt(v / c2) + eps)
    u = u + wd * p.float()
    p.copy_(p.float() - lr * u)


def adamw_update_plain(quads: Sequence[Quad], lr, c1, c2, *, b1: float, b2: float,
                       eps: float, weight_decay: float, clip_norm: float,
                       split: Optional[Sequence[Split]] = None, mesh=None,
                       gnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The update in torch elementwise ops, leaf by leaf, on plain tensors
    (a mesh job's shards with their `split` and `mesh`); clips by `gnorm`
    when given (the tests hand it the kernels' norm), else by the leaves'
    own.  Returns the norm."""
    if gnorm is None:
        gnorm = global_norm_plain([g for g, _, _, _ in quads], split, mesh)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    for g, m, v, p in quads:
        _update_leaf_plain(g, m, v, p, scale, lr, c1, c2, b1, b2, eps, weight_decay)
    return gnorm


# ------------------------------------------------------------------ kernels
def refuse(quads: Sequence[Quad], *scalars: torch.Tensor) -> None:
    """Raise `ValueError` unless the kernels take every leaf: one CUDA
    device; p and g float32 or bfloat16, m and v float32, one shape, p, m
    and v contiguous; the f32 scalars on the same device."""
    device = quads[0][3].device
    for i, (g, m, v, p) in enumerate(quads):
        if not (p.dtype in _build.DTYPE_CODES and g.dtype in _build.DTYPE_CODES
                and m.dtype == v.dtype == torch.float32
                and g.shape == m.shape == v.shape == p.shape
                and all(t.device == device for t in (g, m, v, p))
                and p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError(f"adamw: unsupported leaf {i}: p{tuple(p.shape)} {p.dtype} "
                             f"g{tuple(g.shape)} {g.dtype} m {m.dtype} v {v.dtype} on "
                             f"{p.device}/{g.device} (p and g float32 or bfloat16, m and v "
                             f"float32, one shape and CUDA device, p, m, v contiguous)")
    if device.type != "cuda":
        raise ValueError(f"adamw: no kernel for device {device}")
    for s in scalars:
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != device:
            raise ValueError(f"adamw: scalar {s.dtype} {tuple(s.shape)} on {s.device}: "
                             f"expected one float32 on {device}")


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"adamw {what} kernel launch failed: cudaError {err}")


def _aligned(*ts: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def _launch_norm(grads: List[torch.Tensor], clip_norm: float,
                 split: Optional[Sequence[Split]] = None, mesh=None) -> torch.Tensor:
    """f32 (2,) on the grads' device: the global norm, then the clip scale.
    Leaves split over mesh dims sum their partials a group at a time, and
    add each group's f64 total across its dims before the groups' totals
    are summed."""
    groups = _by_split(split, len(grads))
    order = [i for idx in groups.values() for i in idx]
    parts = [norm_parts(grads[i].numel()) for i in order]
    device = grads[0].device
    part = torch.empty(sum(parts), dtype=torch.float64, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    sumsq = _build.load("adamw", "adamw_sumsq", _SUMSQ_ARGTYPES)
    finish = _build.load("adamw", "adamw_norm_finish", _FINISH_ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        at = 0
        for i, n in zip(order, parts):
            g = grads[i]
            if n:
                _check(sumsq(g.data_ptr(), g.numel(), _build.DTYPE_CODES[g.dtype],
                             _aligned(g), part.data_ptr() + 8 * at, n, stream),
                       "sum of squares")
            at += n
        if list(groups) == [()]:              # nothing to add across ranks
            _check(finish(part.data_ptr(), at, clip_norm, out.data_ptr(), stream), "norm")
            return out
        sum_parts = _build.load("adamw", "adamw_sum_parts", _SUM_PARTS_ARGTYPES)
        totals = torch.empty(len(groups), dtype=torch.float64, device=device)
        at = 0
        for j, (dims, idx) in enumerate(groups.items()):
            n = sum(norm_parts(grads[i].numel()) for i in idx)
            _check(sum_parts(part.data_ptr() + 8 * at, n, totals.data_ptr() + 8 * j, stream),
                   "group sum")
            _add_across(totals[j:j + 1], dims, mesh)
            at += n
        _check(finish(totals.data_ptr(), len(groups), clip_norm, out.data_ptr(), stream),
               "norm")
    return out


def adamw_update(quads: Sequence[Quad], lr, c1, c2, *, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float) -> torch.Tensor:
    """One AdamW step over (g, m, v, p) leaves, in place; lr, c1 and c2 are
    f32 scalars on the leaves' device.  Returns the global grad norm (f32,
    on the device; replicated over the mesh for DTensor leaves).  CUDA
    leaves launch the kernels: one sum of squares a leaf, one sum of the
    partials, one update a leaf; CPU leaves take `adamw_update_plain`.
    DTensor leaves run either way on each rank's shards."""
    quads, split, mesh = _local_shards(list(quads))
    lr, c1, c2 = (s.to_local() if isinstance(s, DTensor) else s for s in (lr, c1, c2))
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, clip_norm=clip_norm)
    if quads[0][3].device.type == "cpu":
        gnorm = adamw_update_plain(quads, lr, c1, c2, split=split, mesh=mesh, **hyper)
    else:
        gnorm = _launch_update(quads, lr, c1, c2, split, mesh, **hyper)
    if mesh is None:
        return gnorm
    return DTensor.from_local(gnorm, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _launch_update(quads, lr, c1, c2, split, mesh, *, b1, b2, eps, weight_decay, clip_norm):
    refuse(quads, lr, c1, c2)
    quads = [(g.contiguous(), m, v, p) for g, m, v, p in quads]
    out = _launch_norm([g for g, _, _, _ in quads], clip_norm, split, mesh)
    update = _build.load("adamw", "adamw_update", _UPDATE_ARGTYPES)
    consts = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay)   # ctypes rounds each to f32
    scale = out[1:]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        for g, m, v, p in quads:
            n = p.numel()
            if not n:
                continue
            _check(update(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(), n,
                          _build.DTYPE_CODES[p.dtype], _build.DTYPE_CODES[g.dtype],
                          _aligned(g, p, m, v), *consts, scale.data_ptr(), lr.data_ptr(),
                          c1.data_ptr(), c2.data_ptr(), stream), "update")
            adamw_update.launches += 1
            adamw_update.elems += n
    return out[0]


adamw_update.launches = 0  # leaves updated by the update kernel since the last reset
adamw_update.elems = 0     # elements those launches updated (read by the roofline)
