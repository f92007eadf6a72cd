"""Mesh context + activation placement constraints.

The port's counterpart of `repro.models.dist`.  With no mesh set (one card,
the CPU tests) every constraint is the identity and returns its argument
itself.  With a `DeviceMesh` set (a dry run on the fake backend, or real
ranks) activations are DTensors, and a constraint redistributes one to the
named placements: the batch over the dp axes (`pod` x `data`, or with them
`model` under layout="fsdp"), heads over `model`, the rest replicated, so
block boundaries keep the reference's layout.  No hand-written kernel sees
a DTensor: they take raw pointers, so attention (`local_heads`) and the SSD
scan (`local_ssd`) run on each rank's own shards through `local_map`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

from torch.distributed.tensor import DTensor, Replicate

_MESH = None
_BATCH_AXES: Tuple[str, ...] = ("data",)


def set_mesh(mesh, batch_axes=("data",)) -> None:
    """Set (or with None, clear) the mesh the constraints pin to."""
    global _MESH, _BATCH_AXES
    _MESH = mesh
    _BATCH_AXES = tuple(batch_axes)


def get_mesh() -> Optional["DeviceMesh"]:  # noqa: F821
    return _MESH


def batch_axes() -> Tuple[str, ...]:
    return _BATCH_AXES


def _flat(axes):
    return axes if len(axes) > 1 else axes[0]


def _size(axes) -> int:
    sizes = dict(zip(_MESH.mesh_dim_names, _MESH.shape))
    return math.prod(sizes[a] for a in axes)


def constrain(x, *spec):
    """Redistribute the DTensor x to the placements of spec (per tensor dim:
    None, an axis name, a tuple of them, or "batch" for the flattened batch
    axes) if a mesh is set; x itself otherwise."""
    if _MESH is None or x is None:
        return x
    from repro_torch.sharding import placements
    spec = tuple(_flat(_BATCH_AXES) if s == "batch" else s for s in spec)
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain: under a mesh activations are DTensors, got {type(x)}")
    return x.redistribute(_MESH, placements(spec, _MESH))


def constrain_batch(x):
    """Shard dim 0 over the batch axes; replicate the rest (any rank)."""
    if _MESH is None or x is None:
        return x
    if not x.shape or x.shape[0] % _size(_BATCH_AXES):
        return x
    return constrain(x, "batch", *([None] * (x.ndim - 1)))


def constrain_tree(tree, shardings):
    """Redistribute each DTensor leaf of a dict tree to the placements at
    the same key of `shardings` (`sharding.tree_shardings`)."""
    if _MESH is None or shardings is None:
        return tree
    return {k: constrain_tree(v, shardings[k]) if isinstance(v, dict)
            else v.redistribute(_MESH, shardings[k]) for k, v in tree.items()}


def _heads_axis(n_heads: int):
    """"model" where it shards heads (TP layout, the axis present and
    dividing n_heads), else None."""
    if "model" in _BATCH_AXES or "model" not in _MESH.mesh_dim_names:
        return None
    return "model" if n_heads % _size(("model",)) == 0 else None


def constrain_heads(x, head_axis: int = 2):
    """Pin (B, S, H, D)-like activations: batch on dp axes, heads on model
    (TP layout only, and only when H divides the axis)."""
    if _MESH is None or x is None or _heads_axis(x.shape[head_axis]) is None:
        return x
    spec = [None] * x.ndim
    if x.shape[0] % _size(_BATCH_AXES) == 0:
        spec[0] = "batch"
    spec[head_axis] = "model"
    return constrain(x, *spec)


def replicated(t, like):
    """t (the same on every rank: a position or rotation table) as a
    replicated DTensor on the mesh of `like` when `like` is a DTensor, so
    the two combine; t itself otherwise."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def unshard_dp(w):
    """A weight where it is used: its shards over the batch axes gathered
    (FSDP / ZeRO-3: the all-gather of a layer's weights before use; the
    redistribution's backward reduce-scatters their gradients back), its
    shards over `model` kept.  With no mesh, w itself."""
    if _MESH is None or not isinstance(w, DTensor):
        return w
    pl = tuple(Replicate() if a in _BATCH_AXES else p
               for a, p in zip(_MESH.mesh_dim_names, w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(_MESH, pl)


def constrain_hidden(x):
    """Pin a (B, ..., f) FFN hidden activation to the TP layout: batch on
    the dp axes, f over `model` (TP layout only, and only where f divides
    the axis), the rest replicated."""
    return constrain_heads(x, head_axis=x.ndim - 1) if x is not None else x


def local_heads(fn, q, k, v):
    """fn(q, k, v) (attention over (B, S, heads, D) inputs) on each rank's
    own shards when a mesh is set: the batch over the batch axes and the
    heads over `model` where they divide (query and kv heads both, so each
    rank's query heads read its own kv heads), the rest replicated; the
    output keeps q's layout.  Attention is independent across batch rows
    and heads, so this moves nothing beyond the redistribution of its
    inputs.  Without a mesh, fn(q, k, v)."""
    if _MESH is None or not isinstance(q, DTensor):
        return fn(q, k, v)
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import placements
    spec = [None] * 4
    if q.shape[0] % _size(_BATCH_AXES) == 0:
        spec[0] = _flat(_BATCH_AXES)
    spec[2] = _heads_axis(q.shape[2]) and _heads_axis(k.shape[2])
    pl = placements(spec, _MESH)
    return local_map(lambda *a: (fn(*a),), out_placements=(pl,), in_placements=(pl, pl, pl),
                     device_mesh=_MESH, redistribute_inputs=True)(q, k, v)[0]


def local_ssd(fn, x, dt, A, B, C, D, *, final_state: bool = False):
    """fn(x, dt, A, B, C, D) (the SSD scan: x (b, s, h, p), dt (b, s, h),
    A and D (h,), B and C (b, s, n)) on each rank's own shards when a mesh
    is set: the batch over the batch axes and the heads over `model` where
    they divide, B and C batch-sharded and replicated over `model`, A and D
    over `model`; y, and with final_state the (b, h, p, n) state fn returns
    beside it, keep x's layout.  The scan is independent across batch rows
    and heads, so this moves nothing beyond the redistribution of its
    inputs.  What ranks share takes a partial gradient: dB and dC sum over
    the heads of each `model` rank, dA and dD over the rows of each batch
    shard.  Without a mesh, fn(x, dt, A, B, C, D)."""
    if _MESH is None or not isinstance(x, DTensor):
        return fn(x, dt, A, B, C, D)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import placements
    batch = _flat(_BATCH_AXES) if x.shape[0] % _size(_BATCH_AXES) == 0 else None
    heads = _heads_axis(x.shape[2])
    x_pl = placements((batch, None, heads, None), _MESH)
    dt_pl = placements((batch, None, heads), _MESH)
    bc_pl = placements((batch,), _MESH)
    h_pl = placements((heads,), _MESH)

    def partial(pl, axes):
        return tuple(Partial() if a in axes else p
                     for a, p in zip(_MESH.mesh_dim_names, pl))
    bc_grad = partial(bc_pl, ("model",) if heads else ())
    h_grad = partial(h_pl, _BATCH_AXES if batch else ())
    outs = (x_pl, placements((batch, heads), _MESH)) if final_state else (x_pl,)
    out = local_map(lambda *a: fn(*a) if final_state else (fn(*a),),
                    out_placements=outs,
                    in_placements=(x_pl, dt_pl, h_pl, bc_pl, bc_pl, h_pl),
                    in_grad_placements=(x_pl, dt_pl, h_grad, bc_grad, bc_grad, h_grad),
                    device_mesh=_MESH, redistribute_inputs=True)(x, dt, A, B, C, D)
    return out if final_state else out[0]
