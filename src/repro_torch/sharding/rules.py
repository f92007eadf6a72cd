"""Placement rules: params, optimizer state, batches, caches.

The port's counterpart of `repro.sharding.rules`.  Where the reference
returns a `NamedSharding` per leaf, the port returns the leaf's DTensor
placements over a `DeviceMesh`: a tuple with one `Shard(dim)` or
`Replicate()` per mesh axis.  The rules are the reference's, name for name:

  * `model` axis: TP for attention heads / FFN hidden / vocab; EP for MoE
    experts; the sequence dim of KV caches when heads cannot shard.
  * `data` (x `pod`) axes: batch; with cfg.fsdp also the largest weight dim
    (ZeRO-3-like); layout="fsdp" folds `model` into the data axes.

A rule first gives a spec in the reference's terms (per tensor dim: None,
an axis name, or a tuple of axis names, major first), and `placements`
turns it into DTensor placements; `spec_of` turns placements back into
such a tuple, which the tests hold to the reference's PartitionSpecs.
Rules are name-based over the joined tree path and divisibility-checked:
a dim is only sharded if its size divides the axes' size, so reduced
configs fall back to replication.  A mesh is anything with `shape` and
`mesh_dim_names`, as a `DeviceMesh` has.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.models.config import ModelConfig, ShapeSpec

Spec = Tuple[Any, ...]   # per tensor dim: None, an axis name or a tuple of them


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return _sizes(mesh)[axes]
    return math.prod(_sizes(mesh)[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    n = _axsize(mesh, axes)
    return n > 1 and dim % n == 0


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_axes(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """Axes the batch (and fsdp weights) shard over.  layout="fsdp" folds
    the model axis into data parallelism (pure ZeRO-3, no TP)."""
    ax = batch_axes(mesh)
    if cfg.layout == "fsdp" and "model" in mesh.mesh_dim_names:
        ax = ax + ("model",)
    return ax


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec: mesh axis a shards the tensor dim whose
    entry names it (axes of one entry in their mesh order, major first),
    and replicates where no entry names it."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            out[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return tuple(out)


def spec_of(pl: tuple, mesh, ndim: int) -> Spec:
    """The spec of placements, in the reference's PartitionSpec form: per
    tensor dim None, one axis name, or a tuple of the axes sharding it."""
    spec = [()] * ndim
    for a, p in zip(mesh.mesh_dim_names, pl):
        if isinstance(p, Shard):
            spec[p.dim] = spec[p.dim] + (a,)
    return tuple(None if not s else s[0] if len(s) == 1 else s for s in spec)


# ------------------------------------------------------------------ params
_RULES = [
    # pattern over the joined path           -> dims spec builder
    (r"embed/(tok|unembed)$", lambda d: ("model", "fsdp")),
    (r"patch_proj$", lambda d: ("fsdp", None)),
    (r"(attn|xattn)/wq$", lambda d: ("fsdp", "model", None)),
    (r"(attn|xattn)/w(k|v)$", lambda d: ("fsdp", "model", None)),
    (r"(attn|xattn)/wo$", lambda d: ("model", None, "fsdp")),
    (r"attn/wq_a$", lambda d: ("fsdp", None)),
    (r"attn/wq_b$", lambda d: (None, "model", None)),
    (r"attn/wkv_a$", lambda d: ("fsdp", None)),
    (r"attn/wk_rope$", lambda d: ("fsdp", None)),
    (r"attn/wkv_b$", lambda d: (None, "model", None)),
    (r"ffn/w_(gate|up)$", lambda d: ("fsdp", "model")),
    (r"ffn/w_down$", lambda d: ("model", "fsdp")),
    (r"moe/router$", lambda d: (None, None)),
    (r"moe/w[13]$", lambda d: ("model", "fsdp", None)),
    (r"moe/w2$", lambda d: ("model", None, "fsdp")),
    (r"moe/shared/w_(gate|up)$", lambda d: ("fsdp", "model")),
    (r"moe/shared/w_down$", lambda d: ("model", "fsdp")),
    # mamba: Megatron-style channel/head TP over `model`
    (r"w_(x|z)$", lambda d: (None, "model")),
    (r"w_dt$", lambda d: (None, "model")),
    (r"w_bc$", lambda d: (None, None)),
    (r"conv_x_[wb]$", lambda d: (None, "model")[:d]),
    (r"(a_log|d_skip|dt_bias)$", lambda d: ("model",)),
    (r"mamba.*norm$|layers/norm$", lambda d: ("model",)),
    (r"w_out$", lambda d: ("model", None)),
    (r"w_(up|down|q|k|v|if|x|ff1|ff2)$", lambda d: ("fsdp", None)[:d] + (None,) * max(0, d - 2)),
]


def param_spec(path: str, shape: Tuple[int, ...], cfg: ModelConfig, mesh,
               stacked) -> Spec:
    """The spec of one param leaf at `path` (keys joined by "/"); its first
    `int(stacked)` dims are layer stacks, never sharded."""
    n_stack = int(stacked)
    dims: Optional[Tuple] = None
    for pat, builder in _RULES:
        if re.search(pat, path):
            dims = builder(len(shape) - n_stack)
            break
    if dims is None:
        dims = (None,) * (len(shape) - n_stack)
    body = shape[n_stack:]
    spec = []
    pure_fsdp = cfg.layout == "fsdp"
    fsdp_ax = dp_axes(cfg, mesh) if (cfg.fsdp or pure_fsdp) else None
    for size, want in zip(body, tuple(dims) + (None,) * (len(body) - len(dims))):
        ax = None
        if pure_fsdp and want == "model":
            want = "fsdp" if "fsdp" not in dims else None
        if want == "model" and _fits(size, mesh, "model"):
            ax = "model"
        elif want == "fsdp" and fsdp_ax and _fits(size, mesh, fsdp_ax):
            ax = fsdp_ax if len(fsdp_ax) > 1 else fsdp_ax[0]
        spec.append(ax)
    return tuple([None] * n_stack + spec)


def _is_layer_path(path: str) -> bool:
    return bool(re.search(r"(^|/)((pre_)?layers|enc_layers|slstm|mlstm)(/|$)", path))


def leaves_with_paths(tree, prefix: str = ""):
    """(path, leaf) of every tensor leaf, paths joined by "/" as the
    reference's `path_str` joins them: dict keys, NamedTuple field names,
    tuple and list indices.  None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))


def at_path(tree, path: str):
    """The subtree at a path of `leaves_with_paths` (for a placements tree
    from the rules below: the placements of that leaf)."""
    for k in path.split("/"):
        tree = tree[k] if isinstance(tree, dict) else \
            getattr(tree, k) if hasattr(tree, "_fields") else tree[int(k)]
    return tree


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """`fn(path, leaf)` over the leaves of `tree`, keeping its structure
    (dicts, NamedTuples, tuples, lists; None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_shardings(tree, cfg: ModelConfig, mesh):
    """Placements matching `tree` (params, or a whole train state) leaf by
    leaf."""
    def one(path, leaf):
        stacked = _is_layer_path(path)
        if re.search(r"(^|/)mlstm(/|$)", path):
            stacked = 2          # (n_groups, n_m, ...) double stack
        return placements(param_spec(path, tuple(leaf.shape), cfg, mesh, stacked), mesh)
    return map_with_path(one, tree)


def distribute(tree, tree_pl, mesh):
    """Each tensor leaf of `tree`, whole and the same on every rank, as a
    DTensor on `mesh` with the placements at its path in `tree_pl`: each
    rank keeps its own shard (a copy of its own, so the whole leaf can be
    freed) and nothing moves between ranks."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(path, t):
        pl = at_path(tree_pl, path)
        d = distribute_tensor(t, mesh, pl, src_data_rank=None)
        if any(isinstance(p, Shard) for p in pl):
            d = DTensor.from_local(d.to_local().clone(), mesh, pl, run_check=False,
                                   shape=d.shape, stride=d.stride())
        return d
    return map_with_path(one, tree)


def gathered(tree):
    """Each DTensor leaf of `tree` whole, as a plain tensor on the rank's
    device (an all-gather over its mesh: every rank of it calls this);
    other leaves as they are."""
    from torch.distributed.tensor import DTensor
    return map_with_path(lambda _, t: t.full_tensor() if isinstance(t, DTensor) else t,
                         tree)


# ---------------------------------------------------------------- batches
def batch_sharding(tree, mesh, axes: Optional[Tuple[str, ...]] = None):
    """Shard dim 0 (global batch) over the dp axes; replicate the rest."""
    ba = axes or batch_axes(mesh)
    ax = ba if len(ba) > 1 else ba[0]

    def one(_path, leaf):
        if leaf.shape and _fits(leaf.shape[0], mesh, ba):
            return placements((ax,), mesh)
        return placements((), mesh)
    return map_with_path(one, tree)


# ------------------------------------------------------------------ caches
def cache_shardings(tree, cfg: ModelConfig, mesh, shape: ShapeSpec):
    """KV caches: batch over pod x data; heads over model when divisible,
    else the sequence dim goes to model (ring-ish decode).  Recurrent
    states shard their head dim over model when possible."""
    ba = batch_axes(mesh)
    bax = ba if len(ba) > 1 else ba[0]

    def one(_path, leaf):
        shp = tuple(leaf.shape)
        dims = [None] * len(shp)
        if len(shp) >= 4 and shp[-3] == shape.seq_len or \
                (len(shp) >= 3 and shp[-2] == shape.seq_len):
            # attention cache: (L?, B, S, K, Dh) or (L?, B, S, C)
            off = 1 if shp[0] not in (shape.global_batch,) else 0
            b_i = off
            s_i = off + 1
            if _fits(shp[b_i], mesh, ba):
                dims[b_i] = bax
            k_i = s_i + 1 if len(shp) > s_i + 1 else None
            if k_i is not None and len(shp) >= s_i + 3 and \
                    _fits(shp[k_i], mesh, "model"):
                dims[k_i] = "model"
            elif _fits(shp[s_i], mesh, "model"):
                dims[s_i] = "model"
            if dims[b_i] is None and shp[b_i] == 1 and _fits(shp[s_i], mesh, ba) \
                    and dims[s_i] == "model":
                dims[s_i] = None
                if _fits(shp[s_i], mesh, ba + ("model",)):
                    dims[s_i] = ba + ("model",)
        else:
            # recurrent state: shard batch, then heads over model
            for i, d in enumerate(shp):
                if dims.count(bax) == 0 and _fits(d, mesh, ba) and \
                        d == shape.global_batch:
                    dims[i] = bax
                    break
            for i, d in enumerate(shp):
                if dims[i] is None and _fits(d, mesh, "model"):
                    dims[i] = "model"
                    break
        return placements(tuple(dims), mesh)
    return map_with_path(one, tree)
