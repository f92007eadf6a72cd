"""Checkpoint save/restore for the train state, in the reference's layout.

The port's counterpart of `repro.training.checkpoint`: one `.npz` per step
(`step_<n>.npz`) whose keys are the reference's flattened pytree paths
(".params/['embed']/['tok']", ".opt/.step", ".opt/.m/...", ".ef/..."),
bfloat16 leaves stored as a uint16 view under `key + ".bf16"`, and a
`latest.txt` manifest (step, then file) written after the file, both
atomically (write, fsync, rename).  So a checkpoint written by either
package restores in the other.

On real ranks (a state of DTensors) `save` gathers each leaf whole, rank 0
alone writes the same file, and every rank waits for it at a barrier;
`restore(..., placements=, mesh=)` is the reference's `restore(...,
shardings=)`: each rank reads the file and keeps its own shard of each
leaf, on a mesh of any size.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor

from repro_torch.launch.mesh import mesh_device
from repro_torch.sharding import distribute, leaves_with_paths


def _map_paths(fn, tree: Any, prefix: str = "") -> Any:
    """Rebuild tree with fn(key, leaf) at each leaf, where key is the
    leaf's path in the reference's format; None stays None, as it has no
    leaves in a JAX pytree."""
    def key(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_map_paths(fn, getattr(tree, n), key(f".{n}"))
                            for n in tree._fields))
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, key(f"['{k}']")) for k, v in tree.items()}
    return fn(prefix, tree)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    """The file's arrays; a DTensor leaf gathered whole (a collective)."""
    flat = {}

    def put(key: str, leaf: torch.Tensor) -> None:
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz cannot round-trip bf16
            flat[key + ".bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()

    _map_paths(put, tree)
    return flat


def _atomic_write(path: str, write) -> str:
    with tempfile.NamedTemporaryFile(dir=os.path.dirname(path), delete=False) as tmp:
        write(tmp)
        tmp.flush()
        os.fsync(tmp.fileno())
        name = tmp.name
    os.replace(name, path)
    return path


def save(path: str, step: int, tree: Any) -> str:
    """Write `tree` to <path>/step_<n>.npz atomically; returns file path.
    A tree with DTensor leaves is saved by every rank of their mesh
    together: rank 0 writes, and all return once it has."""
    fname = os.path.join(path, f"step_{step:08d}.npz")
    flat = _flatten(tree)
    ranked = any(isinstance(t, DTensor) for _, t in leaves_with_paths(tree))
    if not ranked or tdist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        _atomic_write(fname, lambda f: np.savez(f, **flat))
        _atomic_write(os.path.join(path, "latest.txt"),
                      lambda f: f.write(f"{step}\n{fname}\n".encode()))
    if ranked:
        tdist.barrier()
    return fname


def latest_step(path: str) -> Optional[int]:
    manifest = os.path.join(path, "latest.txt")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        return int(f.readline().strip())


def restore(path: str, template: Any, step: Optional[int] = None, *,
            placements: Any = None, mesh=None) -> Any:
    """Rebuild `template`'s structure from the checkpoint, each leaf with the
    template leaf's dtype and device; with `placements` (a tree matching
    the template's, `sharding.tree_shardings`) each leaf a DTensor on
    `mesh` holding this rank's own shard, on this rank's device."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    with np.load(os.path.join(path, f"step_{step:08d}.npz")) as data:
        def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
            if key + ".bf16" in data:
                t = torch.from_numpy(data[key + ".bf16"].view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(data[key]))
            return t.to(device=leaf.device if placements is None else mesh_device(mesh),
                        dtype=leaf.dtype)

        tree = _map_paths(load, template)
    return tree if placements is None else distribute(tree, placements, mesh)
