"""Carry the JAX package's params into the port.

The port keeps the reference's param tree: the same nested keys, stacked
(L, ...) layers and per-tensor layouts (`wq` (d, H, Dh), `wo` (H, Dh, d)).
So conversion is a copy with no transposes, checked key by key and shape by
shape against the tree `init_params` would build.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .config import ModelConfig
from .model import init_params


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def from_jax_params(np_params: Dict[str, Any], cfg: ModelConfig,
                    device) -> Dict[str, Any]:
    """np_params: the JAX param pytree with numpy leaves (e.g.
    `jax.tree.map(np.asarray, params)`).  Returns the port's params on
    `device`, each leaf in the dtype `init_params` gives it (cfg.param_dtype,
    except the Mamba-2 leaves and the MoE router, which the reference keeps
    in float32).  Raises on a
    missing or unused key or a shape that differs."""
    expected = dict(_flatten(init_params(cfg, device="meta")))
    given = dict(_flatten(np_params))
    missing = sorted(expected.keys() - given.keys())
    unused = sorted(given.keys() - expected.keys())
    if missing or unused:
        raise KeyError(f"param keys differ: missing {missing}, unused {unused}")
    out: Dict[str, Any] = {}
    for key, ref in expected.items():
        a = np.asarray(given[key])
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {a.shape} != {tuple(ref.shape)}")
        # bfloat16 has no numpy dtype torch reads: widen it exactly to f32
        t = torch.from_numpy(np.ascontiguousarray(a.astype(np.float32)))
        node = out
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t.to(device=device, dtype=ref.dtype)
    return out
