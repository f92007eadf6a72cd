"""The cell's weights, made from the seed on the device by the benchmark.

A reference module's `param_specs` lists every weight: its path in the
program's tree, its shape, its dtype and its init.  The normal leaves of
one dtype are drawn together, in a few calls of a seeded `torch.Generator`
on the device, into one flat buffer; each leaf is a view of its slice,
scaled in place, so the draw is the same however the leaves are laid out
and nothing is drawn leaf by leaf.  The constant leaves are filled.  The
program and the reference are both handed these tensors (or, where the
program updates them in place, the reference draws them again from the
same seed).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ALIGN = 128          # elements: every leaf starts 256-byte aligned or better
DRAW = 1 << 30       # elements a call draws at most


def make(specs: List[Tuple[str, tuple, str, tuple]], seed: int, device) -> Dict:
    """Nested dict of the leaves in `specs`, from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat: Dict[str, torch.Tensor] = {}
    for dname in sorted({s[2] for s in specs}):
        group = [s for s in specs if s[2] == dname]
        offsets, n = [], 0
        for _, shape, _, _ in group:
            offsets.append(n)
            n += -(-math.prod(shape) // ALIGN) * ALIGN
        buf = torch.empty(n, dtype=DTYPES[dname], device=device)
        for i in range(0, n, DRAW):
            buf[i:i + DRAW].normal_(generator=gen)
        for (path, shape, _, init), off in zip(group, offsets):
            leaf = buf[off:off + math.prod(shape)].view(shape)
            if init[0] == "normal":
                leaf.mul_(init[1])
            elif init[0] == "const":
                leaf.fill_(init[1])
            elif init[0] == "log_linspace":
                row = torch.log(torch.linspace(init[1], init[2], shape[-1],
                                               dtype=torch.float32, device=device))
                leaf.copy_(row.expand(shape))
            else:
                raise ValueError(f"{path}: unknown init {init!r}")
            flat[path] = leaf
    return unflatten(flat)


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, t in flat.items():
        node = out
        *head, last = path.split(".")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = t
    return out


def layout(tree: Dict, prefix: str = "") -> Dict[str, tuple]:
    """{path: (shape, dtype)} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(layout(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = (tuple(v.shape), v.dtype)
    return out
