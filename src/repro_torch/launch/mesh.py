"""Production mesh builders (a function, never module-level state).

The port's counterpart of `repro.launch.mesh`: a mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the reference's axis names,
("data", "model") at 16 x 16 and ("pod", "data", "model") at 2 x 16 x 16.
Building one needs a default process group of as many ranks.  A job on
real ranks, one process a device, joins them with `init_world` (NCCL for
CUDA ranks, gloo for CPU ranks) and builds its mesh over them
(`launch/train.py --mesh`, `runtime/ranks.py`).  Without a world the port
runs with `models.dist.set_mesh(None)`, as the reference runs without a
mesh.  A dry run builds its mesh on the `fake` process-group backend in one
process (`fake_world`): its collectives return at once and move nothing,
so no device is needed.

The constants are one H100 SXM's data-sheet figures (spec, not measured),
in place of the reference's TPU v5e ones.
"""
from __future__ import annotations

from datetime import timedelta

import torch

PEAK_FLOPS_BF16 = 989e12   # FLOP/s, dense bf16 tensor cores (spec, not measured)
HBM_BW = 3.35e12           # B/s of device memory (spec, not measured)
NVLINK_BW = 450e9          # B/s each way to the other cards of a host (spec, not measured)

#: seconds a rank waits for the others in the rendezvous and in a collective
#: before it raises, so that a rank that died fails the rest
WORLD_TIMEOUT = 120.0


def init_world(rank: int, world_size: int, device, store=None, *,
               timeout: float = WORLD_TIMEOUT) -> torch.device:
    """Join the default process group as `rank` of `world_size`: NCCL for a
    `cuda` device (which becomes this process's current device), gloo for
    a `cpu` one.  `store` is the rendezvous (a `TCPStore` on a port the OS
    picked, a `FileStore`, or a `PrefixStore` over one); None reads it from
    the environment (`MASTER_ADDR` / `MASTER_PORT`, as torchrun sets them).
    Returns the rank's device."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index if device.index is not None
                              else torch.cuda.current_device())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"init_world: no backend for device {device}")
    kw = {"init_method": "env://"} if store is None else {"store": store}
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout), **kw)
    return device


def fake_world(world_size: int) -> None:
    """Make the default process group one of `world_size` ranks on the
    `fake` backend, this process being rank 0 (a group of another size or
    backend is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A DeviceMesh of `shape` named `axes` over the default process group,
    whose world size must be the product of `shape`: on the CPU (gloo, or
    the fake backend) or, with device_type "cuda", on each rank's card."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 ranks) or 2x16x16 two pods (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
