"""Production mesh builders (a function, never module-level state).

The port's counterpart of `repro.launch.mesh`: a mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the reference's axis names,
("data", "model") at 16 x 16 and ("pod", "data", "model") at 2 x 16 x 16.
Building one needs a default process group of as many ranks.  One real card
builds no mesh: the port runs with `models.dist.set_mesh(None)`, as the
reference runs without a mesh.  A dry run builds its mesh on the `fake`
process-group backend in one process (`fake_world`): its collectives
return at once and move nothing, so no device is needed.

The constants are one H100 SXM's data-sheet figures (spec, not measured),
in place of the reference's TPU v5e ones.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12   # FLOP/s, dense bf16 tensor cores (spec, not measured)
HBM_BW = 3.35e12           # B/s of device memory (spec, not measured)
NVLINK_BW = 450e9          # B/s each way to the other cards of a host (spec, not measured)


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


def make_mesh(shape, axes):
    """A CPU DeviceMesh of `shape` named `axes` over the default process
    group, whose world size must be the product of `shape`."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 ranks) or 2x16x16 two pods (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
