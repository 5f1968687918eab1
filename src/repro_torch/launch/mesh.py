"""Production meshes and the H100's roofline constants.

The reference's `repro.launch.mesh` for the port.  ``production_mesh_shape``
is the mesh as the sharding rules read it (``{axis: size}``, which
`distributed.sharding` takes as it takes a `DeviceMesh`);
``make_production_mesh`` builds a `DeviceMesh` of those 256 or 512 ranks
on a *fake* process group (`torch.testing._internal.distributed.fake_pg`):
every collective is a no-op that returns at once, so one process traces
what each rank of the group would run.  `fake_group` owns that group; it
refuses to start where a process group exists and always destroys its
own, so a fake group never meets a real ``gloo`` or ``nccl`` one.  Run it
in a process of its own (`launch.dryrun` does).

The data plane's 1-D partition-axis mesh (the reference's
``make_data_plane_mesh``) is `distributed.dataplane.PartitionPlane`.
"""
from __future__ import annotations

import contextlib
import math

# NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi --query-gpu=name,power.limit):
# dense bf16 tensor-core peak of the SXM part, without sparsity (NVIDIA's
# H100 data sheet)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s per GPU
# NVIDIA H100 80GB HBM3, 700.00 W: HBM3 bandwidth (the same data sheet)
HBM_BW = 3.35e12  # bytes/s per GPU
# NVIDIA H100 80GB HBM3, 700.00 W: one link term per GPU for the
# collectives.  A 16-wide mesh axis spans two 8-GPU nodes (the "model"
# axis: ranks 16i..16i+15) or sixteen of them (the "data" axis, stride 16),
# so every ring crosses the inter-node fabric, whose slowest link is one
# 400 Gb/s NDR InfiniBand port per GPU (a DGX/HGX H100 node's eight
# ConnectX-7 compute ports): 50 GB/s each way.  NVLink 4 (450 GB/s each
# way per GPU) carries only the intra-node hops, so the ring runs at the
# InfiniBand rate.
LINK_BW = 50e9  # bytes/s per GPU, one direction


def production_mesh_shape(multi_pod: bool = False) -> dict:
    """{axis: size} of the production mesh: 16 × 16, or 2 × 16 × 16 pods."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the duration of the block.  Raises where a process group exists
    (a real one must never be replaced, nor a fake one leak into it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists in this process: run the fake "
                           "group in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: dict, device: str = "cuda"):
    """A `DeviceMesh` of ``shape`` ({axis: size}) over the ranks of the
    current (fake) process group, whose size must be their product."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape.values())
    ranks = torch.arange(n).reshape(tuple(shape.values()))
    return DeviceMesh(torch.device(device).type, ranks, mesh_dim_names=tuple(shape))


def make_production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """The 256- or 512-rank production `DeviceMesh`, inside `fake_group`."""
    return make_mesh(production_mesh_shape(multi_pod), device)
