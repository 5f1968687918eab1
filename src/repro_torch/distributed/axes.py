"""Logical-axis sharding constraints for model internals, and the axis
vocabulary every sharding rule of the port shares.

Model code calls ``constrain(x, "batch", None, "model")`` at propagation
choke points (post-embed activations, the CE logits chunks, each block's
output, the MoE expert buffers), as the reference (`repro.distributed.
axes`) does.  A training launcher activates the axes with
``set_logical_axes(mesh.mesh_dim_names)``; without activation every
constraint is the identity after one branch, so the model code stays
mesh-agnostic and the single-device paths pay nothing more.

With axes active, a `torch.distributed.tensor.DTensor` is redistributed
to the tags' placements on its own ``device_mesh``; a plain tensor is
returned as it is (it lives on one device: there is nothing to shard).
"batch" maps to the live data-parallel axes (``("pod", "data")``, or the
one that is live), "seq" to "model" (sequence parallelism), "partition"
to `PARTITION_AXIS`, and "model"/"data" to themselves when live.  A
dimension whose size does not divide its axes' product falls back to
replication, dimension by dimension, as in the reference.
"""
from __future__ import annotations

import math

# The offline data plane's partition axis (`distributed/dataplane.py`).
PARTITION_AXIS = "part"

_ACTIVE: tuple[str, ...] = ()


def set_logical_axes(axis_names) -> None:
    global _ACTIVE
    _ACTIVE = tuple(axis_names)


def active() -> tuple[str, ...]:
    return _ACTIVE


def _resolve(tag):
    """A logical tag → a live mesh axis name, a tuple of them, or None."""
    if tag is None:
        return None
    if tag == "batch":
        dp = tuple(a for a in ("pod", "data") if a in _ACTIVE)
        return dp if len(dp) > 1 else (dp[0] if dp else None)
    if tag == "partition":
        return PARTITION_AXIS if PARTITION_AXIS in _ACTIVE else None
    if tag == "seq":
        # sequence parallelism: activations S-sharded on the tensor axis in
        # the residual regions (Megatron SP)
        return "model" if "model" in _ACTIVE else None
    return tag if tag in _ACTIVE else None


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh` (by its ``mesh_dim_names``) or
    of a plain ``{axis: size}`` mapping, in mesh-dimension order."""
    if hasattr(mesh, "mesh_dim_names"):
        return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
    return dict(mesh)


def placements(spec, mesh) -> tuple:
    """A spec (one entry a tensor dimension: an axis name, a tuple of
    names or None) → one `Shard(dim)` or `Replicate()` a mesh dimension.
    A dimension over several axes (``("pod", "data")``) is sharded over
    each of them, the first the outermost, as a `PartitionSpec` is."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh_shape(mesh):
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def constrain(x, *tags):
    if not _ACTIVE:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    sizes = mesh_shape(mesh)
    axes = [_resolve(t) for t in tags] + [None] * (x.ndim - len(tags))
    spec = []
    for dim, ax in zip(x.shape, axes[: x.ndim]):
        names = ax if isinstance(ax, tuple) else (ax,)
        if ax is None or any(n not in sizes for n in names) \
                or dim % math.prod(sizes[n] for n in names) != 0:
            spec.append(None)
        else:
            spec.append(ax)
    return x.redistribute(mesh, placements(spec, mesh))
