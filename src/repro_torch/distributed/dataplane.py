"""Partition-axis data plane: per-shard ingest and query eval over devices.

The partition is the paper's unit of work: sketch construction and
per-partition query answers split along the partition axis.  So the
multi-device story is one sharding rule: bulk tensors keep their
single-device layout except the partition axis, which is zero-padded up
to a multiple of the plane's size and split into equal shards, shard s
on ``plane.devices[s]``.  Each kernel launch then runs once per shard on
that shard's partitions, at local shapes, through the same wrappers as
the single-device path (`queries/device.py`, `core/ingest.py`).  Only
the small per-partition results (moments, counts, answers) come back to
the host, concatenated in shard order.

A shard is a plain tensor on its own `torch.device`; a sharded tensor is
the ordered tuple of its shards (`ShardedTensor`); a per-shard launch is
a loop over the shards (`sharded_call`).  A plane may name one device
several times (``("cuda:0",) * 3``): its shards are then logical, on one
device, and every split, pad, per-shard launch and gather runs as on
separate devices.

Correctness contract (the reference's, `src/repro/distributed/dataplane.py`):

  * **Bit parity.**  Each partition's reductions run in one launch with
    unchanged per-partition work and fold order, so plane results are
    bit-identical to the single-device path; a 1-device plane is that
    path behind one shard.
  * **Padding is masked, never aggregated.**  Pad partitions are all
    zero, their ones-column included, and `gather` slices them off
    before anything reads them.
  * **Bounded launch keys.**  Launch keys are taken at local shapes, and
    the set a workload launches has the same cardinality on every plane.

Plane resolution (`resolve_plane`, the one parser of a spec): an
explicit spec (an int, a device tuple or a `PartitionPlane`) >
``REPRO_MESH`` for ``"auto"`` (`repro_torch.backends.default_mesh_devices`)
> no plane (`MESH_OFF`).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core.clustering import bucket_size
from repro_torch.distributed.axes import PARTITION_AXIS
from repro_torch.kernels.telemetry import TraceRegistry

__all__ = [
    "MESH_OFF", "PARTITION_AXIS", "PartitionPlane", "ShardedTensor", "TRACES",
    "canonical_device", "plane_of", "resolve_plane", "sharded_call", "write_partitions",
]

# plane specs (and ``REPRO_MESH`` values) that mean no plane
MESH_OFF = ("", "0", "off", "none")


def canonical_device(d) -> torch.device:
    """``d`` as a `torch.device`, an unnumbered ``cuda`` as ``cuda:0``."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


@dataclasses.dataclass(frozen=True)
class PartitionPlane:
    """An ordered tuple of devices over the partition axis, one shard each.

    The handle every plane-aware entry point reads from
    ``ExecOptions.plane()`` (`build_statistics`, `build_sketches`,
    `EvalCache`, `AnswerStore`): partition-axis tensors are zero-padded
    to a multiple of `num_devices` and split (`shard_partitions`), each
    launch runs once per shard (`sharded_call`), and per-partition results
    come back through `gather` with the pad sliced off.  A device may
    repeat: its shards are then logical shards of one device.  A CUDA
    device the process cannot see raises; nothing runs elsewhere instead.
    """

    devices: tuple

    def __post_init__(self):
        devs = tuple(canonical_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a partition plane needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a partition plane on mixed device types: {devs}")
        if devs[0].type == "cuda":
            count = torch.cuda.device_count()
            missing = sorted({d.index for d in devs if d.index >= count})
            if missing:
                raise ValueError(
                    f"partition plane on cuda:{missing} but {count} CUDA device(s) "
                    "are available"
                )
        object.__setattr__(self, "devices", devs)

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def padded(self, num_partitions: int) -> int:
        """P rounded up to a multiple of the plane's size (equal shards; the
        pad partitions are all zero and masked)."""
        d = self.num_devices
        return -(-num_partitions // d) * d

    def local(self, num_partitions: int) -> int:
        """Partitions a shard holds: the P every per-shard launch sees."""
        return self.padded(num_partitions) // self.num_devices

    def shard_partitions(self, arr: np.ndarray, axis: int = 0,
                         target: int | None = None) -> "ShardedTensor":
        """Zero-pad ``axis`` (the partition axis) of a host array to a plane
        multiple and place shard s on ``devices[s]``: one host→device copy
        of each shard's real partitions, the pad zero-filled on the device.

        ``target`` asks for zero slack beyond the array's own partitions
        (rounded up to a plane multiple too): the device column stack pads
        to its shape bucket so appends write into the slack in place
        (`queries.engine.EvalCache.device_stack`)."""
        arr = np.asarray(arr)
        p = arr.shape[axis]
        local = self.local(max(p, target or 0))
        shards = []
        for s, dev in enumerate(self.devices):
            shape = list(arr.shape)
            shape[axis] = local
            shard = torch.zeros(shape, dtype=_torch_dtype(arr.dtype), device=dev)
            lo, hi = s * local, min((s + 1) * local, p)
            if hi > lo:
                _copy_in(shard.narrow(axis, 0, hi - lo), _range(arr, axis, lo, hi), axis)
            shards.append(shard)
        return ShardedTensor(tuple(shards), axis)

    def gather(self, parts, num_partitions: int, axis: int = 0) -> np.ndarray:
        """Per-shard results → one host array, the shards concatenated in
        order along ``axis`` and the pad partitions sliced off."""
        out = torch.cat([t.cpu() for t in parts], dim=axis).numpy()
        sl = [slice(None)] * out.ndim
        sl[axis] = slice(0, num_partitions)
        return out[tuple(sl)]


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _range(arr: np.ndarray, axis: int, lo: int, hi: int) -> np.ndarray:
    """Partitions [lo, hi) of a host array along ``axis``, as a view."""
    sl = [slice(None)] * arr.ndim
    sl[axis] = slice(lo, hi)
    return arr[tuple(sl)]


def _copy_in(dst: torch.Tensor, src: np.ndarray, axis: int) -> None:
    """Host → device copy of a partition range.  A range along axis 1 of a
    column stack goes one contiguous column at a time, so the host never
    gathers it first."""
    if axis == 1 and not src.flags.c_contiguous:
        for i in range(src.shape[0]):
            dst[i].copy_(torch.from_numpy(np.ascontiguousarray(src[i])))
    else:
        dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))


@dataclasses.dataclass(frozen=True)
class ShardedTensor:
    """A tensor split along ``axis`` into equal shards, shard s on the
    plane's ``devices[s]``; ``shape`` is the padded global shape."""

    shards: tuple
    axis: int

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.shards[0].shape)
        shape[self.axis] = sum(t.shape[self.axis] for t in self.shards)
        return tuple(shape)

    @property
    def local(self) -> int:
        return self.shards[0].shape[self.axis]


# --------------------------------------------------------------------------
# plane resolution (explicit spec > REPRO_MESH > off)
# --------------------------------------------------------------------------
def plane_of(num_devices: int, device="cuda") -> PartitionPlane:
    """``num_devices`` devices counted from ``device``: ``cuda:k`` ..
    ``cuda:k+n-1`` for ``cuda:k`` (a range past the visible CUDA devices
    raises), or n logical CPU shards."""
    if num_devices < 1:
        raise ValueError(f"a partition plane needs at least one device, got {num_devices}")
    dev = canonical_device(device)
    if dev.type == "cpu":
        return PartitionPlane(("cpu",) * num_devices)
    if dev.type != "cuda":
        raise ValueError(f"no partition plane on {dev.type!r} devices")
    count = torch.cuda.device_count()
    if dev.index + num_devices > count:
        raise ValueError(
            f"a partition plane of {num_devices} CUDA devices from {dev} but {count} are "
            "available"
        )
    return PartitionPlane(tuple(f"cuda:{i}" for i in range(dev.index, dev.index + num_devices)))


def resolve_plane(spec="auto", device="cuda") -> PartitionPlane | None:
    """Normalize a plane spec for the device backend on ``device``: None, 0
    and the `MESH_OFF` words → the single-device path; ``"auto"`` → the
    ``REPRO_MESH`` policy (``auto``/``all`` there: every device of
    ``device``'s type); an int n → n devices counted from ``device``; a
    device tuple → those devices (repeats are logical shards); a
    `PartitionPlane` passes through."""
    if isinstance(spec, PartitionPlane):
        return spec
    if spec is None or (isinstance(spec, (int, np.integer)) and not isinstance(spec, bool)
                        and spec == 0):
        return None
    if isinstance(spec, str):
        word = spec.strip().lower()
        if word in MESH_OFF:
            return None
        if word == "auto":
            from repro_torch.backends import default_mesh_devices

            n = default_mesh_devices(device)
            if not n:
                return None
            every = os.environ.get("REPRO_MESH", "").strip().lower() in ("auto", "all")
            return plane_of(n, torch.device(device).type if every else device)
    if isinstance(spec, (int, np.integer)) and not isinstance(spec, bool):
        return plane_of(int(spec), device)
    if isinstance(spec, (tuple, list)):
        return PartitionPlane(tuple(spec))
    raise ValueError(f"bad partition-plane spec {spec!r}")


# --------------------------------------------------------------------------
# per-shard launches
# --------------------------------------------------------------------------
def sharded_call(plane: PartitionPlane, fn, sharded, replicated=()) -> list:
    """``fn(*shard_operands, *replicated)`` once per shard, in shard order
    → the per-shard results, left on their devices.

    ``sharded`` holds the partition-split operands (`ShardedTensor`s, or
    per-shard sequences); ``replicated`` the small operands every shard
    reads (descriptors: numpy arrays or tensors), copied to each distinct
    device once per call.  Every shard's launch is issued before anything
    is read back, so shards on separate devices run at once."""
    per_device = {}
    for dev in dict.fromkeys(plane.devices):
        per_device[dev] = tuple(
            (torch.from_numpy(a) if isinstance(a, np.ndarray) else a).to(dev)
            for a in replicated
        )
    shard_ops = [getattr(x, "shards", x) for x in sharded]
    return [
        fn(*ops, *per_device[dev])
        for dev, ops in zip(plane.devices, zip(*shard_ops), strict=True)
    ]


# --------------------------------------------------------------------------
# streaming append: write new partitions into a buffer's reserved slack
# --------------------------------------------------------------------------
TRACES = TraceRegistry("dataplane")


def write_partitions(buf, delta: np.ndarray, start: int, axis: int = 0,
                     plane: PartitionPlane | None = None):
    """Write the host array ``delta`` into ``buf`` at offset ``start``
    along the partition axis, in place → ``buf``: the O(delta) device-side
    append behind the streaming plane.

    ``buf`` is one device tensor (``plane`` None) or a `ShardedTensor` on
    ``plane``; it keeps its shape, so the caller must have reserved slack
    (a padded shape bucket) for the delta.  A write whose range crosses a
    shard boundary is split: each shard receives the part of the range it
    holds.  An overlong write raises.

    The launch key (`TRACES`) takes the delta's partition count padded up
    to a power-of-two bucket where the padded write still fits the slack,
    and the exact count otherwise, as the reference's write does; the pad
    region, beyond the delta in the slack, is zero-filled on the device.
    """
    delta = np.asarray(delta)
    shards = (buf,) if plane is None else buf.shards
    size = sum(t.shape[axis] for t in shards)
    d = delta.shape[axis]
    if start + d > size:
        raise ValueError("append exceeds the buffer's reserved slack")
    db = bucket_size(d, minimum=1)
    span = db if d and start + db <= size else d
    shape = list(shards[0].shape)
    shape[axis] = size
    TRACES.note("write_partitions", axis, *shape, span)
    local = shards[0].shape[axis]
    for s, shard in enumerate(shards):
        lo, hi = max(start, s * local), min(start + span, (s + 1) * local)
        if hi <= lo:
            continue
        dst = shard.narrow(axis, lo - s * local, hi - lo)
        real = min(hi, start + d) - lo  # the delta's rows; the rest is pad
        if real > 0:
            _copy_in(dst.narrow(axis, 0, real),
                     _range(delta, axis, lo - start, lo - start + real), axis)
        real = max(real, 0)
        if real < hi - lo:
            dst.narrow(axis, real, hi - lo - real).zero_()
    return buf
