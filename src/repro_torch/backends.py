"""Execution policy for the offline plane (ingest + query eval).

Two backends with identical semantics:

  * ``"host"``   — vectorized numpy;
  * ``"device"`` — the kernel layer: the query-eval driver and the ingest
    passes run on a torch device.  On a CUDA device every kernel on the
    path is a hand-written CUDA kernel (`repro_torch/csrc/`); on a CPU
    device the same driver runs each kernel's plain PyTorch version
    (what the CPU tests exercise).

The default is the device backend on ``cuda``.  A ``cuda`` request on a
machine without a usable CUDA device raises: the port never carries on
on the CPU unless the caller asks for it with ``device="cpu"``.

The device backend also takes a partition-axis plane of devices
(``ExecOptions.mesh``, or the ``REPRO_MESH`` environment variable for the
default ``"auto"``; resolved by `repro_torch.distributed.dataplane`):
sketch construction and query evaluation then split the partition axis
into one shard a device and launch each kernel once per shard.  Unset
(or ``0``/``off``) means the single-device path; a 1-device plane is
bit-identical to it.  The host backend ignores the plane.
"""
from __future__ import annotations

import dataclasses
import os

import torch

BACKENDS = ("host", "device")


def default_mesh_devices(device="cuda") -> int:
    """Partition-plane device count from ``REPRO_MESH`` for the device
    backend on ``device``.

    ``""``/``"0"``/``"off"``/``"none"`` → 0 (no plane: the single-device
    path); ``"auto"``/``"all"`` → every CUDA device (1 on a CPU device); an
    integer n → n (on CUDA at most the visible devices; on the CPU, n
    logical shards).
    """
    from repro_torch.distributed.dataplane import MESH_OFF

    env = os.environ.get("REPRO_MESH", "").strip().lower()
    if env in MESH_OFF:
        return 0
    cuda = torch.device(device).type == "cuda"
    available = torch.cuda.device_count() if cuda else None
    if env in ("auto", "all"):
        return available if cuda else 1
    n = int(env)
    if n < 1:
        raise ValueError(f"REPRO_MESH={n}: a plane needs at least one device")
    if cuda and n > available:
        raise ValueError(f"REPRO_MESH={n} but {available} device(s) are available")
    return n


@dataclasses.dataclass(frozen=True)
class ExecOptions:
    """Execution policy for every offline-plane entry point, in one value.

    Fields:
      * ``backend`` — ``"host"`` (numpy) or ``"device"`` (torch kernels);
      * ``device``  — the torch device of the device backend, ``"cuda"``
        by default (``"cuda:1"``, ``"cpu"``, ... also work);
      * ``parity_relaxation`` — opt-in allclose-not-bitwise device fast
        paths.  Default False keeps the bit-parity contract: every device
        result is byte-identical to host numpy.  True lets the GBDT
        boosting update stay on the device across trees (one transfer in
        and one out per fit; ``pred + lr·leaf`` is no longer the host's
        two roundings, and on the CPU the histograms are blocked one-hot
        matmuls) — the forest is allclose to the host fit, not bitwise
        equal;
      * ``faults`` — a `repro_torch.faults.FaultPolicy` (or None, the
        default: fault-free).  When set, the fault-aware read paths (the
        planner's chunk reads, `AnswerStore`'s exact reads) run each
        partition read through a deterministic seeded injector with
        retry, backoff and hedging; irrecoverable reads degrade the
        answer (planner) or raise `errors.PartitionReadError` (exact
        paths);
      * ``mesh`` — the partition-axis plane of the device backend:
        ``"auto"`` (the ``REPRO_MESH`` policy, the default),
        ``None``/``0``/``"off"`` (single device), an int device count
        (counted from ``device``: ``cuda:1`` with 2 is ``cuda:1``,
        ``cuda:2``; logical shards on the CPU), a device tuple (a repeated
        device holds several logical shards), or a `PartitionPlane`.
        ``device`` must be one of the plane's devices.

    Frozen and hashable: derive variants with `replace`.
    """

    backend: str = "device"
    device: str = "cuda"
    parity_relaxation: bool = False
    faults: object = None  # repro_torch.faults.FaultPolicy | None
    mesh: object = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}"
            )
        if isinstance(self.mesh, list):
            object.__setattr__(self, "mesh", tuple(self.mesh))

    def torch_device(self) -> torch.device:
        """The resolved device; raises on a CUDA request without CUDA."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ExecOptions(device={self.device!r}): CUDA is not available; "
                "pass device='cpu' to run the plain kernel versions"
            )
        return dev

    def plane(self):
        """The resolved `PartitionPlane` of the device backend, or None (the
        single-device path, and always on the host backend).  ``"auto"``
        reads ``REPRO_MESH`` at call time.  A plane that does not hold
        ``device`` raises: the work the backend runs on ``device`` and the
        plane's never quietly part."""
        if self.backend != "device":
            return None
        from repro_torch.distributed import dataplane

        plane = dataplane.resolve_plane(self.mesh, self.device)
        if plane is None:
            return None
        if plane.device_type != torch.device(self.device).type:
            raise ValueError(
                f"ExecOptions(device={self.device!r}) with a plane on "
                f"{plane.device_type} devices"
            )
        if dataplane.canonical_device(self.device) not in plane.devices:
            raise ValueError(
                f"ExecOptions(device={self.device!r}) is not a device of its plane "
                f"{[str(d) for d in plane.devices]}"
            )
        return plane

    def replace(self, **changes) -> "ExecOptions":
        return dataclasses.replace(self, **changes)
