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
"""
from __future__ import annotations

import dataclasses

import torch

BACKENDS = ("host", "device")


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
        paths).

    Frozen and hashable: derive variants with `replace`.
    """

    backend: str = "device"
    device: str = "cuda"
    parity_relaxation: bool = False
    faults: object = None  # repro_torch.faults.FaultPolicy | None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; expected one of {BACKENDS}"
            )

    def torch_device(self) -> torch.device:
        """The resolved device; raises on a CUDA request without CUDA."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ExecOptions(device={self.device!r}): CUDA is not available; "
                "pass device='cpu' to run the plain kernel versions"
            )
        return dev

    def replace(self, **changes) -> "ExecOptions":
        return dataclasses.replace(self, **changes)
