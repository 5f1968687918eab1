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
        by default (``"cuda:1"``, ``"cpu"``, ... also work).

    Frozen: derive variants with `replace`.
    """

    backend: str = "device"
    device: str = "cuda"

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
