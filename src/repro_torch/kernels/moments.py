"""Fused moments pass of the sketch ingest: (P, R) → (P, 8).

Per partition, in one read of the column: min, max, Σx, Σx² of x and the
same four of log(max(x, 1e-30)).  min and max propagate NaN.  A 0-row
operand is rejected, as the reference does.

On a CUDA tensor `moments` launches ``repro_moments`` (`csrc/ingest.cu`);
on a CPU tensor it runs `moments_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NSTATS = 8  # min, max, sum, sumsq, logmin, logmax, logsum, logsumsq
_TINY = 1e-30


def moments_plain(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    lx = torch.log(torch.maximum(x, torch.tensor(_TINY, dtype=torch.float32, device=x.device)))
    return torch.stack(
        [
            x.amin(dim=1), x.amax(dim=1), x.sum(dim=1), (x * x).sum(dim=1),
            lx.amin(dim=1), lx.amax(dim=1), lx.sum(dim=1), (lx * lx).sum(dim=1),
        ],
        dim=1,
    )


def moments(x: torch.Tensor) -> torch.Tensor:
    """(P, R) f32 values → (P, NSTATS) f32 fused measure statistics."""
    name = "moments"
    p, r = x.shape
    if r == 0:
        raise ValueError(f"{name}: a partition with 0 rows has no moments")
    if not _build.on_cuda(name, x):
        return moments_plain(x)
    out = torch.empty((p, NSTATS), dtype=torch.float32, device=x.device)
    lib = _build.library("ingest")
    with _build.on_device(x):
        err = lib.repro_moments(
            _build.pointer(name, "x", x, torch.float32, (p, r)), out.data_ptr(),
            *_build.sizes(name, p, r), _build.stream(x),
        )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out
