"""Pairwise squared distances of the KMeans assignment step: (N, F), (K, F) → (N, K).

    out[n, k] = max(‖x_n‖² + ‖c_k‖² − 2·x_n·c_k, 0)

the expansion the reference's KMeans inlines (`_pairwise_sq`) and its
Pallas kernel computes.  On a CUDA tensor `pdist_sq` launches
``repro_pdist_sq`` (`csrc/pdist.cu`); on a CPU tensor it runs
`pdist_sq_plain`, the reference expression in torch.  The plain
version's product runs in IEEE f32 (TF32 off), as the reference pins it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def pdist_sq_plain(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    c = centers.to(torch.float32)
    xx = torch.sum(x * x, dim=1)[:, None]
    cc = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp_min(xx + cc - 2.0 * (x @ c.T), 0.0)


def pdist_sq(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(N, F) f32 points + (K, F) f32 centers → (N, K) f32 squared distances."""
    name = "pdist_sq"
    n, f = x.shape
    k, fc = centers.shape
    if fc != f:
        raise ValueError(f"{name}: points have {f} features, centers {fc}")
    if not _build.on_cuda(name, x, centers):
        return pdist_sq_plain(x, centers)
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    lib = _build.library("pdist")
    with _build.on_device(x):
        err = lib.repro_pdist_sq(
            _build.pointer(name, "x", x, torch.float32, (n, f)),
            _build.pointer(name, "centers", centers, torch.float32, (k, f)),
            out.data_ptr(), *_build.sizes(name, n, k, f), _build.stream(x),
        )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out
