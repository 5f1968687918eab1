"""Masked group aggregation: (P, V, R) values → (P, V, num_groups) sums.

    out[p, v, g] = Σ_r values[p, v, r] · mask[p, r] · 1[codes[p, r] = g]

On a CUDA tensor `group_aggregate` launches ``repro_group_aggregate``
(`csrc/groupagg.cu`: lanes own rows, equal codes of a 32-row slice are
summed by a fixed tree, warp-private accumulators over the whole radix;
no float atomics, and a stack row's sums depend only on that row); on a
CPU tensor it runs `group_aggregate_plain`, which
contracts row-tile one-hots like the reference's
`kernels/ref.py::blocked_onehot_aggregate`.  Rows with a zero mask or a
code outside ``[0, num_groups)`` contribute nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# elements of one (P, tile, num_groups) one-hot in the plain versions
ONEHOT_ELEMS = 1 << 26
MAX_COMPONENTS = 32  # the kernel takes components in tiles of 4, up to 8 tiles


def blocked_onehot_aggregate(values: torch.Tensor, codes: torch.Tensor,
                             num_groups: int) -> torch.Tensor:
    """(P, V, R) values, (P, R) codes (-1 = dropped) → (P, V, num_groups).

    Row tiles are contracted as one-hot matmuls, so no scatter is needed
    and memory stays bounded by ``ONEHOT_ELEMS``.  On a CUDA device the
    caller keeps f32 matmuls in IEEE f32 (no TF32), or the sums lose
    their low bits.
    """
    p, v, r = values.shape
    out = torch.zeros((p, v, num_groups), dtype=torch.float32, device=values.device)
    bins = torch.arange(num_groups, dtype=codes.dtype, device=codes.device)
    bt = max(1, min(r, ONEHOT_ELEMS // max(p * num_groups, 1)))
    for s in range(0, r, bt):
        onehot = (codes[:, s : s + bt, None] == bins).to(torch.float32)  # (P, bt, G)
        out += torch.bmm(values[:, :, s : s + bt].to(torch.float32), onehot)
    return out


def group_aggregate_plain(values, mask, codes, num_groups: int) -> torch.Tensor:
    keep = mask != 0
    masked = values.to(torch.float32) * mask.to(torch.float32)[:, None, :]
    mcodes = torch.where(keep, codes.to(torch.int32), -1)
    return blocked_onehot_aggregate(masked, mcodes, num_groups)


def group_aggregate(values: torch.Tensor, mask: torch.Tensor, codes: torch.Tensor,
                    num_groups: int) -> torch.Tensor:
    """(P, V, R) f32 values, (P, R) f32 mask, (P, R) int32 codes →
    (P, V, num_groups) f32 masked segment sums."""
    name = "group_aggregate"
    if not _build.on_cuda(name, values, mask, codes):
        return group_aggregate_plain(values, mask, codes, num_groups)
    p, v, r = values.shape
    if v > MAX_COMPONENTS:
        raise ValueError(f"{name}: at most {MAX_COMPONENTS} components, got V={v}")
    out = torch.empty((p, v, num_groups), dtype=torch.float32, device=values.device)
    lib = _build.library("groupagg")
    err = lib.repro_group_aggregate(
        _build.pointer(name, "values", values, torch.float32, (p, v, r)),
        _build.pointer(name, "mask", mask, torch.float32, (p, r)),
        _build.pointer(name, "codes", codes, torch.int32, (p, r)),
        out.data_ptr(), *_build.sizes(name, p, v, r, num_groups), _build.stream(values),
    )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out
