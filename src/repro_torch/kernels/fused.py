"""Fused predicate eval + masked group aggregation in one launch.

Each row passes the AND-of-OR-groups predicate when, for every OR-group,
at least one member clause holds ``lo <= x < hi`` on its column (NaN
fails every test); passing rows are then segment-summed by group code
exactly as `groupagg.group_aggregate` does.  The row mask never leaves
the kernel.

On a CUDA tensor `fused_eval` launches ``repro_fused_eval``
(`csrc/eval.cu`); on a CPU tensor it runs `fused_eval_plain`, the same
function in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.groupagg import MAX_COMPONENTS, blocked_onehot_aggregate

MAX_CLAUSES = 64  # clause bits of one row: one 64-bit word in the kernel


def predicate_rows(cols, lo, hi, group_map) -> torch.Tensor:
    """(B, C, R) columns, (B, C) bounds, (B, C, G) map → (B, R) bool mask."""
    x = cols.to(torch.float32)
    clause = (x >= lo[:, :, None]) & (x < hi[:, :, None])  # (B, C, R)
    member = group_map > 0  # (B, C, G)
    mask = torch.ones((x.shape[0], x.shape[2]), dtype=torch.bool, device=x.device)
    for g in range(member.shape[2]):  # AND over OR-groups
        mask &= (clause & member[:, :, g, None]).any(dim=1)
    return mask


def fused_eval_plain(cols, lo, hi, group_map, values, codes, num_groups: int):
    mask = predicate_rows(cols, lo, hi, group_map)
    masked = values.to(torch.float32) * mask[:, None, :]
    mcodes = torch.where(mask, codes.to(torch.int32), -1)
    return blocked_onehot_aggregate(masked, mcodes, num_groups)


def fused_eval(
    cols: torch.Tensor,  # (B, C, R) f32 gathered clause columns
    lo: torch.Tensor,  # (B, C) f32 inclusive lower bounds
    hi: torch.Tensor,  # (B, C) f32 exclusive upper bounds
    group_map: torch.Tensor,  # (B, C, G) f32 one-hot clause→OR-group map
    values: torch.Tensor,  # (B, V, R) f32 aggregate components
    codes: torch.Tensor,  # (B, R) int32 group codes
    num_groups: int,
) -> torch.Tensor:
    """→ (B, V, num_groups) f32 predicate-masked segment sums."""
    name = "fused_eval"
    if not _build.on_cuda(name, cols, lo, hi, group_map, values, codes):
        return fused_eval_plain(cols, lo, hi, group_map, values, codes, num_groups)
    b, c, r = cols.shape
    g = group_map.shape[2]
    v = values.shape[1]
    if c > MAX_CLAUSES or g > MAX_CLAUSES or v > MAX_COMPONENTS:
        raise ValueError(
            f"{name}: at most {MAX_CLAUSES} clauses/OR-groups and {MAX_COMPONENTS} "
            f"components, got C={c}, G={g}, V={v}"
        )
    out = torch.empty((b, v, num_groups), dtype=torch.float32, device=cols.device)
    lib = _build.library("eval")
    f32 = torch.float32
    err = lib.repro_fused_eval(
        _build.pointer(name, "cols", cols, f32, (b, c, r)),
        _build.pointer(name, "lo", lo, f32, (b, c)),
        _build.pointer(name, "hi", hi, f32, (b, c)),
        _build.pointer(name, "group_map", group_map, f32, (b, c, g)),
        _build.pointer(name, "values", values, f32, (b, v, r)),
        _build.pointer(name, "codes", codes, torch.int32, (b, r)),
        out.data_ptr(), *_build.sizes(name, b, c, g, v, r, num_groups), _build.stream(cols),
    )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out
