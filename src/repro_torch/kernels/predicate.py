"""AND-of-ORs predicate row mask and per-partition passing count.

A row passes when, for every OR-group, at least one member clause holds
``lo <= x < hi`` on its column (NaN fails every test; with no OR-group
every row passes).  Bounds are per partition ``(P, C)`` or shared
``(C,)``; the clause→OR-group map is shared ``(C, G)`` or per partition
``(P, C, G)`` — the stacked-query driver packs one query per block of
partition rows, each with its own OR-group structure.

On a CUDA tensor `predicate_eval` launches ``repro_predicate_eval``
(`csrc/predicate.cu`); on a CPU tensor it runs `predicate_eval_plain`,
which is `fused.predicate_rows` plus a row count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused import MAX_CLAUSES, predicate_rows

_ROW_TILE = 256  # rows of one kernel block (csrc/predicate.cu kThreads)


def predicate_eval_plain(cols, lo, hi, group_map):
    p, c, _ = cols.shape
    if lo.dim() == 1:
        lo, hi = lo.expand(p, c), hi.expand(p, c)
    if group_map.dim() == 2:
        group_map = group_map.expand(p, *group_map.shape)
    mask = predicate_rows(cols, lo, hi, group_map)
    count = mask.sum(dim=1, dtype=torch.int64).to(torch.float32)
    return mask.to(torch.float32), count


def predicate_eval(
    cols: torch.Tensor,  # (P, C, R) f32 gathered clause columns
    lo: torch.Tensor,  # (P, C) or (C,) f32 inclusive lower bounds
    hi: torch.Tensor,  # (P, C) or (C,) f32 exclusive upper bounds
    group_map: torch.Tensor,  # (C, G) or (P, C, G) f32 one-hot clause→OR-group map
    num_groups: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (mask (P, R) f32 0/1, count (P,) f32) for the AND-of-ORs predicate."""
    name = "predicate_eval"
    p, c, r = cols.shape
    if lo.dim() not in (1, 2) or hi.shape != lo.shape or group_map.dim() not in (2, 3):
        raise ValueError(
            f"{name}: bounds must be (C,) or (P, C) and the map (C, G) or (P, C, G), got "
            f"lo {tuple(lo.shape)}, hi {tuple(hi.shape)}, map {tuple(group_map.shape)}"
        )
    if group_map.shape[-1] != num_groups:
        raise ValueError(f"{name}: map has {group_map.shape[-1]} groups, expected {num_groups}")
    if not _build.on_cuda(name, cols, lo, hi, group_map):
        return predicate_eval_plain(cols, lo, hi, group_map)
    if c > MAX_CLAUSES or num_groups > MAX_CLAUSES:
        raise ValueError(
            f"{name}: at most {MAX_CLAUSES} clauses and OR-groups, got C={c}, G={num_groups}"
        )
    g = num_groups
    bounds = (p, c) if lo.dim() == 2 else (c,)
    gshape = (p, c, g) if group_map.dim() == 3 else (c, g)
    dev = cols.device
    mask = torch.empty((p, r), dtype=torch.float32, device=dev)
    count = torch.empty((p,), dtype=torch.float32, device=dev)
    partial = torch.empty((p * -(-r // _ROW_TILE),), dtype=torch.int32, device=dev)
    lib = _build.library("predicate")
    f32 = torch.float32
    with _build.on_device(cols):
        err = lib.repro_predicate_eval(
            _build.pointer(name, "cols", cols, f32, (p, c, r)),
            _build.pointer(name, "lo", lo, f32, bounds),
            _build.pointer(name, "hi", hi, f32, bounds),
            _build.pointer(name, "group_map", group_map, f32, gshape),
            mask.data_ptr(), count.data_ptr(), partial.data_ptr(),
            *_build.sizes(name, p, c, g, r, c if lo.dim() == 2 else 0,
                          c * g if group_map.dim() == 3 else 0),
            _build.stream(cols),
        )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return mask, count
