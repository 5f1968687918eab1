"""Counting passes of the sketch ingest: equi-depth histograms and bincounts.

* `histogram_range(x, edges)` — (P, R) values against per-partition
  edges (P, B+1) → (P, B) counts.  Bucket k holds ``lo_k <= x < hi_k``;
  the last bucket also holds ``x == hi``; values outside the edges and
  NaN count nowhere.
* `bincount(codes, card)` — (P, R) int codes → (P, card) exact counts;
  codes outside ``[0, card)`` (-1 = padding) count nowhere.

Counts are exact integers returned as f32 (exact below 2^24 rows).  On a
CUDA tensor each wrapper launches its kernel in `csrc/ingest.cu` (for
histogram_range, an instance compiled for B up to 16, the general kernel
up to B = 4096); on a CPU tensor it runs its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# elements of one (P, tile, bins) compare block in the plain versions
COMPARE_ELEMS = 1 << 26


def histogram_range_plain(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    lo = edges[:, :-1].to(torch.float32)[:, None, :]  # (P, 1, B)
    hi = edges[:, 1:].to(torch.float32)[:, None, :]
    xt = x[:, :, None]
    inb = (xt >= lo) & (xt < hi)
    last = (xt >= lo[:, :, -1:]) & (xt <= hi[:, :, -1:])
    sel = torch.cat([inb[:, :, :-1], last], dim=2)
    return sel.sum(dim=1).to(torch.float32)


def histogram_range(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(P, R) f32 values + (P, B+1) f32 edges → (P, B) f32 bucket counts."""
    name = "histogram_range"
    p, r = x.shape
    nb = edges.shape[1] - 1
    if nb < 1:
        raise ValueError(f"{name}: need at least 2 edges, got {edges.shape[1]}")
    if not _build.on_cuda(name, x, edges):
        return histogram_range_plain(x, edges)
    out = torch.empty((p, nb), dtype=torch.float32, device=x.device)
    lib = _build.library("ingest")
    with _build.on_device(x):
        err = lib.repro_histogram_range(
            _build.pointer(name, "x", x, torch.float32, (p, r)),
            _build.pointer(name, "edges", edges, torch.float32, (p, nb + 1)),
            out.data_ptr(), *_build.sizes(name, p, r, nb), _build.stream(x),
        )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out


def bincount_plain(codes: torch.Tensor, card: int) -> torch.Tensor:
    p, r = codes.shape
    bins = torch.arange(card, dtype=codes.dtype, device=codes.device)
    out = torch.zeros((p, card), dtype=torch.int64, device=codes.device)
    bt = max(1, min(r, COMPARE_ELEMS // max(p * card, 1)))
    for s in range(0, r, bt):
        out += (codes[:, s : s + bt, None] == bins).sum(dim=1)
    return out.to(torch.float32)


def bincount(codes: torch.Tensor, card: int) -> torch.Tensor:
    """(P, R) int32 codes in [0, card) → (P, card) f32 exact counts."""
    name = "bincount"
    if card < 1:
        raise ValueError(f"{name}: card must be >= 1, got {card}")
    if not _build.on_cuda(name, codes):
        return bincount_plain(codes, card)
    p, r = codes.shape
    out = torch.empty((p, card), dtype=torch.float32, device=codes.device)
    lib = _build.library("ingest")
    with _build.on_device(codes):
        err = lib.repro_bincount(
            _build.pointer(name, "codes", codes, torch.int32, (p, r)), out.data_ptr(),
            *_build.sizes(name, p, r, card), _build.stream(codes),
        )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out
