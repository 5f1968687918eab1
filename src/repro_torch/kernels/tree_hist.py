"""GBDT gradient/hessian histograms and their prefix sums, for the device fit.

* `tree_hist(codes, feat_ids, node, g, h, num_nodes, num_feats, num_bins)`
  — (R, C) bin codes of the C sampled feature columns, their global
  feature ids, per-row level-node ids (-1 drops the row) and g, h →
  (2, num_nodes, num_feats, num_bins) f32 with
  ``out[{g,h}, node[r], feat_ids[c], codes[r, c]] += {g,h}[r]``.
  Unsampled features stay exactly 0; codes outside [0, num_bins) add
  nothing.
* `cumsum_seq(x)` — prefix sums over the last axis.

Both are bit-parity surfaces: the device fit must export the forest the
host fit does (`core/gbdt.py`), so every segment is summed as an f32
left fold in ascending row order — `np.add.at`'s order — and every
prefix sum as a left fold over the bins — `np.cumsum`'s order.  On a CUDA
tensor each wrapper launches its kernel in `csrc/tree_hist.cu`, which
keeps those orders without float atomics.  On a CPU tensor it runs its
plain version: `Tensor.index_add_` on a CPU tensor, which folds its
source in order (`torch.cumsum` on the CPU accumulates in f64 and so
rounds differently; the plain prefix sum is an explicit loop).  The
plain versions fold on the CPU whatever device their operands are on,
since a CUDA ``index_add_`` adds with atomics in no fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def tree_hist_plain(codes, feat_ids, node, g, h, num_nodes: int, num_feats: int,
                    num_bins: int = 256) -> torch.Tensor:
    dev = codes.device
    codes, feat_ids, node = codes.cpu().long(), feat_ids.cpu().long(), node.cpu().long()
    g, h = g.cpu().float(), h.cpu().float()
    r, c = codes.shape
    seg = (node[:, None] * num_feats + feat_ids[None, :]) * num_bins + codes
    keep = (node[:, None] >= 0) & (codes >= 0) & (codes < num_bins)
    seg = seg[keep]  # boolean indexing keeps row-major (row, column) order
    size = num_nodes * num_feats * num_bins
    out = torch.zeros((2, size), dtype=torch.float32)
    out[0].index_add_(0, seg, g[:, None].expand(r, c)[keep])
    out[1].index_add_(0, seg, h[:, None].expand(r, c)[keep])
    return out.reshape(2, num_nodes, num_feats, num_bins).to(dev)


def tree_hist(codes, feat_ids, node, g, h, num_nodes: int, num_feats: int,
              num_bins: int = 256) -> torch.Tensor:
    """(R, C) int32 codes, (C,) int32 feature ids, (R,) int32 nodes, (R,) f32
    g and h → (2, num_nodes, num_feats, num_bins) f32 histograms.

    The kernel reads the codes column by column: pass the transpose of a
    contiguous (C, R) tensor and no copy is made."""
    name = "tree_hist"
    r, c = codes.shape
    if not _build.on_cuda(name, codes, feat_ids, node, g, h):
        return tree_hist_plain(codes, feat_ids, node, g, h, num_nodes, num_feats, num_bins)
    out = torch.zeros((2, num_nodes, num_feats, num_bins), dtype=torch.float32,
                      device=codes.device)
    if r == 0 or c == 0:
        return out
    codes_t = codes.t().contiguous()
    lib = _build.library("tree_hist")
    err = lib.repro_tree_hist(
        _build.pointer(name, "codes", codes_t, torch.int32, (c, r)),
        _build.pointer(name, "feat_ids", feat_ids, torch.int32, (c,)),
        _build.pointer(name, "node", node, torch.int32, (r,)),
        _build.pointer(name, "g", g, torch.float32, (r,)),
        _build.pointer(name, "h", h, torch.float32, (r,)),
        out.data_ptr(), *_build.sizes(name, r, c, num_nodes, num_feats, num_bins),
        _build.stream(codes),
    )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out


def cumsum_seq_plain(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    out = torch.empty_like(x)
    run = torch.full(x.shape[:-1], -0.0, dtype=torch.float32, device=x.device)
    for b in range(x.shape[-1]):  # -0.0 + v == v for every v: out[0] = x[0]
        run = run + x[..., b]
        out[..., b] = run
    return out


def cumsum_seq(x: torch.Tensor) -> torch.Tensor:
    """(..., L) f32 → (..., L) f32 prefix sums, a left fold per row."""
    name = "cumsum_seq"
    if not _build.on_cuda(name, x):
        return cumsum_seq_plain(x)
    length = x.shape[-1]
    rows = x.numel() // max(length, 1)
    out = torch.empty_like(x, dtype=torch.float32)
    if x.numel() == 0:
        return out
    lib = _build.library("tree_hist")
    err = lib.repro_cumsum_seq(
        _build.pointer(name, "x", x, torch.float32, tuple(x.shape)), out.data_ptr(),
        *_build.sizes(name, rows, length), _build.stream(x),
    )
    _build.check(lib, name, err)
    _build.LAUNCHES.note(name)
    return out
