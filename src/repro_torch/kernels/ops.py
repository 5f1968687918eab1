"""Entry points of the kernel layer, named as the reference's `kernels/ops.py`.

Each entry point takes torch tensors and picks its version from where
they lie: a CUDA tensor launches the hand-written CUDA kernel, a CPU
tensor runs the kernel's plain PyTorch version.  There is no ``use_ref``
switch and no fallback from one to the other.

Every Pallas kernel of the reference has its counterpart here:
fused_eval, group_aggregate, predicate_eval, moments, histogram_range,
bincount, tree_hist and pdist_sq.
"""
from __future__ import annotations

from repro_torch.kernels.fused import fused_eval as fused_eval_op
from repro_torch.kernels.groupagg import group_aggregate as group_aggregate_op
from repro_torch.kernels.histogram import bincount as bincount_op
from repro_torch.kernels.histogram import histogram_range as histogram_range_op
from repro_torch.kernels.moments import moments as moments_op
from repro_torch.kernels.pdist import pdist_sq as pdist_sq_op
from repro_torch.kernels.predicate import predicate_eval as predicate_eval_op
from repro_torch.kernels.tree_hist import tree_hist as tree_hist_op

__all__ = [
    "moments_op",
    "histogram_range_op",
    "bincount_op",
    "group_aggregate_op",
    "predicate_eval_op",
    "fused_eval_op",
    "tree_hist_op",
    "pdist_sq_op",
]
