"""Outlier-partition identification (paper §4.4).

Partitions with a *rare distribution of groups* are excluded from
clustering and evaluated exactly (weight 1).  Rarity is judged on the
occurrence-bitmap feature of the query's GROUP BY columns: partitions with
identical bitmaps form a bitmap group; a group is outlying iff it is small
in absolute terms (< ABS_LIMIT partitions) AND relative terms
(< REL_LIMIT × the largest group).  At most `outlier_frac` of the sampling
budget is spent; smallest bitmap groups are taken first.
"""
from __future__ import annotations

import numpy as np

ABS_LIMIT = 10
REL_LIMIT = 0.10
DEFAULT_OUTLIER_FRAC = 0.10


def bitmap_keys(bitmaps: np.ndarray) -> np.ndarray:
    """Collapse (N, K) 0/1 bitmap rows into hashable integer keys."""
    n, k = bitmaps.shape
    if k == 0:
        return np.zeros(n, np.int64)
    # pack bits (K <= 25 per column but multiple columns may concatenate)
    out = np.zeros(n, np.uint64)
    for j in range(k):
        out = out * np.uint64(31) + bitmaps[:, j].astype(np.uint64) + np.uint64(1)
    return out.astype(np.int64)


def find_outliers(
    candidate_ids: np.ndarray,
    gb_bitmaps: np.ndarray,
    max_outliers: int,
    abs_limit: int = ABS_LIMIT,
    rel_limit: float = REL_LIMIT,
) -> np.ndarray:
    """Returns ids (subset of candidate_ids) of outlier partitions.

    gb_bitmaps: (len(candidate_ids), K) concatenated occurrence bitmaps of
    the query's group-by columns.
    """
    if max_outliers <= 0 or gb_bitmaps.shape[1] == 0 or candidate_ids.size == 0:
        return np.empty(0, np.int64)
    keys = bitmap_keys(gb_bitmaps)
    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    largest = counts.max()
    outlying = (counts < abs_limit) & (counts < rel_limit * largest)
    if not outlying.any():
        return np.empty(0, np.int64)
    # smallest groups first, then stable partition order
    order = np.argsort(counts[inverse], kind="stable")
    chosen = order[outlying[inverse][order]][:max_outliers]
    return np.asarray(candidate_ids)[chosen]
