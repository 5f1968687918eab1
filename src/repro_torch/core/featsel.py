"""Greedy leave-one-out feature selection for clustering (Algorithm 3).

Feature *kinds* (selectivity, bitmap, each measure/hh/dv statistic) are
excluded as whole groups across all columns, exactly as the paper's
pseudo-code: shuffle kinds, greedily move a kind to the exclusion set if
doing so improves clustering error over held-out training queries; repeat
from several random orders and keep the best exclusion set.

Clustering error is the average relative error of pure clustering-based
selection (no funnel/outliers — isolating §4.2, as the paper's Table 7
evaluation does) over a panel of (query, budget) cells.  Every KMeans run
goes to the torch device passed as ``device`` (the card by default).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.clustering import DEFAULT_DEVICE, kmeans_select
from repro_torch.core.features import (
    ALL_FEATURE_KINDS,
    FeatureBuilder,
    SELECTIVITY_NAMES,
)
from repro_torch.queries.engine import PartitionAnswers, error_metrics

DEFAULT_BUDGET_FRACS = (0.05, 0.1, 0.2)


def kind_groups() -> dict[str, tuple[str, ...]]:
    """Excludable kinds; 'selectivity' folds all 4 sel dims (paper Alg. 3)."""
    groups = {"selectivity": SELECTIVITY_NAMES, "bitmap": ("bitmap",)}
    for k in ALL_FEATURE_KINDS:
        if k not in SELECTIVITY_NAMES and k != "bitmap":
            groups[k] = (k,)
    return groups


def mask_excluding(fb: FeatureBuilder, excluded: set[str]) -> np.ndarray:
    kinds = np.asarray(fb.schema.kinds)
    mask = np.ones(fb.schema.dim)
    groups = kind_groups()
    for name in excluded:
        for kind in groups[name]:
            mask[kinds == kind] = 0.0
    return mask


def clustering_error(
    feats: list[np.ndarray],
    answers: list[PartitionAnswers],
    mask: np.ndarray,
    budget_fracs=DEFAULT_BUDGET_FRACS,
    device=DEFAULT_DEVICE,
) -> float:
    """Mean avg-rel-err of clustering-only selection over the eval panel."""
    errs = []
    for f, a in zip(feats, answers):
        n = f.shape[0]
        truth = a.truth()
        fm = f * mask[None, :]
        for frac in budget_fracs:
            b = max(1, int(frac * n))
            ids, wts = kmeans_select(fm, b, device=device)
            est = a.estimate(ids, wts)
            errs.append(error_metrics(truth, est)["avg_rel_err"])
    return float(np.mean(errs)) if errs else 0.0


def select_features(
    fb: FeatureBuilder,
    feats: list[np.ndarray],
    answers: list[PartitionAnswers],
    *,
    num_eval_queries: int = 6,
    num_restarts: int = 3,
    budget_fracs=DEFAULT_BUDGET_FRACS,
    seed: int = 0,
    improvement_tol: float = 1e-4,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Algorithm 3; returns the clustering feature mask (dim,)."""
    rng = np.random.default_rng(seed)
    # evaluation panel: prefer grouped queries (clustering matters most there)
    order = np.argsort([-a.num_groups for a in answers], kind="stable")
    panel = [int(i) for i in order[:num_eval_queries]]
    pf = [feats[i] for i in panel]
    pa = [answers[i] for i in panel]

    names = list(kind_groups().keys())

    def score(excluded: set[str]) -> float:
        return clustering_error(pf, pa, mask_excluding(fb, excluded), budget_fracs,
                                device=device)

    best_excl: set[str] = set()
    best_err = score(best_excl)
    for _ in range(num_restarts):
        rng.shuffle(names)
        excl: set[str] = set()
        err = score(excl)
        for name in names:
            if len(excl) >= len(names) - 1:
                break  # never exclude everything
            trial = excl | {name}
            e = score(trial)
            if e < err - improvement_tol:
                excl, err = trial, e
        if err < best_err - improvement_tol:
            best_excl, best_err = excl, err
    return mask_excluding(fb, best_excl)
