"""Sampling baselines (paper §5.1.3).

* Random          — uniform partition sample, aggregates scaled by 1/rate.
* Random+Filter   — uniform over partitions passing the selectivity filter
                    (needs summary statistics, like PS³).
* LSS             — Learned Stratified Sampling adapted to partitions with
                    the paper's three modifications (Appendix C.1): offline
                    per-workload model, partition-contribution labels,
                    equi-width strata over the model prediction with the
                    strata count swept on the training set.

Every draw comes from the caller's numpy ``rng`` (or ``seed``) in the
reference's order, so the same rng picks the same ids and weights here
and in the JAX reference.  `train_lss` fits its model through
`fit_gbdt`, on the backend ``options`` picks (the card by default).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.backends import ExecOptions
from repro_torch.core.features import FeatureBuilder
from repro_torch.core.gbdt import Forest, fit_gbdt
from repro_torch.queries.engine import PartitionAnswers, error_metrics
from repro_torch.queries.ir import Query


def uniform_select(n: int, budget: int, rng) -> tuple[np.ndarray, np.ndarray]:
    budget = int(min(budget, n))
    ids = rng.choice(n, size=budget, replace=False)
    return ids, np.full(budget, n / budget)


def uniform_filter_select(
    candidates: np.ndarray, budget: int, rng
) -> tuple[np.ndarray, np.ndarray]:
    m = candidates.size
    budget = int(min(budget, m))
    if budget == 0:
        return np.empty(0, np.int64), np.empty(0)
    loc = rng.choice(m, size=budget, replace=False)
    return candidates[loc], np.full(budget, m / budget)


# --------------------------------------------------------------------------
# LSS (modified, Appendix C.1)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LSSSampler:
    fb: FeatureBuilder
    model: Forest
    num_strata: int

    def pick(self, query: Query, budget: int, seed: int = 0):
        feats = self.fb.features(query)
        sel = self.fb.selectivity(query)
        candidates = np.flatnonzero((sel[:, 0] > 0) & self.fb.table.live_mask())
        if candidates.size == 0:
            return np.empty(0, np.int64), np.empty(0)
        budget = int(min(budget, candidates.size))
        pred = self.model.predict(feats[candidates])
        lo, hi = pred.min(), pred.max()
        if hi - lo < 1e-12:
            rng = np.random.default_rng(seed)
            return uniform_filter_select(candidates, budget, rng)
        # equi-width strata over the prediction range
        edges = np.linspace(lo, hi, self.num_strata + 1)
        strata = np.clip(np.searchsorted(edges, pred, side="right") - 1, 0, self.num_strata - 1)
        rng = np.random.default_rng(seed)
        ids, wts = [], []
        sizes = np.bincount(strata, minlength=self.num_strata)
        # proportional allocation with at least 1 sample per non-empty stratum
        alloc = np.floor(budget * sizes / max(sizes.sum(), 1)).astype(int)
        alloc[sizes > 0] = np.maximum(alloc[sizes > 0], 1)
        while alloc.sum() > budget:  # trim largest allocations
            j = int(np.argmax(alloc))
            alloc[j] -= 1
        left = budget - alloc.sum()
        order = np.argsort(-(sizes - alloc))
        for j in order:
            if left <= 0:
                break
            add = min(left, sizes[j] - alloc[j])
            alloc[j] += max(add, 0)
            left -= max(add, 0)
        for s in range(self.num_strata):
            members = np.flatnonzero(strata == s)
            b = min(alloc[s], members.size)
            if b <= 0:
                continue
            loc = rng.choice(members.size, size=b, replace=False)
            ids.append(candidates[members[loc]])
            wts.append(np.full(b, members.size / b))
        return np.concatenate(ids), np.concatenate(wts)


def train_lss(
    fb: FeatureBuilder,
    feats: list[np.ndarray],
    contributions: list[np.ndarray],
    answers: list[PartitionAnswers],
    queries: list[Query],
    strata_grid=(2, 4, 8, 16),
    num_trees: int = 60,
    depth: int = 5,
    seed: int = 0,
    eval_budget_frac: float = 0.1,
    *,
    options: ExecOptions | None = None,
) -> LSSSampler:
    X = np.concatenate(feats, axis=0)
    y = np.concatenate(contributions)
    model = fit_gbdt(
        X, y, num_trees=num_trees, depth=depth, seed=seed, rowsample=0.5, colsample=0.7,
        options=options,
    )
    # sweep strata count on the training set (paper's exhaustive sweep)
    best_s, best_err = strata_grid[0], np.inf
    eval_ids = list(range(min(8, len(queries))))
    for s in strata_grid:
        sampler = LSSSampler(fb, model, s)
        errs = []
        for i in eval_ids:
            a = answers[i]
            n = feats[i].shape[0]
            ids, wts = sampler.pick(queries[i], max(1, int(eval_budget_frac * n)), seed)
            est = a.estimate(ids, wts)
            errs.append(error_metrics(a.truth(), est)["avg_rel_err"])
        e = float(np.mean(errs))
        if e < best_err:
            best_err, best_s = e, s
    return LSSSampler(fb, model, best_s)
