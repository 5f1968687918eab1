"""Learned importance-style sampling (paper §4.3, Algorithms 2 & 4).

* `make_labels` — Algorithm 4: per training query, a partition is positive
  for model i iff its contribution  max_g max_j A_{g,p}[j]/A_g[j]  exceeds
  threshold t_i; positive labels are rescaled to sqrt(N/positive) so that
  queries with few positives weigh more (the paper's class-imbalance
  argument for regressors-not-classifiers).
* Thresholds are exponentially spaced: model 1 catches every partition with
  non-zero contribution; model k catches the top ~1% (paper footnote 5).
  We realize this by picking contribution thresholds whose *average*
  positive fraction decays geometrically from P(contribution>0) to 1%.
* `ImportanceFunnel.classify` — Algorithm 2: partitions advance through the
  models in order; each model's passing set is carved out of the current
  tail group.  Model i's pass test is `pred > τ_i` with τ_i calibrated on
  the training predictions to recover the target positive fraction (our
  GBDT is unregularized around 0, so the paper's `> 0` test is replaced by
  a calibrated threshold with the same intent).
* `allocate` — budget split with sampling rate decaying by α per group
  (most-important group gets rate r, next r/α, ...), rates capped at 1 with
  re-distribution of the slack.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from torch.profiler import record_function

from repro_torch.backends import ExecOptions
from repro_torch.core.gbdt import Binner, Forest, fit_gbdt

DEFAULT_NUM_MODELS = 4
DEFAULT_ALPHA = 2.0
TOP_FRACTION = 0.01


# --------------------------------------------------------------------------
# Algorithm 4 — training labels
# --------------------------------------------------------------------------
def pick_thresholds(
    contributions: list[np.ndarray], num_models: int = DEFAULT_NUM_MODELS
) -> np.ndarray:
    """Contribution thresholds t_1 < ... < t_k with geometric pass fractions."""
    allc = np.concatenate(contributions)
    pos = allc[allc > 0]
    if pos.size == 0:
        return np.full(num_models, np.inf)
    f_hi = pos.size / allc.size  # fraction passing model 1 (non-zero)
    f_lo = min(TOP_FRACTION, f_hi)
    fracs = np.geomspace(f_hi, f_lo, num_models)
    # t_i = the (1 - f_i) quantile of all contributions
    return np.quantile(allc, 1.0 - fracs)


def make_labels(
    contribution: np.ndarray, threshold: float
) -> tuple[np.ndarray, np.ndarray]:
    """Algorithm 4 for one query + one model: (labels, is_positive)."""
    n = contribution.shape[0]
    pos = contribution > threshold
    npos = pos.sum()
    y = np.zeros(n)
    if npos:
        y[pos] = np.sqrt(n / npos)
    return y, pos


# --------------------------------------------------------------------------
# the funnel
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ImportanceFunnel:
    """k trained regressors + calibrated pass thresholds (Algorithm 2)."""

    forests: list[Forest]
    taus: np.ndarray  # (k,) pass thresholds
    thresholds: np.ndarray  # (k,) contribution thresholds used for labels

    @property
    def num_models(self) -> int:
        return len(self.forests)

    def classify(
        self, features: np.ndarray, candidates: np.ndarray
    ) -> list[np.ndarray]:
        """Algorithm 2: groups[0] = least important ... groups[-1] = most.

        `candidates` are partition ids that already passed the selectivity
        filter (the funnel's entry stage); `features` is the full (N, M)
        matrix.
        """
        groups = [np.asarray(candidates, np.int64)]
        for forest, tau in zip(self.forests, self.taus):
            tail = groups[-1]
            if tail.size == 0:
                groups.append(tail)
                continue
            pred = forest.predict(features[tail])
            pick = pred > tau
            groups[-1] = tail[~pick]
            groups.append(tail[pick])
        return groups

    def scores(self, features: np.ndarray) -> np.ndarray:
        """Sum of model predictions (used by the LSS baseline & diagnostics)."""
        return np.sum([f.predict(features) for f in self.forests], axis=0)


def train_funnel(
    features: list[np.ndarray],  # per query (N, M)
    contributions: list[np.ndarray],  # per query (N,)
    num_models: int = DEFAULT_NUM_MODELS,
    num_trees: int = 60,
    depth: int = 5,
    seed: int = 0,
    rowsample: float = 0.5,
    colsample: float = 0.7,
    *,
    options: ExecOptions | None = None,
    parity_relaxation: bool = False,
) -> ImportanceFunnel:
    """k regressors on Algorithm-4 labels; ``options`` selects the GBDT fit
    execution backend (host numpy vs kernel layer) — the exported forests
    are bit-identical either way, so calibration (τ) is backend-free.
    ``parity_relaxation`` opts the device fit into the device-resident
    boosting update (allclose forests, see `core/gbdt.py`)."""
    thresholds = pick_thresholds(contributions, num_models)
    X = np.concatenate(features, axis=0)
    with record_function("funnel.binning"):
        binner = Binner.fit(X)
        codes = binner.transform(X)  # bin once; all k model fits share it
    forests: list[Forest] = []
    taus = np.zeros(num_models)
    for i, t in enumerate(thresholds):
        ys, poss = [], []
        for c in contributions:
            y, pos = make_labels(c, t)
            ys.append(y)
            poss.append(pos)
        Y = np.concatenate(ys)
        P = np.concatenate(poss)
        with record_function("funnel.fit"):
            forest = fit_gbdt(
                X,
                Y,
                num_trees=num_trees,
                depth=depth,
                binner=binner,
                seed=seed + i,
                rowsample=rowsample,
                colsample=colsample,
                codes=codes,
                options=options,
                parity_relaxation=parity_relaxation,
            )
        pred = forest.predict_codes(codes)  # calibrate on the shared codes
        frac = max(P.mean(), 1.0 / max(len(P), 1))
        # calibrate: recover the training positive fraction
        taus[i] = float(np.quantile(pred, 1.0 - frac))
        forests.append(forest)
    return ImportanceFunnel(forests, taus, thresholds)


# --------------------------------------------------------------------------
# budget allocation across importance groups
# --------------------------------------------------------------------------
def allocate(group_sizes: list[int], budget: int, alpha: float = DEFAULT_ALPHA) -> list[int]:
    """Per-group sample counts; rate decays by α from most→least important.

    group_sizes[0] is the LEAST important group (Algorithm 2 ordering).
    """
    k = len(group_sizes)
    sizes = np.asarray(group_sizes, np.float64)
    budget = int(min(budget, sizes.sum()))
    if budget <= 0 or sizes.sum() == 0:
        return [0] * k
    # rate_i = r / alpha**(k-1-i); solve for r, cap at 1, redistribute
    weights = alpha ** -(k - 1 - np.arange(k))
    rates = np.zeros(k)
    remaining = float(budget)
    free = sizes > 0
    w = weights.copy()
    for _ in range(k):
        denom = float((sizes * w * free).sum())
        if denom <= 0 or remaining <= 0:
            break
        r = remaining / denom
        newly_capped = free & (w * r >= 1.0)
        if not newly_capped.any():
            rates[free] = np.minimum(w[free] * r, 1.0)
            break
        rates[newly_capped] = 1.0
        remaining -= float(sizes[newly_capped].sum())
        free &= ~newly_capped
    counts = np.floor(rates * sizes).astype(int)
    counts = np.minimum(counts, sizes.astype(int))
    # hand out leftovers most-important-first
    left = budget - counts.sum()
    for i in range(k - 1, -1, -1):
        if left <= 0:
            break
        add = min(left, int(sizes[i]) - counts[i])
        counts[i] += add
        left -= add
    return counts.tolist()
