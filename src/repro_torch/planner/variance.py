"""Variance estimation for the error-bounded planner.

Two estimators, used at different points of a query's life:

* **Sketch prior** (`prior_budget`) — before any partition is read,
  predict how many partitions a CLT bound needs from the per-partition
  summary statistics alone: predicted per-partition totals come from the
  selectivity estimate × the sketch measures (mean of each aggregate's
  linear projection), their between-partition spread gives a
  sampling-variance forecast, and the AKMV distinct-value sketches
  dilute the forecast for group-bys (more groups ⇒ fewer rows per group
  per partition ⇒ higher per-group CV).  The prior only picks the first
  escalation rung — the measured estimate below corrects it.

* **Measured stratified estimate** (`stratified_answer`) — after reading
  a subset, treat the funnel's importance groups as strata sampled
  without replacement (SRSWOR): for stratum h of size N_h with n_h read,

      est   = Σ_outliers A_i  +  Σ_h (N_h/n_h) Σ_{i∈S_h} A_i
      Var   = Σ_h N_h² (1 − n_h/N_h) s²_h / n_h,

  per occupied group and raw component, with s²_h the sample variance
  (ddof=1) across the stratum's read partitions.  COUNT/SUM confidence
  intervals are ``z·√Var`` directly; AVG is a ratio R/C, handled by the
  delta method through the per-partition residuals d_i = R_i − r̂·C_i
  (the stratified variance of d̂ divided by Ĉ²).  Fully-read strata have
  a finite-population factor of zero — when every candidate is read the
  interval collapses and the answer is exact.

The stopping metric (`predicted_error`) mirrors the benchmark's
empirical ``avg_rel_err``: the mean over groups × aggregates of the
capped relative halfwidth, inflated by a Good–Turing estimate of groups
not yet seen (a group missed entirely scores 1.0 in the benchmark, so
the planner must account for unseen-group mass, not just CI width).
"""
from __future__ import annotations

import dataclasses

import numpy as np

TINY = 1e-12


# --------------------------------------------------------------------------
# sketch prior
# --------------------------------------------------------------------------
def _projection_means(sketches, agg) -> np.ndarray:
    """(N,) per-partition mean of the aggregate's linear projection."""
    cs0 = next(iter(sketches.columns.values()))
    n = cs0.measures.shape[0]
    out = np.zeros(n)
    for coef, col in agg.terms:
        out += coef * sketches.columns[col].measures[:, 0]
    return out


def group_dilution(sketches, groupby: tuple[str, ...], radix: int) -> float:
    """≥1: variance inflation for per-group estimates, from AKMV ndv.

    A partition covers roughly ``min(prod ndv_c, R)`` of the ``radix``
    possible groups; per-group row counts shrink by the coverage ratio,
    and the per-group CV grows with its square root.
    """
    if not groupby:
        return 1.0
    cover = np.ones(sketches.num_partitions)
    for col in groupby:
        cover = cover * np.maximum(sketches.columns[col].ndv, 1.0)
    cover = np.minimum(cover, float(radix))
    ratio = float(radix) / max(float(np.mean(cover)), 1.0)
    return float(np.clip(np.sqrt(ratio), 1.0, 4.0))


def prior_budget(
    query,
    sketches,
    sel: np.ndarray,  # (N, 4) predicate_selectivity output
    candidates: np.ndarray,
    error_bound: float,
    z: float,
    rows_per_partition: int,
    radix: int = 1,
) -> int:
    """Partitions a CLT bound predicts for ``error_bound``, from sketches
    alone.  Uses the worst (largest) requirement across the query's
    aggregates; clipped to [1, |candidates|] by the caller."""
    n = candidates.size
    if n <= 1 or error_bound <= 0:
        return n
    pass_rows = rows_per_partition * sel[candidates, 1]  # indep. estimate
    need = 1.0
    for agg in query.aggregates:
        if agg.kind == "count":
            totals = pass_rows
        else:
            totals = pass_rows * _projection_means(sketches, agg)[candidates]
        t_sum = float(np.abs(totals.sum()))
        sigma = float(totals.std())
        if t_sum < TINY or sigma < TINY:
            continue
        # SRSWOR: hw ≈ z·N·σ·√((1/n)(1−n/N)) / |T| ≤ ε  ⇒  n ≥ n0/(1+n0/N)
        n0 = (z * n * sigma / (error_bound * t_sum)) ** 2
        need = max(need, n0 / (1.0 + n0 / n))
    need *= group_dilution(sketches, query.groupby, radix)
    return int(np.ceil(min(need, n)))


# --------------------------------------------------------------------------
# measured stratified estimate
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StratifiedEstimate:
    """One escalation round's estimate with auditable uncertainty."""

    group_keys: np.ndarray  # (G,) occupied group codes seen so far
    estimate: np.ndarray  # (G, n_aggs) finalized
    ci_halfwidth: np.ndarray  # (G, n_aggs) z·√Var (delta method for avg)
    raw_estimate: np.ndarray  # (G, n_raw) raw-component totals
    predicted_error: float  # stopping metric (≈ benchmark avg_rel_err)
    stratum_scales: np.ndarray  # (H,) measured σ per stratum (allocation)


def _stratified_var(
    raw: np.ndarray,  # (n_rows, G, K) read answers, rows aligned to ids
    rows_of: list[np.ndarray],  # per stratum: row indices into `raw`
    sizes: np.ndarray,  # (H,) stratum population sizes N_h
) -> np.ndarray:
    """(G, K) Σ_h N_h²(1−f_h)s²_h/n_h; fully-read strata contribute 0."""
    var = np.zeros(raw.shape[1:])
    for rows, nh_pop in zip(rows_of, sizes):
        n = rows.size
        if n == 0 or n >= nh_pop:
            continue
        s2 = raw[rows].var(axis=0, ddof=1) if n > 1 else np.square(raw[rows][0])
        var += (nh_pop**2) * (1.0 - n / nh_pop) * s2 / n
    return var


def stratified_answer(
    query,
    plans,
    group_keys: np.ndarray,
    raw: np.ndarray,  # (n_rows, G, n_raw) everything read so far
    row_of: dict[int, int],  # partition id → row in `raw`
    outlier_ids: np.ndarray,
    strata: list[np.ndarray],  # population ids per stratum (disjoint)
    sampled: list[np.ndarray],  # read ids per stratum (⊆ strata[h])
    z: float,
    frac_unread: float,
    n_failed: int = 0,  # partitions lost past the retry budget (degraded)
) -> StratifiedEstimate:
    g, n_raw = raw.shape[1], raw.shape[2]
    n_aggs = len(plans)
    if g == 0:
        return StratifiedEstimate(
            group_keys, np.zeros((0, n_aggs)), np.zeros((0, n_aggs)),
            np.zeros((0, n_raw)), 0.0, np.zeros(len(strata)),
        )
    rows_out = np.array([row_of[i] for i in outlier_ids], dtype=np.int64)
    rows_of = [
        np.array([row_of[i] for i in ids], dtype=np.int64) for ids in sampled
    ]
    sizes = np.array([s.size for s in strata], dtype=np.float64)

    est_raw = raw[rows_out].sum(axis=0) if rows_out.size else np.zeros((g, n_raw))
    for rows, nh_pop in zip(rows_of, sizes):
        if rows.size:
            est_raw = est_raw + (nh_pop / rows.size) * raw[rows].sum(axis=0)
    var_raw = _stratified_var(raw, rows_of, sizes)

    # failed-read bias bound (robustness plane).  Two blind spots the
    # SRSWOR variance cannot see:
    #   * a DARK stratum — population but zero surviving reads — is
    #     invisible to the expansion, which would silently treat it as
    #     empty;
    #   * a failed partition whose rare groups were held by weight-1
    #     outlier reads — the group's column is all-zero across every
    #     stratum sample, so s²_h (and the CI) collapse to zero while
    #     the lost mass is real.
    # Widen the halfwidth by max(N_dark, n_failed) · |mean per-partition
    # raw| over everything read (max, not sum: dark-stratum partitions
    # are themselves failed reads).  This is a heuristic BIAS bound, not
    # a variance term — it assumes a failed partition contributes about
    # as much as an average read one, which under-covers groups
    # concentrated in the failed partitions and over-covers uniform
    # ones — but it keeps a degraded answer from ever claiming an exact
    # (zero-width) interval over mass it could not read.
    dark_pop = float(sum(
        nh for rows, nh in zip(rows_of, sizes) if rows.size == 0 and nh > 0
    ))
    lost_pop = max(dark_pop, float(n_failed))
    if lost_pop and raw.shape[0]:
        extra_raw = lost_pop * np.abs(raw.mean(axis=0))  # (G, n_raw)
    else:
        extra_raw = np.zeros((g, n_raw))

    # finalize + CI per aggregate
    cnt = est_raw[:, 0]
    safe_cnt = np.where(np.abs(cnt) > TINY, cnt, np.nan)
    est = np.zeros((g, n_aggs))
    hw = np.zeros((g, n_aggs))
    for j, p in enumerate(plans):
        if p.kind == "count":
            est[:, j] = cnt
            hw[:, j] = z * np.sqrt(var_raw[:, 0]) + extra_raw[:, 0]
        elif p.kind == "sum":
            est[:, j] = est_raw[:, p.raw_index]
            hw[:, j] = z * np.sqrt(var_raw[:, p.raw_index]) + extra_raw[:, p.raw_index]
        else:  # avg = R/C: delta method via residuals d_i = R_i − r̂ C_i
            with np.errstate(invalid="ignore", divide="ignore"):
                r = est_raw[:, p.raw_index] / safe_cnt
            est[:, j] = r
            resid = raw[:, :, p.raw_index] - np.nan_to_num(r)[None, :] * raw[:, :, 0]
            var_d = _stratified_var(resid[..., None], rows_of, sizes)[:, 0]
            with np.errstate(invalid="ignore", divide="ignore"):
                hw[:, j] = z * np.sqrt(var_d) / np.abs(safe_cnt)
    missed = ~(cnt > TINY)
    est[missed] = np.nan
    hw[missed] = np.nan

    # stopping metric: the benchmark bounds the MEAN absolute relative
    # error, and for a Gaussian estimator E|X̂−X| = √(2/π)·σ — so stop on
    # the expected error (0.8σ), not the z·σ interval (reported above),
    # which would overshoot the mean-error target ~z/0.8 ≈ 3× in reads
    present = ~missed
    exp_abs = np.sqrt(2.0 / np.pi) / z  # hw → expected |error|
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = exp_abs * np.abs(hw[present]) / np.maximum(np.abs(est[present]), TINY)
    rel = np.minimum(np.nan_to_num(rel, nan=1.0), 1.0)
    g_seen = int(present.sum())
    rel_sum = float(rel.sum()) / max(n_aggs, 1)
    m_hat = 0.0
    if query.groupby and g_seen:
        n_rows_read = raw.shape[0]
        appears = (raw[:, :, 0] > 0).sum(axis=0)  # partitions per group
        f1 = float((appears == 1).sum())
        # Good–Turing: new-group rate ≈ f1/n, extrapolated over the unread
        # mass (capped — the tail estimate is only first-order)
        m_hat = min(f1 * frac_unread, f1 / max(n_rows_read, 1) * g_seen)
    predicted = (rel_sum + m_hat) / max(g_seen + m_hat, 1.0)

    scales = np.zeros(len(strata))
    for h, rows in enumerate(rows_of):
        if rows.size > 1:
            scales[h] = float(raw[rows, :, 0].sum(axis=1).std(ddof=1))
    return StratifiedEstimate(group_keys, est, hw, est_raw, predicted, scales)
