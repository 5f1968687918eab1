"""Summary statistics as feature vectors (paper §3.2, Table 2).

Feature layout (fixed by the table schema; shared by every query):

  [ sel_upper, sel_indep, sel_min, sel_max ]          4 query-specific dims
  per column:  9 measures | 3 hh stats | 5 dv stats   (zeros where N/A)
  per groupable column: 25-bit occurrence bitmap

Query-time masking zeroes features of columns the query does not touch;
occurrence bitmaps are live only for the query's group-by columns.

Selectivity features follow §3.2 exactly:
  * per-clause admissible *upper bounds* (bucket-counting on equi-depth
    edges; exact counts for categoricals) — `sel_upper > 0` has perfect
    recall by construction (tested property),
  * an interpolated point estimate feeding `indep`/`min`/`max`,
  * AND: upper = min over groups, indep = product;  OR: upper = min(1, Σ),
    indep = min (paper's definition).

Normalization (paper Appendix B): signed log1p on all statistics except
selectivity (cube root), then division by the statistic's mean magnitude
over the training dataset.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sketches import (
    BITMAP_K,
    DV_STAT_NAMES,
    HH_STAT_NAMES,
    MEASURE_NAMES,
    TableSketches,
)
from repro_torch.data.table import NUMERIC, Table
from repro_torch.queries.ir import Clause, Predicate, Query

SELECTIVITY_NAMES = ("sel_upper", "sel_indep", "sel_min", "sel_max")
PER_COLUMN_KINDS = MEASURE_NAMES + HH_STAT_NAMES + DV_STAT_NAMES
ALL_FEATURE_KINDS = SELECTIVITY_NAMES + PER_COLUMN_KINDS + ("bitmap",)


# --------------------------------------------------------------------------
# selectivity estimation from sketches
# --------------------------------------------------------------------------
def _edges_cdf(edges: np.ndarray, v: float, inclusive: bool):
    """Interpolated CDF estimate and admissible upper bound for col {<,<=} v."""
    lo, hi = edges[:, :-1], edges[:, 1:]
    w = hi - lo
    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.clip((v - lo) / np.where(w > 0, w, 1.0), 0.0, 1.0)
    flat = (lo >= v) if not inclusive else (lo > v)
    t = np.where(w > 0, t, (~flat).astype(np.float64))
    est = t.mean(axis=1)
    upper = (lo <= v).mean(axis=1) if inclusive else (lo < v).mean(axis=1)
    return est, upper


def clause_selectivity(table: Table, sk: TableSketches, clause: Clause):
    """Returns (est, upper) per partition, both in [0,1]; upper is admissible."""
    spec = table.spec(clause.col)
    cs = sk.columns[clause.col]
    rows = sk.rows_per_partition
    if spec.kind == NUMERIC:
        v = float(clause.value)
        if clause.op in ("<", "<="):
            return _edges_cdf(cs.hist_edges, v, inclusive=clause.op == "<=")
        if clause.op in (">", ">="):
            est, upper = _edges_cdf(cs.hist_edges, v, inclusive=clause.op == ">")
            # upper bound for > v: fraction of buckets whose upper edge clears v
            hi = cs.hist_edges[:, 1:]
            ub = (hi > v).mean(axis=1) if clause.op == ">" else (hi >= v).mean(axis=1)
            return 1.0 - est, ub
        if clause.op in ("==", "!="):
            # numeric equality via discrete HH dictionary if available
            eq = np.array(
                [d.get(int(clause.value), 0.0) for d in cs.hh_items], np.float64
            )
            inside = (cs.hist_edges[:, 0] <= v) & (v <= cs.hist_edges[:, -1])
            ub = np.where(eq > 0, eq, inside.astype(np.float64))
            if clause.op == "==":
                return eq, ub
            return 1.0 - eq, np.ones_like(eq)
        raise ValueError(f"unsupported numeric op {clause.op}")
    # categorical: exact small-domain frequencies (paper §3.2 special case)
    counts = cs.cat_counts
    freq = counts / rows
    if clause.op == "==":
        f = freq[:, int(clause.value)]
        return f, f
    if clause.op == "!=":
        f = 1.0 - freq[:, int(clause.value)]
        return f, f
    if clause.op == "in":
        vals = np.asarray(clause.value, np.int64)
        f = freq[:, vals].sum(axis=1)
        return f, f
    raise ValueError(f"unsupported categorical op {clause.op}")


def predicate_selectivity(table: Table, sk: TableSketches, pred: Predicate):
    """(N, 4): sel_upper, sel_indep, sel_min, sel_max per partition."""
    n = sk.num_partitions
    if not pred.groups:
        return np.ones((n, 4), np.float64)
    g_uppers, g_ests, clause_ests = [], [], []
    for group in pred.groups:
        ests, uppers = zip(
            *(clause_selectivity(table, sk, c) for c in group.clauses)
        )
        ests, uppers = np.stack(ests), np.stack(uppers)
        clause_ests.append(ests)
        if len(group.clauses) == 1:
            g_uppers.append(uppers[0])
            g_ests.append(ests[0])
        else:  # OR: upper = min(1, Σ); indep = min (paper §3.2)
            g_uppers.append(np.minimum(uppers.sum(axis=0), 1.0))
            g_ests.append(ests.min(axis=0))
    g_uppers, g_ests = np.stack(g_uppers), np.stack(g_ests)
    all_ests = np.concatenate(clause_ests, axis=0)
    out = np.zeros((n, 4), np.float64)
    out[:, 0] = g_uppers.min(axis=0)  # AND: min of group uppers
    out[:, 1] = np.prod(g_ests, axis=0)  # independence assumption
    out[:, 2] = all_ests.min(axis=0)
    out[:, 3] = all_ests.max(axis=0)
    return out


# --------------------------------------------------------------------------
# feature schema + assembly
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FeatureSchema:
    dim: int
    kinds: tuple[str, ...]  # per-dim feature kind name
    cols: tuple[str | None, ...]  # per-dim source column (None = selectivity)
    col_slices: dict[str, tuple[int, int]]  # per-column contiguous span
    bitmap_slices: dict[str, tuple[int, int]]  # group-by bitmap spans

    def dims_of_kind(self, kind: str) -> np.ndarray:
        return np.flatnonzero(np.asarray(self.kinds) == kind)


def build_feature_schema(table: Table) -> FeatureSchema:
    kinds: list[str] = list(SELECTIVITY_NAMES)
    cols: list[str | None] = [None] * 4
    col_slices: dict[str, tuple[int, int]] = {}
    bitmap_slices: dict[str, tuple[int, int]] = {}
    for spec in table.schema:
        start = len(kinds)
        kinds.extend(PER_COLUMN_KINDS)
        cols.extend([spec.name] * len(PER_COLUMN_KINDS))
        col_slices[spec.name] = (start, len(kinds))
    for spec in table.schema:
        if spec.groupable:
            start = len(kinds)
            kinds.extend(["bitmap"] * BITMAP_K)
            cols.extend([spec.name] * BITMAP_K)
            bitmap_slices[spec.name] = (start, len(kinds))
    return FeatureSchema(len(kinds), tuple(kinds), tuple(cols), col_slices, bitmap_slices)


class FeatureBuilder:
    """Assembles normalized, query-masked partition feature matrices."""

    def __init__(self, table: Table, sketches: TableSketches):
        self.table = table
        self.sk = sketches
        self.schema = build_feature_schema(table)
        self.raw = self._build_raw()
        self.normalizer = self._build_normalizer()
        self._base = self._build_base()

    def _build_raw(self) -> np.ndarray:
        n = self.sk.num_partitions
        out = np.zeros((n, self.schema.dim), np.float64)
        for spec in self.table.schema:
            cs = self.sk.columns[spec.name]
            s, e = self.schema.col_slices[spec.name]
            block = np.concatenate(
                [cs.measures, cs.hh_stats, cs.ndv[:, None], cs.dv_freq], axis=1
            )
            out[:, s:e] = block
            if spec.name in self.schema.bitmap_slices and cs.bitmap is not None:
                bs, be = self.schema.bitmap_slices[spec.name]
                k = cs.bitmap.shape[1]
                out[:, bs : bs + k] = cs.bitmap
        return out

    def _build_normalizer(self) -> np.ndarray:
        t = _signed_log1p(self.raw)
        mean = np.abs(t).mean(axis=0)
        norm = np.where(mean > 1e-12, mean, 1.0)
        # selectivity dims are cube-rooted, not mean-normalized
        norm[:4] = 1.0
        bit = np.asarray(self.schema.kinds) == "bitmap"
        norm[bit] = 1.0
        return norm

    def _build_base(self) -> np.ndarray:
        """Query-independent normalized matrix — built once, masked per query."""
        t = _signed_log1p(self.raw) / self.normalizer
        bit = np.asarray(self.schema.kinds) == "bitmap"
        t[:, bit] = self.raw[:, bit]
        return t

    def _base_matrix(self) -> np.ndarray:
        # getattr: tolerate FeatureBuilders unpickled from pre-cache artifacts
        base = getattr(self, "_base", None)
        if base is None:
            base = self._base = self._build_base()
        return base

    def column_mask(self, query: Query) -> np.ndarray:
        """(dim,) 0/1 mask: keep used columns; bitmaps only for group-bys."""
        mask = np.zeros(self.schema.dim)
        mask[:4] = 1.0
        used = set(query.columns)
        for col in used:
            if col in self.schema.col_slices:
                s, e = self.schema.col_slices[col]
                mask[s:e] = 1.0
        for col in query.groupby:
            if col in self.schema.bitmap_slices:
                s, e = self.schema.bitmap_slices[col]
                mask[s:e] = 1.0
        return mask

    def features(self, query: Query) -> np.ndarray:
        """(N, dim) normalized masked features for the query."""
        sel = predicate_selectivity(self.table, self.sk, query.predicate)
        out = self._base_matrix() * self.column_mask(query)[None, :]
        out[:, :4] = np.cbrt(sel)
        return out

    def features_batch(
        self, queries: list[Query]
    ) -> tuple[np.ndarray, np.ndarray]:
        """One vectorized pass for a query batch (the serving engine's path).

        Returns (features (Q, N, dim), selectivity (Q, N, 4)); the shared
        normalized base matrix is broadcast against the per-query column
        masks instead of being recomputed per query.
        """
        n, dim = self.raw.shape[0], self.schema.dim
        if not queries:
            return np.empty((0, n, dim)), np.empty((0, n, 4))
        masks = np.stack([self.column_mask(q) for q in queries])  # (Q, dim)
        sels = np.stack([self.selectivity(q) for q in queries])  # (Q, N, 4)
        out = self._base_matrix()[None, :, :] * masks[:, None, :]
        out[:, :, :4] = np.cbrt(sels)
        return out, sels

    def selectivity(self, query: Query) -> np.ndarray:
        """(N, 4) raw (un-transformed) selectivity features."""
        return predicate_selectivity(self.table, self.sk, query.predicate)


def _signed_log1p(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.log1p(np.abs(x))
