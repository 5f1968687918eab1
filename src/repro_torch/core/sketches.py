"""Partition summary sketches (paper §3.1, Table 1).

Per partition and per column, in one vectorized pass over the partition
(the device backend runs the moments + histogram_range + bincount kernels
through `core.ingest.build_statistics`; the host backend computes the
same tensors in numpy):

  * Measures: mean, min, max, mean(x²), std — and log-variants for
    positive columns.
  * Histogram: 10-bucket equi-depth histogram (numeric columns).
  * AKMV: k=128 minimum hashed values + multiplicities → distinct-value
    count and frequency statistics of distinct values.
  * Heavy hitters at 1% support.  Categorical columns are integer-coded,
    so frequencies are computed exactly with a bincount and thresholded
    at the support.
  * Occurrence bitmaps of the top-K global heavy hitters (group-by
    columns; K capped at 25 per the paper).

This is the cold build; incremental maintenance under appends comes with
the streaming slice.  Phases are labelled ``sketches.*`` for
`torch.profiler`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from torch.profiler import record_function

from repro_torch.backends import ExecOptions
from repro_torch.core.ingest import build_statistics, discrete_span, partition_int_spans
from repro_torch.data.table import CATEGORICAL, NUMERIC, Table

NUM_BUCKETS = 10
AKMV_K = 128
HH_SUPPORT = 0.01
BITMAP_K = 25

MEASURE_NAMES = (
    "mean", "min", "max", "meansq", "std",
    "logmean", "logmeansq", "logmin", "logmax",
)
HH_STAT_NAMES = ("hh_count", "hh_avg_freq", "hh_max_freq")
DV_STAT_NAMES = ("ndv", "dv_avg_freq", "dv_max_freq", "dv_min_freq", "dv_sum_freq")


# --------------------------------------------------------------------------
# hashing (multiply-shift; stable across partitions)
# --------------------------------------------------------------------------
_MULT = np.uint64(0x9E3779B97F4A7C15)


def hash_u64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix of int/float values, normalized to [0,1)."""
    if x.dtype.kind == "f":
        v = x.astype(np.float64).view(np.uint64)
    else:
        v = x.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        v = (v ^ (v >> np.uint64(33))) * _MULT
        v ^= v >> np.uint64(29)
        v = v * np.uint64(0xBF58476D1CE4E5B9)
        v ^= v >> np.uint64(32)
    return (v >> np.uint64(11)).astype(np.float64) / float(1 << 53)


# --------------------------------------------------------------------------
# sketch containers
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ColumnSketch:
    name: str
    kind: str
    measures: np.ndarray  # (N, 9) — zeros for categorical columns
    hist_edges: np.ndarray | None  # (N, B+1) equi-depth edges (numeric)
    cat_counts: np.ndarray | None  # (N, card) exact frequencies (categorical)
    ndv: np.ndarray  # (N,) AKMV distinct-value estimate
    dv_freq: np.ndarray  # (N, 4): avg/max/min/sum frequency of distinct values
    hh_stats: np.ndarray  # (N, 3): #hh, avg freq, max freq (freq = fraction)
    hh_items: list[dict[int, float]] | None  # per-partition {code: freq} (cat)
    global_hh: np.ndarray | None  # (K,) codes of global heavy hitters
    bitmap: np.ndarray | None  # (N, K) occurrence bitmap (group-by columns)
    # observed (lo, hi) integer span behind the discrete-numeric heavy
    # hitters, None when the column does not qualify — what an incremental
    # update needs to merge the span decision without re-reading partitions
    discrete_span: tuple[int, int] | None = None
    # (N, 3) int64 [lo, hi, ok] per-partition integer spans (numeric
    # columns) — the mergeable form a compaction folds
    part_spans: np.ndarray | None = None


@dataclasses.dataclass
class TableSketches:
    table_name: str
    num_partitions: int
    rows_per_partition: int
    columns: dict[str, ColumnSketch]

    def column(self, name: str) -> ColumnSketch:
        return self.columns[name]


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------
def _measures(col: np.ndarray, positive: bool) -> np.ndarray:
    x = col.astype(np.float64)
    out = np.zeros((x.shape[0], 9), np.float64)
    out[:, 0] = x.mean(axis=1)
    out[:, 1] = x.min(axis=1)
    out[:, 2] = x.max(axis=1)
    out[:, 3] = (x * x).mean(axis=1)
    out[:, 4] = x.std(axis=1)
    if positive:
        lx = np.log(np.maximum(x, 1e-30))
        out[:, 5] = lx.mean(axis=1)
        out[:, 6] = (lx * lx).mean(axis=1)
        out[:, 7] = lx.min(axis=1)
        out[:, 8] = lx.max(axis=1)
    return out


def _equi_depth_edges(col: np.ndarray, buckets: int = NUM_BUCKETS) -> np.ndarray:
    qs = np.linspace(0.0, 1.0, buckets + 1)
    return np.quantile(col.astype(np.float64), qs, axis=1).T  # (N, B+1)


def _akmv(col: np.ndarray, k: int = AKMV_K):
    """AKMV sketch per partition: ndv estimate + distinct-value freq stats.

    One vectorized pass for all partitions: sort the hashes per row, turn
    run boundaries into run ids, and segment-count the run lengths — the
    k *minimum* hashed values are exactly the first k runs of the sorted
    order, so the top-k selection is a prefix mask, not a loop.  The hash
    stays in float64 on the host: a float32 image of the 53-bit hashes
    would collide at partition sizes.
    """
    n, r = col.shape
    hs = np.sort(hash_u64(col.reshape(-1)).reshape(n, r), axis=1)
    new = np.ones((n, r), bool)
    new[:, 1:] = hs[:, 1:] != hs[:, :-1]
    rid = np.cumsum(new, axis=1) - 1  # run (distinct-value) index per element
    d = rid[:, -1] + 1  # exact distinct count per partition
    seg = (rid + np.arange(n, dtype=np.int64)[:, None] * r).reshape(-1)
    cnts = np.bincount(seg, minlength=n * r).reshape(n, r).astype(np.float64)
    m = np.minimum(d, k)  # number of retained min-hash runs
    in_top = np.arange(r)[None, :] < m[:, None]
    c = np.where(in_top, cnts, 0.0)
    csum = c.sum(axis=1)
    freq = np.stack(
        [
            csum / m,
            c.max(axis=1),
            np.where(in_top, cnts, np.inf).min(axis=1),
            csum,
        ],
        axis=1,
    )
    # ndv: exact when d <= k, else (k-1)/U_(k) with U_(k) = k-th min unique
    kth = hs[np.arange(n), np.argmax(new & (rid == k - 1), axis=1)]
    ndv = np.where(d <= k, d.astype(np.float64), (k - 1) / np.maximum(kth, 1e-12))
    return ndv, freq


def _partition_bincount(codes: np.ndarray, card: int) -> np.ndarray:
    """(N, R) int codes → (N, card) exact counts, one vectorized bincount."""
    n, r = codes.shape
    seg = codes.astype(np.int64) + np.arange(n, dtype=np.int64)[:, None] * card
    return (
        np.bincount(seg.reshape(-1), minlength=n * card)
        .reshape(n, card)
        .astype(np.float64)
    )


def _heavy_hitters_exact(counts: np.ndarray, support: float = HH_SUPPORT):
    """counts: (N, card) per-partition exact frequencies."""
    n, card = counts.shape
    rows = counts.sum(axis=1, keepdims=True)
    freq = counts / np.maximum(rows, 1)
    is_hh = freq >= support
    n_hh = is_hh.sum(axis=1).astype(np.float64)
    sum_f = (freq * is_hh).sum(axis=1)
    stats = np.zeros((n, 3), np.float64)
    stats[:, 0] = n_hh
    stats[:, 1] = np.where(n_hh > 0, sum_f / np.maximum(n_hh, 1), 0.0)
    stats[:, 2] = (freq * is_hh).max(axis=1)
    items = [
        {int(c): float(freq[i, c]) for c in np.flatnonzero(is_hh[i])} for i in range(n)
    ]
    return stats, items, freq, is_hh


def build_sketches(
    table: Table,
    *,
    options: ExecOptions | None = None,
) -> TableSketches:
    """All per-partition sketches for a table (paper §3.1, Table 1).

    On the device backend the numeric tensors (measures, histogram
    counts, exact categorical / discrete-numeric frequencies) come from
    the ingest kernels via `core.ingest.build_statistics` — one device
    pass per column; on the host backend numpy computes the same tensors.
    Count tensors are bit-identical across backends (float32 accumulation
    of integer counts is exact), measures agree to float32 rounding.
    AKMV and equi-depth edge *placement* stay on the host in both modes
    (53-bit hashes and a sort; see `_akmv`).  This is the cold build — O(P).
    """
    options = options if options is not None else ExecOptions()
    backend = options.backend
    stats: dict[str, dict] = {}
    if backend == "device":
        with record_function("sketches.statistics"):
            stats = build_statistics(table, discrete_counts=True, options=options)

    cols: dict[str, ColumnSketch] = {}
    n = table.num_partitions
    for spec in table.schema:
        data = table.columns[spec.name]
        if spec.kind == NUMERIC:
            if backend == "device":
                measures = stats[spec.name]["measures"]
                edges = stats[spec.name]["hist_edges"]
            else:
                measures = _measures(data, spec.positive)
                edges = _equi_depth_edges(data)
            with record_function("sketches.akmv"):
                ndv, dv_freq = _akmv(data)
            # HH for numerics: only discrete-ish columns surface ≥1% items.
            counts = None
            lo = 0
            if backend == "device":
                counts = stats[spec.name].get("discrete_counts")
                lo = stats[spec.name].get("discrete_lo", 0)
            else:
                span = discrete_span(data)
                if span is not None:
                    lo, width = span
                    counts = _partition_bincount(data.astype(np.int64) - lo, width)
            if counts is not None:
                hh_stats, hh_items, _, _ = _heavy_hitters_exact(counts)
                hh_items = [
                    {k + lo: v for k, v in d.items()} for d in hh_items
                ]
                span = (lo, lo + counts.shape[1] - 1)
            else:
                hh_stats = np.zeros((n, 3), np.float64)
                hh_items = [dict() for _ in range(n)]
                span = None
            cols[spec.name] = ColumnSketch(
                spec.name, NUMERIC, measures, edges, None, ndv, dv_freq,
                hh_stats, hh_items, None, None, discrete_span=span,
                part_spans=partition_int_spans(data),
            )
        else:
            card = spec.cardinality
            if backend == "device":
                counts = stats[spec.name]["counts"]
            else:
                counts = _partition_bincount(data, card)
            with record_function("sketches.akmv"):
                ndv, dv_freq = _akmv(data)
            hh_stats, hh_items, freq, is_hh = _heavy_hitters_exact(counts)
            bitmap = None
            ghh = None
            if spec.groupable:
                # global heavy hitters = top-K by combined frequency of the
                # per-partition heavy-hitter dictionaries (paper §3.2).
                combined = (freq * is_hh).sum(axis=0)
                k = min(BITMAP_K, card)
                ghh = np.argsort(-combined, kind="stable")[:k].astype(np.int64)
                bitmap = is_hh[:, ghh].astype(np.float64)  # (N, K)
            cols[spec.name] = ColumnSketch(
                spec.name, CATEGORICAL, np.zeros((n, 9)), None, counts,
                ndv, dv_freq, hh_stats, hh_items, ghh, bitmap,
            )
    return TableSketches(table.name, n, table.rows_per_partition, cols)


class SketchStore:
    """Version-tracked sketch holder for one table.

    Builds the sketches at construction and hands them out through
    `sketches()`, which rebuilds them in full (`build_sketches`, counted in
    ``full_rebuilds``) whenever the table's version moved.  The reference
    folds appends and partition moves in incrementally instead; its folds
    are bit-equal to a cold build, so the sketches are the same either
    way.  The folds come with the streaming slice.
    """

    def __init__(self, table: Table, *, options: ExecOptions | None = None):
        self.table = table
        self.options = options if options is not None else ExecOptions()
        self.full_rebuilds = 0
        self._sk = build_sketches(table, options=self.options)
        self._version = table.version

    def sketches(self) -> TableSketches:
        """The current table's sketches."""
        if self.table.version != self._version:
            self.full_rebuilds += 1
            self._sk = build_sketches(self.table, options=self.options)
            self._version = self.table.version
        return self._sk
