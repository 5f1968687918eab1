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

`build_sketches` is the cold build; `update_sketches` extends a result
to appended partitions and `gather_sketches` follows a compaction or a
rebalance, each bit-identical to a cold build of the mutated table, and
`SketchStore` keeps one table's sketches current that way.  An append
fold reads the rows of only the new partitions (kernels, AKMV); the
categorical heavy hitters are recomputed over the merged (P, cardinality)
counts.  Phases are labelled ``sketches.*`` (cold build), ``stream.*``
(append folds) and ``lifecycle.*`` (gathers) for `torch.profiler`.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from torch.profiler import record_function

from repro_torch.backends import ExecOptions
from repro_torch.core.ingest import (
    build_statistics,
    delta_statistics,
    discrete_span,
    fold_partition_spans,
    int_span,
    merge_discrete_span,
    partition_int_spans,
)
from repro_torch.data.table import CATEGORICAL, NUMERIC, Table, events_foldable

NUM_BUCKETS = 10
AKMV_K = 128
HH_SUPPORT = 0.01
BITMAP_K = 25
AKMV_BLOCK = 64  # partitions per `_akmv` block on its thread pool
_AKMV_POOL: ThreadPoolExecutor | None = None
_AKMV_LOCK = threading.Lock()

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

    One vectorized pass per block of ``AKMV_BLOCK`` partitions: sort the
    hashes per row, turn run boundaries into run ids, and segment-count
    the run lengths — the k *minimum* hashed values are exactly the first
    k runs of the sorted order, so the top-k selection is a prefix mask,
    not a loop.  The hash stays in float64 on the host: a float32 image of
    the 53-bit hashes would collide at partition sizes.  Every step works
    on one partition's row, so the blocks run on a thread pool (numpy
    releases the GIL in the hash, the sort and the reductions) and their
    concatenation is bit-identical to one pass over all partitions.
    """
    n = col.shape[0]
    if n <= AKMV_BLOCK:
        return _akmv_block(col, k)
    parts = list(_akmv_pool().map(lambda s: _akmv_block(col[s:s + AKMV_BLOCK], k),
                                  range(0, n, AKMV_BLOCK)))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def _akmv_pool() -> ThreadPoolExecutor:
    global _AKMV_POOL
    with _AKMV_LOCK:
        if _AKMV_POOL is None:
            _AKMV_POOL = ThreadPoolExecutor(min(8, os.cpu_count() or 1),
                                            thread_name_prefix="akmv")
        return _AKMV_POOL


def _akmv_block(col: np.ndarray, k: int):
    """`_akmv` over the partitions (rows) of ``col`` in one pass."""
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


def akmv_state(col: np.ndarray, k: int = AKMV_K):
    """Mergeable AKMV state per partition: ``(hashes, counts, d)``.

    ``hashes`` (N, k) holds the k minimum distinct hashed values in
    ascending order (padded with +inf), ``counts`` (N, k) their exact
    multiplicities, ``d`` (N,) the exact distinct count of the rows this
    state saw.  Two states over disjoint row-chunks of the same partitions
    merge by k-min union (`merge_akmv_states`), and `akmv_finalize`
    reproduces `_akmv`'s (ndv, dv_freq) bit-identically.
    """
    n, r = col.shape
    hs = np.sort(hash_u64(col.reshape(-1)).reshape(n, r), axis=1)
    new = np.ones((n, r), bool)
    new[:, 1:] = hs[:, 1:] != hs[:, :-1]
    rid = np.cumsum(new, axis=1) - 1
    d = (rid[:, -1] + 1).astype(np.float64)
    seg = (rid + np.arange(n, dtype=np.int64)[:, None] * r).reshape(-1)
    cnts = np.bincount(seg, minlength=n * r).reshape(n, r).astype(np.float64)
    hashes = np.full((n, k), np.inf)
    counts = np.zeros((n, k))
    ii, pos = np.nonzero(new & (rid < k))
    run = rid[ii, pos]
    hashes[ii, run] = hs[ii, pos]
    counts[ii, run] = cnts[ii, run]
    return hashes, counts, d


def merge_akmv_states(a, b, k: int = AKMV_K):
    """K-min union of two `akmv_state` results over disjoint row sets.

    Multiplicities of hashes retained on both sides add exactly (integer
    counts in float64); the merged exact distinct count survives only
    while both sides kept all their distinct hashes (d <= k) — otherwise
    it is +inf, which sends `akmv_finalize` down the (k-1)/U_(k)
    estimator exactly as a one-pass build over the union would.
    """
    ha, ca, da = a
    hb, cb, db = b
    h = np.concatenate([ha, hb], axis=1)
    c = np.concatenate([ca, cb], axis=1)
    order = np.argsort(h, axis=1, kind="stable")
    h = np.take_along_axis(h, order, axis=1)
    c = np.take_along_axis(c, order, axis=1)
    n, m = h.shape
    new = np.ones((n, m), bool)
    new[:, 1:] = h[:, 1:] != h[:, :-1]
    rid = np.cumsum(new, axis=1) - 1
    seg = (rid + np.arange(n, dtype=np.int64)[:, None] * m).reshape(-1)
    csum = np.bincount(seg, weights=c.reshape(-1), minlength=n * m).reshape(n, m)
    finite = np.isfinite(h)
    hashes = np.full((n, k), np.inf)
    counts = np.zeros((n, k))
    ii, pos = np.nonzero(new & (rid < k) & finite)
    run = rid[ii, pos]
    hashes[ii, run] = h[ii, pos]
    counts[ii, run] = csum[ii, run]
    exact = (da <= k) & (db <= k)
    d = np.where(exact, (new & finite).sum(axis=1).astype(np.float64), np.inf)
    return hashes, counts, d


def akmv_finalize(state, k: int = AKMV_K):
    """(ndv, dv_freq) from an AKMV state — bit-identical to `_akmv` over
    the same (unioned) rows."""
    h, c, d = state
    valid = np.isfinite(h)
    m = valid.sum(axis=1)
    csum = c.sum(axis=1)
    freq = np.stack(
        [csum / m, c.max(axis=1), np.where(valid, c, np.inf).min(axis=1), csum],
        axis=1,
    )
    with np.errstate(divide="ignore"):
        est = (k - 1) / np.maximum(h[:, k - 1], 1e-12)
    ndv = np.where(d <= k, d, est)
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


def lossy_counting(stream: np.ndarray, support: float = HH_SUPPORT) -> dict[int, float]:
    """Manku–Motwani lossy counting (streaming, ε = support/10): the
    heavy hitters of a stream of codes with their frequencies."""
    eps = support / 10.0
    bucket_width = int(np.ceil(1.0 / eps))
    counts: dict[int, tuple[int, int]] = {}
    b_current = 1
    for i, item in enumerate(stream.tolist(), start=1):
        if item in counts:
            f, delta = counts[item]
            counts[item] = (f + 1, delta)
        else:
            counts[item] = (1, b_current - 1)
        if i % bucket_width == 0:
            counts = {k: (f, d) for k, (f, d) in counts.items() if f + d > b_current}
            b_current += 1
    n = len(stream)
    thresh = (support - eps) * n
    return {
        int(k): (f / n)
        for k, (f, d) in counts.items()
        if f + d >= thresh and f / n >= support - eps
    }


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


def _global_heavy_hitters(freq: np.ndarray, is_hh: np.ndarray, card: int):
    """Top-K global heavy hitters by combined per-partition heavy-hitter
    frequency (paper §3.2) and their (N, K) occurrence bitmap."""
    combined = (freq * is_hh).sum(axis=0)
    k = min(BITMAP_K, card)
    ghh = np.argsort(-combined, kind="stable")[:k].astype(np.int64)
    return ghh, is_hh[:, ghh].astype(np.float64)


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
    On a partition plane (``options.mesh``) the ingest kernels run once per
    shard (`core.ingest.build_statistics`); the sketches are bit-identical
    to the single-device ones.
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
            ghh = bitmap = None
            if spec.groupable:
                ghh, bitmap = _global_heavy_hitters(freq, is_hh, card)
            cols[spec.name] = ColumnSketch(
                spec.name, CATEGORICAL, np.zeros((n, 9)), None, counts,
                ndv, dv_freq, hh_stats, hh_items, ghh, bitmap,
            )
    return TableSketches(table.name, n, table.rows_per_partition, cols)


# --------------------------------------------------------------------------
# streaming ingest: incremental sketch maintenance
# --------------------------------------------------------------------------
def update_sketches(
    sk: TableSketches,
    table: Table,
    start: int,
    *,
    options: ExecOptions | None = None,
) -> TableSketches:
    """Extend ``sk`` (built when ``table`` had ``start`` partitions) to the
    partitions appended at/after ``start``; it reads the rows of only
    those partitions.

    Per-partition rows (measures, histogram, AKMV, heavy hitters) are
    computed for only the delta partitions — through
    `core.ingest.delta_statistics` on the device backend, numpy on the
    host backend — and concatenated; the global state is merged:

      * discrete-numeric heavy hitters: the observed integer span widens
        with the union (`ColumnSketch.discrete_span`); an append that
        pushes it past the width cap or brings a non-integral value
        disqualifies the column for every partition, as a cold build
        would decide;
      * categorical global heavy hitters and occurrence bitmaps are
        recomputed from the merged exact counts (O(P·card), no row reads).

    The result is bit-identical to `build_sketches` of the grown table on
    the same backend and plane (``options.mesh``: the delta's kernels run
    once per shard).  Returns a new `TableSketches`; ``sk`` is not mutated.
    """
    options = options if options is not None else ExecOptions()
    backend = options.backend
    if sk.num_partitions != start:
        raise ValueError(
            f"sketch snapshot covers {sk.num_partitions} partitions, "
            f"append starts at {start}"
        )
    if sk.rows_per_partition != table.rows_per_partition:
        raise ValueError("rows_per_partition changed: not an append")
    n = table.num_partitions
    if n == start:
        return dataclasses.replace(sk)

    stats: dict[str, dict] = {}
    if backend == "device":
        with record_function("stream.delta_stats"):
            stats = delta_statistics(table, start, discrete_counts=True, options=options)

    cols: dict[str, ColumnSketch] = {}
    for spec in table.schema:
        data = table.columns[spec.name][start:]
        old = sk.columns[spec.name]
        with record_function("stream.akmv"):
            ndv_d, dv_freq_d = _akmv(data)
        ndv = np.concatenate([old.ndv, ndv_d])
        dv_freq = np.concatenate([old.dv_freq, dv_freq_d], axis=0)
        if spec.kind == NUMERIC:
            if backend == "device":
                measures_d = stats[spec.name]["measures"]
                edges_d = stats[spec.name]["hist_edges"]
                counts_d = stats[spec.name].get("discrete_counts")
                lo_d = stats[spec.name].get("discrete_lo", 0)
            else:
                measures_d = _measures(data, spec.positive)
                edges_d = _equi_depth_edges(data)
                counts_d = None
                lo_d = 0
                dspan = discrete_span(data)
                if dspan is not None:
                    lo_d, width = dspan
                    counts_d = _partition_bincount(data.astype(np.int64) - lo_d, width)
            merged_span = merge_discrete_span(old.discrete_span, int_span(data))
            if merged_span is not None:
                hh_stats_d, hh_items_d, _, _ = _heavy_hitters_exact(counts_d)
                hh_stats = np.concatenate([old.hh_stats, hh_stats_d], axis=0)
                hh_items = list(old.hh_items) + [
                    {k + lo_d: v for k, v in d.items()} for d in hh_items_d
                ]
            else:
                # the append disqualified the column: a cold build reports
                # no heavy hitters for ANY partition, so the old rows are
                # zeroed too — the one case where an append touches them
                hh_stats = np.zeros((n, 3), np.float64)
                hh_items = [dict() for _ in range(n)]
            old_spans = (
                old.part_spans
                if old.part_spans is not None
                else partition_int_spans(table.columns[spec.name][:start])
            )
            cols[spec.name] = ColumnSketch(
                spec.name, NUMERIC,
                np.concatenate([old.measures, measures_d], axis=0),
                np.concatenate([old.hist_edges, edges_d], axis=0),
                None, ndv, dv_freq, hh_stats, hh_items, None, None,
                discrete_span=merged_span,
                part_spans=np.concatenate([old_spans, partition_int_spans(data)], axis=0),
            )
        else:
            if backend == "device":
                counts_d = stats[spec.name]["counts"]
            else:
                counts_d = _partition_bincount(data, spec.cardinality)
            counts = np.concatenate([old.cat_counts, counts_d], axis=0)
            # full-P recompute from the merged exact counts: no row reads,
            # and bitwise what the cold pass computes
            hh_stats, hh_items, freq, is_hh = _heavy_hitters_exact(counts)
            ghh = bitmap = None
            if spec.groupable:
                ghh, bitmap = _global_heavy_hitters(freq, is_hh, spec.cardinality)
            cols[spec.name] = ColumnSketch(
                spec.name, CATEGORICAL, np.zeros((n, 9)), None, counts,
                ndv, dv_freq, hh_stats, hh_items, ghh, bitmap,
            )
    return TableSketches(sk.table_name, n, table.rows_per_partition, cols)


def gather_sketches(sk: TableSketches, table: Table, idx: np.ndarray) -> TableSketches:
    """Reorder or shrink ``sk`` to partitions ``idx`` (in the numbering
    ``sk`` covers): the lifecycle fold of a compaction (``idx`` = the
    surviving slots) and of a rebalance (``idx`` = the permutation).

    Every per-partition tensor is a function of its partition's rows, so
    the gather is bitwise what a cold `build_sketches` of the reorganized
    table computes.  Only the global reductions re-fold:

      * discrete-numeric spans re-fold from `ColumnSketch.part_spans`
        (`core.ingest.fold_partition_spans`).  The survivors can only
        *re*-qualify a column that an earlier append disqualified; then
        the exact counts are recomputed from the surviving rows, as the
        cold pass over them does (host numpy: O(survivors));
      * categorical global heavy hitters and bitmaps recompute from the
        gathered counts in the gathered partition order, so the float
        fold matches the cold pass bit for bit.

    ``table`` must already hold the reorganized columns, with slots
    ``[0, len(idx))`` matching ``idx``'s gather (later appends may extend
    it; they fold separately).  Returns a new `TableSketches`.
    """
    idx = np.asarray(idx, dtype=np.int64)
    n = idx.size
    cols: dict[str, ColumnSketch] = {}
    for spec in table.schema:
        old = sk.columns[spec.name]
        ndv = old.ndv[idx]
        dv_freq = old.dv_freq[idx]
        if spec.kind == NUMERIC:
            pspans = (
                old.part_spans[idx]
                if old.part_spans is not None
                else partition_int_spans(table.columns[spec.name][:n])
            )
            span = fold_partition_spans(pspans)
            if span is None:
                hh_stats = np.zeros((n, 3), np.float64)
                hh_items = [dict() for _ in range(n)]
                dspan = None
            elif old.discrete_span is not None:
                # still qualified: per-partition heavy-hitter rows do not
                # depend on the span, so they ride the gather; only the
                # recorded union narrows
                hh_stats = old.hh_stats[idx]
                hh_items = [old.hh_items[i] for i in idx]
                dspan = (span[0], span[0] + span[1] - 1)
            else:
                # re-qualified: an earlier append blew the span cap and the
                # survivors fit again — exact counts from the surviving
                # rows, as the cold pass over them computes
                lo, width = span
                counts = _partition_bincount(
                    table.columns[spec.name][:n].astype(np.int64) - lo, width
                )
                hh_stats, items_raw, _, _ = _heavy_hitters_exact(counts)
                hh_items = [{k + lo: v for k, v in d.items()} for d in items_raw]
                dspan = (lo, lo + width - 1)
            cols[spec.name] = ColumnSketch(
                spec.name, NUMERIC, old.measures[idx], old.hist_edges[idx],
                None, ndv, dv_freq, hh_stats, hh_items, None, None,
                discrete_span=dspan, part_spans=pspans,
            )
        else:
            counts = old.cat_counts[idx]
            hh_stats, hh_items, freq, is_hh = _heavy_hitters_exact(counts)
            ghh = bitmap = None
            if spec.groupable:
                ghh, bitmap = _global_heavy_hitters(freq, is_hh, spec.cardinality)
            cols[spec.name] = ColumnSketch(
                spec.name, CATEGORICAL, np.zeros((n, 9)), None, counts,
                ndv, dv_freq, hh_stats, hh_items, ghh, bitmap,
            )
    return TableSketches(sk.table_name, n, table.rows_per_partition, cols)


class SketchStore:
    """Version-tracked sketch holder for one table.

    Builds the sketches at construction and hands them out through
    `sketches()`, which checks `Table.version` and folds the pending
    `Table.mutation_events`: appends extend the sketches through
    `update_sketches` (O(new partitions)), a compaction or a rebalance
    gathers them through `gather_sketches` (O(touched)), and a delete
    changes nothing (tombstoned slots keep their sketch rows; consumers
    filter by `Table.live_mask`).  Only a chain that
    `data.table.events_foldable` refuses, or an unlogged bump, rebuilds in
    full (`build_sketches`).  ``incremental_updates`` / ``full_rebuilds``
    count which path each sync took.  ``plane`` is the partition plane the
    device backend's ingest kernels run on (``options.mesh``), resolved
    once at construction: every build and update of the store runs on it,
    not on whatever ``"auto"`` resolves to later.
    """

    def __init__(self, table: Table, *, options: ExecOptions | None = None):
        self.table = table
        self.options = options if options is not None else ExecOptions()
        self.plane = self.options.plane()
        self._pinned = self.options.replace(mesh=self.plane)
        self.incremental_updates = 0
        self.full_rebuilds = 0
        self._sk = build_sketches(table, options=self._pinned)
        self._version = table.version

    def sketches(self) -> TableSketches:
        """The current table's sketches, incrementally maintained."""
        if self.table.version == self._version:
            return self._sk
        events = self.table.mutation_events(self._version)
        if events is None or not events_foldable(events):
            self.full_rebuilds += 1
            self._sk = build_sketches(self.table, options=self._pinned)
        else:
            self.incremental_updates += 1
            for ev in events:
                if ev[0] == "append":
                    # one update covers every remaining append: it reads
                    # [start:) of the final table, and no move follows it
                    # (events_foldable)
                    if self._sk.num_partitions == ev[1]:
                        with record_function("stream.sketches"):
                            self._sk = update_sketches(
                                self._sk, self.table, ev[1], options=self._pinned
                            )
                elif ev[0] != "delete":  # compact / rebalance: gather
                    with record_function("lifecycle.sketches"):
                        self._sk = gather_sketches(self._sk, self.table, np.asarray(ev[1]))
        self._version = self.table.version
        return self._sk


def sketch_storage_bytes(table: Table, sk: TableSketches) -> dict[str, float]:
    """Average bytes per partition, itemized like Table 4."""
    n = table.num_partitions
    hist = meas = akmv = hh = 0.0
    for spec in table.schema:
        cs = sk.columns[spec.name]
        if spec.kind == NUMERIC:
            hist += (NUM_BUCKETS + 1) * 8 * n
            meas += 9 * 8 * n
        else:
            # small-domain columns stored exactly (paper §3.2 special case)
            hist += min(spec.cardinality, 256) * (8 + 4) * n
        # AKMV: k min-hashes (8B) + counts (4B); if ndv<k, proportional.
        kk = np.minimum(cs.ndv, AKMV_K)
        akmv += float(np.sum(kk * (8 + 4)))
        if cs.hh_items is not None:
            hh += sum(len(d) * (8 + 4) for d in cs.hh_items)
        if cs.bitmap is not None:
            hh += cs.bitmap.shape[1] / 8 * n
    total = hist + meas + akmv + hh
    return {
        "total_kb": total / n / 1024,
        "histogram_kb": hist / n / 1024,
        "hh_kb": hh / n / 1024,
        "akmv_kb": akmv / n / 1024,
        "measure_kb": meas / n / 1024,
    }
