"""Kernel sketch construction — the device ingest pass.

`build_statistics` computes the numeric tensors behind every sketch
(measures, categorical counts, histogram bucket counts, discrete-numeric
heavy-hitter counts) with the kernel layer in a single pass per column;
it is the engine behind `core.sketches.build_sketches` on the device
backend and is held to the host tensors.

Each column ships to the device once and feeds every counting kernel it
needs (moments + histogram_range for numerics, bincount for codes).  The
AKMV hashes and the equi-depth edge *placement* stay on the host: the
hashes need 53 bits (float64) and the edges a sort, and `np.quantile` in
float64, cast to f32, gives edges bit-equal to the reference's — only
the f32 compares run on the device.

**Streaming merge path.**  Every statistic here is mergeable: per-
partition tensors concatenate along P, and the discrete heavy-hitter
counts re-embed into the union of their integer spans.
`delta_statistics` computes the tensors of only the partitions appended
since a snapshot and `merge_statistics` reassembles the full-table
result bit-identically: the kernels read only the new partitions; the
merge concatenates host arrays of all P.  `TRACES`
counts the kernel passes per padded shape, so a stream of appends keeps
a flat set of launch keys (the reference's compile census).

**Partition plane.**  Under ``options.plane()``
(`distributed/dataplane.py`) each column is zero-padded along P to a
plane multiple and split into one shard a device; every counting kernel
runs once per shard over its local partitions, and only the small (P, k)
results are gathered, the pad sliced off.  Each partition is still
folded by one kernel block, so the tensors are bit-identical to the
single-device ones, and the launch keys are taken at local shapes.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.backends import ExecOptions
from repro_torch.core.clustering import bucket_size
from repro_torch.data.table import NUMERIC, Table
from repro_torch.distributed import dataplane
from repro_torch.kernels import ops
from repro_torch.kernels.telemetry import TraceRegistry

TRACES = TraceRegistry("ingest")


def measures_from_moments(raw: np.ndarray, rows: int, positive: bool) -> np.ndarray:
    """Map kernel moments (P, 8) → paper measure layout (P, 9).

    Layout (sketches.MEASURE_NAMES): mean, min, max, meansq, std,
    logmean, logmeansq, logmin, logmax.
    """
    p = raw.shape[0]
    out = np.zeros((p, 9), np.float64)
    mn, mx, s, ss, lmn, lmx, ls, lss = [raw[:, i].astype(np.float64) for i in range(8)]
    out[:, 0] = s / rows
    out[:, 1] = mn
    out[:, 2] = mx
    out[:, 3] = ss / rows
    out[:, 4] = np.sqrt(np.maximum(ss / rows - (s / rows) ** 2, 0.0))
    if positive:
        out[:, 5] = ls / rows
        out[:, 6] = lss / rows
        out[:, 7] = lmn
        out[:, 8] = lmx
    return out


def int_span(data: np.ndarray) -> tuple[int, int] | None:
    """(lo, hi) inclusive integer span of an integer-valued numeric column,
    or None when any value is non-integral (no width cap — the raw
    mergeable form `merge_statistics` combines across appends)."""
    if data.size == 0:
        return None
    codes = data.astype(np.int64)
    if not np.all(data == codes):
        return None
    return int(codes.min()), int(codes.max())


MAX_DISCRETE_WIDTH = 4096


def partition_int_spans(data: np.ndarray) -> np.ndarray:
    """Per-partition integer spans of a (P, R) numeric column:
    ``(P, 3) int64`` rows ``[lo, hi, ok]`` where ``ok`` is 1 iff every
    value in that partition is integral — `int_span` per partition."""
    p = data.shape[0]
    out = np.zeros((p, 3), np.int64)
    if data.size == 0:
        return out
    codes = data.astype(np.int64)
    ok = np.all(data == codes, axis=1)
    out[:, 0] = np.where(ok, codes.min(axis=1), 0)
    out[:, 1] = np.where(ok, codes.max(axis=1), 0)
    out[:, 2] = ok.astype(np.int64)
    return out


def fold_partition_spans(
    spans: np.ndarray, max_width: int = MAX_DISCRETE_WIDTH
) -> tuple[int, int] | None:
    """Fold (P, 3) per-partition spans into the column-level
    `discrete_span` result — ``(lo, width)`` iff every partition is
    integral and the union span fits the width cap, else None.  Agrees
    with `discrete_span` over the concatenated rows by construction."""
    if spans.shape[0] == 0 or not np.all(spans[:, 2] == 1):
        return None
    lo = int(spans[:, 0].min())
    hi = int(spans[:, 1].max())
    width = hi - lo + 1
    return (lo, width) if width <= max_width else None


def discrete_span(data: np.ndarray, max_width: int = MAX_DISCRETE_WIDTH) -> tuple[int, int] | None:
    """(lo, width) when a numeric column is integer-valued with a small
    range — the case where exact heavy-hitter counts apply — else None."""
    span = int_span(data)
    if span is None:
        return None
    lo, hi = span
    width = hi - lo + 1
    return (lo, width) if width <= max_width else None


def merge_discrete_span(
    old_span: tuple[int, int] | None,
    new_span: tuple[int, int] | None,
    max_width: int = MAX_DISCRETE_WIDTH,
) -> tuple[int, int] | None:
    """Union of two observed inclusive (lo, hi) integer spans, or None
    when either side is disqualified (non-integral values, or never
    qualified) or the union exceeds the width cap — the cold pass's
    qualification rule, shared by `merge_statistics` and
    `core.sketches.update_sketches`."""
    if old_span is None or new_span is None:
        return None
    lo = min(old_span[0], new_span[0])
    hi = max(old_span[1], new_span[1])
    return (lo, hi) if hi - lo + 1 <= max_width else None


# --------------------------------------------------------------------------
# mergeable-statistic primitives (streaming ingest)
# --------------------------------------------------------------------------
# Raw kernel-moment layout (`kernels/moments.py`): [min, max, sum, sumsq,
# logmin, logmax, logsum, logsumsq].  Sums add, extrema combine by
# min/max, so two row-chunks of the same partitions merge in O(P).  The
# live append path is partition-granular (`delta_statistics` +
# `merge_statistics`); the row-chunk forms are the mergeability property
# the tests hold, and oracles for sub-partition streaming.
_MOMENT_MERGE = ("min", "max", "add", "add", "min", "max", "add", "add")


def merge_moments(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge raw (P, 8) kernel moments of two row-chunks of the same
    partitions.  Exact for min/max; float sums are re-associated, so a
    merged result matches the one-pass kernel to f32 rounding, not
    bitwise (the append path never merges within a partition)."""
    out = np.empty_like(a)
    for i, how in enumerate(_MOMENT_MERGE):
        if how == "add":
            out[:, i] = a[:, i] + b[:, i]
        elif how == "min":
            out[:, i] = np.minimum(a[:, i], b[:, i])
        else:
            out[:, i] = np.maximum(a[:, i], b[:, i])
    return out


def merge_bincounts(
    a: np.ndarray, b: np.ndarray, lo_a: int = 0, lo_b: int = 0
) -> tuple[np.ndarray, int]:
    """Elementwise-add two (P, width) count tensors whose first bins sit at
    absolute values ``lo_a`` / ``lo_b``; returns (merged, lo_merged).
    Counts are exact integers (held in float64), so aligning into the
    union span and adding is bit-identical to counting the union."""
    lo = min(lo_a, lo_b)
    hi = max(lo_a + a.shape[1], lo_b + b.shape[1])
    out = np.zeros((a.shape[0], hi - lo), np.float64)
    out[:, lo_a - lo : lo_a - lo + a.shape[1]] += a
    out[:, lo_b - lo : lo_b - lo + b.shape[1]] += b
    return out, lo


def _embed_counts(counts: np.ndarray, lo: int, new_lo: int, new_width: int) -> np.ndarray:
    """Zero-embed (P, w) counts at span ``lo`` into a wider span."""
    out = np.zeros((counts.shape[0], new_width), np.float64)
    off = lo - new_lo
    out[:, off : off + counts.shape[1]] = counts
    return out


def _pad_partitions(arr: np.ndarray, target: int) -> np.ndarray:
    pad = target - arr.shape[0]
    if pad <= 0:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths)


def _shards(plane, device, arr: np.ndarray, dtype) -> list[torch.Tensor]:
    """One host→device transfer of a (P, ...) operand: whole on ``device``,
    or zero-padded to a plane multiple and split one shard a device."""
    host = np.ascontiguousarray(arr, dtype)
    if plane is None:
        return [torch.from_numpy(host).to(device)]
    return list(plane.shard_partitions(host).shards)


def _per_partition(plane, p: int, fn, *operands) -> np.ndarray:
    """``fn`` on each shard's operands → the (p, k) host result in shard
    order, the pad sliced off.  Every shard's launch is issued before the
    first readback."""
    if plane is None:
        return fn(*(o[0] for o in operands)).cpu().numpy()[:p]
    return plane.gather(dataplane.sharded_call(plane, fn, operands), p)


def _moments(x):
    TRACES.note("moments", *x.shape)
    return ops.moments_op(x)


def _hist(x, edges):
    TRACES.note("hist", *x.shape, edges.shape[1])
    return ops.histogram_range_op(x, edges)


def _bincount(card: int):
    def run(codes):
        TRACES.note("bincount", *codes.shape, card)
        return ops.bincount_op(codes, card)

    return run


def build_statistics(
    table: Table,
    discrete_counts: bool = False,
    partitions: tuple[int, int] | None = None,
    *,
    options: ExecOptions | None = None,
) -> dict[str, dict]:
    """Kernel-computed per-column statistics tensors on ``options.device``.

    Returns {column: {"measures": (P,9)} | {"counts": (P,card)}} plus
    numeric histogram counts under "hist_counts" given equi-depth edges.
    With ``discrete_counts=True``, integer-valued numeric columns with a
    small range additionally carry exact per-partition frequencies
    ("discrete_counts", "discrete_lo") — the heavy-hitter input that
    `build_sketches` consumes on the device backend.

    ``partitions`` restricts the pass to a half-open partition range — the
    streaming *delta* path (`delta_statistics`).  A delta range is
    zero-padded up to a power-of-two partition bucket before the kernels
    run (the pad rows are sliced off before anything reads them), and so
    is its discrete bin count, so a stream of appends of any size keeps
    the `TRACES` keys at the bucket count.  Every kernel folds each
    partition on its own, so each row is what the full pass computes —
    what lets `merge_statistics` reassemble a bit-identical result.
    Delta passes also report the raw integer span of the delta rows
    ("discrete_range_span", None once a non-integral value arrived).

    On a partition plane (``options.plane()``) the (padded) partitions are
    further zero-padded to a plane multiple and every kernel runs once
    per shard; the tensors are bit-identical to the single-device ones.
    """
    options = options if options is not None else ExecOptions()
    device = options.torch_device()
    plane = options.plane()
    out: dict[str, dict] = {}
    lo_part, hi_part = partitions if partitions is not None else (0, table.num_partitions)
    p = hi_part - lo_part
    delta = partitions is not None
    # delta passes pad to a bucket so the launch keys stay bounded; the
    # full pass keeps its exact-P shapes
    pb = bucket_size(p, minimum=1) if delta else p
    rows = table.rows_per_partition

    def upload(arr: np.ndarray, dtype) -> list[torch.Tensor]:
        return _shards(plane, device, _pad_partitions(arr, pb), dtype)

    for spec in table.schema:
        data = table.columns[spec.name][lo_part:hi_part]
        if spec.kind == NUMERIC:
            # ships once, feeds both counting kernels
            x = upload(data, np.float32)
            mom = _per_partition(plane, p, _moments, x)
            with record_function("ingest.quantile"):
                edges = np.quantile(
                    data.astype(np.float64), np.linspace(0, 1, 11), axis=1
                ).T
            hist = _per_partition(plane, p, _hist, x, upload(edges, np.float32))
            out[spec.name] = {
                "measures": measures_from_moments(mom, rows, spec.positive),
                "hist_edges": edges,
                "hist_counts": hist,
            }
            if discrete_counts:
                span = discrete_span(data)
                if delta:
                    # merge_statistics decides from it whether the merged
                    # column still qualifies
                    out[spec.name]["discrete_range_span"] = int_span(data)
                if span is not None:
                    lo, width = span
                    codes = upload(data.astype(np.int64) - lo, np.int32)
                    # the observed width varies with each delta's data:
                    # bucket it too (pad bins receive no codes)
                    wb = bucket_size(width, minimum=1) if delta else width
                    counts = _per_partition(plane, p, _bincount(wb), codes)[:, :width]
                    out[spec.name]["discrete_counts"] = counts.astype(np.float64)
                    out[spec.name]["discrete_lo"] = lo
        else:
            codes = upload(data, np.int32)
            counts = _per_partition(plane, p, _bincount(spec.cardinality), codes)
            out[spec.name] = {"counts": counts.astype(np.float64)}
    return out


def delta_statistics(
    table: Table,
    start: int,
    discrete_counts: bool = False,
    *,
    options: ExecOptions | None = None,
) -> dict[str, dict]:
    """Statistics tensors of only the partitions appended at/after
    ``start`` — the kernel half of the streaming ingest, which reads only
    the new partitions.  Feed
    the result to `merge_statistics` with the pre-append tensors to get
    the full-table statistics bit-identically."""
    return build_statistics(
        table, discrete_counts=discrete_counts,
        partitions=(start, table.num_partitions), options=options,
    )


def merge_statistics(
    old: dict[str, dict], delta: dict[str, dict]
) -> dict[str, dict]:
    """Merge pre-append statistics with a `delta_statistics` result.

    Per-partition tensors (measures, histogram edges/counts, categorical
    counts) concatenate along P — appended partitions never touch existing
    rows, so the merge is bit-identical to a cold `build_statistics` over
    the grown table.  Discrete heavy-hitter counts are the one global
    tensor: their span is the column's observed integer range, so an
    append can widen it (both sides re-embed into the union span — exact,
    see `merge_bincounts`), push its width past ``MAX_DISCRETE_WIDTH``, or
    break integrality (the counts are dropped, as the cold pass decides).
    """
    out: dict[str, dict] = {}
    for col, old_t in old.items():
        new_t = delta[col]
        merged: dict = {}
        if "counts" in old_t:  # categorical: fixed cardinality, concat
            merged["counts"] = np.concatenate([old_t["counts"], new_t["counts"]], axis=0)
            out[col] = merged
            continue
        for key in ("measures", "hist_edges", "hist_counts"):
            merged[key] = np.concatenate([old_t[key], new_t[key]], axis=0)
        old_counts = old_t.get("discrete_counts")
        if old_counts is not None:
            lo_old = old_t["discrete_lo"]
            if new_t["measures"].shape[0] == 0:  # empty append: the old tensors stand
                merged["discrete_counts"] = old_counts
                merged["discrete_lo"] = lo_old
            else:
                span = merge_discrete_span(
                    (lo_old, lo_old + old_counts.shape[1] - 1),
                    new_t.get("discrete_range_span"),
                )
                if span is not None:
                    # union span; realigning exact integer counts is exact
                    lo, hi = span
                    width = hi - lo + 1
                    merged["discrete_counts"] = np.concatenate(
                        [
                            _embed_counts(old_counts, lo_old, lo, width),
                            _embed_counts(new_t["discrete_counts"], new_t["discrete_lo"],
                                          lo, width),
                        ],
                        axis=0,
                    )
                    merged["discrete_lo"] = lo
                # else: span broken or width blown — drop, like the cold pass
        out[col] = merged
    return out
