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
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.backends import ExecOptions
from repro_torch.data.table import NUMERIC, Table
from repro_torch.kernels import ops


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
    or None when any value is non-integral (no width cap)."""
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


def discrete_span(data: np.ndarray, max_width: int = MAX_DISCRETE_WIDTH) -> tuple[int, int] | None:
    """(lo, width) when a numeric column is integer-valued with a small
    range — the case where exact heavy-hitter counts apply — else None."""
    span = int_span(data)
    if span is None:
        return None
    lo, hi = span
    width = hi - lo + 1
    return (lo, width) if width <= max_width else None


def build_statistics(
    table: Table,
    discrete_counts: bool = False,
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
    """
    options = options if options is not None else ExecOptions()
    device = options.torch_device()
    out: dict[str, dict] = {}
    rows = table.rows_per_partition
    for spec in table.schema:
        data = table.columns[spec.name]
        if spec.kind == NUMERIC:
            # ships once, feeds both counting kernels
            x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(device)
            mom = ops.moments_op(x).cpu().numpy()
            with record_function("ingest.quantile"):
                edges = np.quantile(
                    data.astype(np.float64), np.linspace(0, 1, 11), axis=1
                ).T
            e32 = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(device)
            hist = ops.histogram_range_op(x, e32).cpu().numpy()
            out[spec.name] = {
                "measures": measures_from_moments(mom, rows, spec.positive),
                "hist_edges": edges,
                "hist_counts": hist,
            }
            if discrete_counts:
                span = discrete_span(data)
                if span is not None:
                    lo, width = span
                    codes = torch.from_numpy((data.astype(np.int64) - lo).astype(np.int32))
                    counts = ops.bincount_op(codes.to(device), width).cpu().numpy()
                    out[spec.name]["discrete_counts"] = counts.astype(np.float64)
                    out[spec.name]["discrete_lo"] = lo
        else:
            codes = torch.from_numpy(np.ascontiguousarray(data, np.int32)).to(device)
            counts = ops.bincount_op(codes, spec.cardinality).cpu().numpy()
            out[spec.name] = {"counts": counts.astype(np.float64)}
    return out
