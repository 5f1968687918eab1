#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--partitions 1024] [--rows 16384] [--queries 48]
                          [--held-out 16] [--offline-partitions 256] [--seed 0]

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path hands it: counts, histograms, bincounts, GBDT
   histograms and their prefix sums bit-equal, f32 sums and distances
   within the tolerance printed beside them; with the kernel's time, the
   plain version's, the least time the card could take and the time of
   a PyTorch library call computing the same function (a yardstick the
   port never calls);
4. the offline plane (slice 1's path) on the first ``--offline-partitions``
   partitions: ``build_sketches`` and ``per_partition_answers_batch`` on
   the default options, every one of its kernels launched, held against
   the port's host backend;
5. the Session path at full size: ``Session(table).prepare(WorkloadSpec
   (table), num_train_queries=48)`` with the default ``PickerConfig``,
   then ``Session.execute(QuerySpec(q, error_bound=0.05))`` on held-out
   queries, under ``torch.profiler``: every kernel launched, wall times of
   prepare's parts, execute times, partitions read, coverage and error
   against the exact answers, beside a 5%-uniform partition sample;
6. the first trees of the first funnel model fitted again on the card
   and on the host: the forests must be bit-equal;
7. the ``kernels`` JSON line, then ``{"ok": true, ...}`` as the last line.

Without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SUM_RTOL = 1e-4  # f32 sums: see check_answers
ERROR_BOUND = 0.05
FOREST_CHECK_TREES = 4

SOURCES = {  # kernel → (CUDA source, the TPU kernel it replaces)
    "fused_eval": ("src/repro_torch/csrc/eval.cu", "src/repro/kernels/fused.py:84"),
    "group_aggregate": ("src/repro_torch/csrc/eval.cu", "src/repro/kernels/groupagg.py:63"),
    "moments": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/moments.py:72"),
    "histogram_range": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/histogram.py:60"),
    "bincount": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/histogram.py:96"),
    "tree_hist": ("src/repro_torch/csrc/tree_hist.cu", "src/repro/kernels/tree_hist.py:78"),
    # the reference's prefix sum is an XLA loop, not a Pallas kernel
    "cumsum_seq": ("src/repro_torch/csrc/tree_hist.cu", "src/repro/core/gbdt.py:321"),
    "pdist_sq": ("src/repro_torch/csrc/pdist.cu", "src/repro/kernels/pdist.py:53"),
}
OFFLINE_KERNELS = ("fused_eval", "group_aggregate", "moments", "histogram_range", "bincount")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--partitions", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--queries", type=int, default=48)
    ap.add_argument("--held-out", type=int, default=16)
    ap.add_argument("--offline-partitions", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time the card could take (ms) and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Case:
    """One kernel call at a main-path shape.  ``tol`` is "bits" (bit-equal),
    "sums" (component 0 counts bit-equal, f32 sums allclose 1e-5/1e-4) or
    (rtol, atol); ``nbytes``/``ops`` are what the call must move and do."""

    name: str
    kernel: object
    plain: object
    args: tuple
    tol: object
    nbytes: float
    ops: float
    library: tuple | None  # (description, fn) of one PyTorch call, or None
    shape: str


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at main-path shapes
# --------------------------------------------------------------------------
def kernel_cases(table, queries, dev) -> list[Case]:
    """The offline plane's kernels with the operands the main path hands
    them: one numeric and one categorical column of the table, and the
    first stacked chunk of each eval kernel in the workload's launch order."""
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.kernels import fused, groupagg, histogram, moments
    from repro_torch.queries import device
    from repro_torch.queries.engine import EvalCache

    p, r = table.num_partitions, table.rows_per_partition
    cases = []

    data = table.columns["l_extendedprice"]
    x = torch.from_numpy(np.ascontiguousarray(data)).to(dev)

    def lib_moments():
        lx = torch.log(torch.clamp_min(x, 1e-30))
        return (torch.aminmax(x, dim=1), torch.sum(x, dim=1), torch.sum(x * x, dim=1),
                torch.aminmax(lx, dim=1), torch.sum(lx, dim=1), torch.sum(lx * lx, dim=1))

    cases.append(Case("moments", moments.moments, moments.moments_plain, (x,), "close",
                      p * r * 4 + p * 8 * 4, p * r * 10,
                      ("torch.aminmax + torch.sum over x and log x", lib_moments), f"{p}x{r}"))

    edges = np.quantile(data.astype(np.float64), np.linspace(0, 1, 11), axis=1).T
    e = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(dev)
    nb = e.shape[1] - 1
    offs = torch.arange(p, device=dev)[:, None] * (nb + 2)

    def lib_hist():
        k = torch.searchsorted(e, x, right=True) - 1  # lo <= x < hi
        k = torch.where(x == e[:, -1:], nb - 1, k).clamp_(-1, nb)  # last bucket closed
        return torch.bincount((k + 1 + offs).view(-1), minlength=p * (nb + 2))

    cases.append(Case("histogram_range", histogram.histogram_range,
                      histogram.histogram_range_plain, (x, e), "bits",
                      p * r * 4 + p * (2 * nb + 1) * 4, p * r * nb * 3,
                      ("torch.searchsorted + torch.bincount", lib_hist), f"{p}x{r}"))

    card = table.spec("l_partkey").cardinality
    codes = torch.from_numpy(np.ascontiguousarray(table.columns["l_partkey"])).to(dev)
    seg = (codes.long() + torch.arange(p, device=dev)[:, None] * card).view(-1)
    cases.append(Case("bincount", histogram.bincount, histogram.bincount_plain, (codes, card),
                      "bits", p * r * 4 + p * card * 4, p * r,
                      ("torch.bincount on offset codes",
                       lambda: torch.bincount(seg, minlength=p * card)), f"{p}x{r}"))

    cache = EvalCache(table, options=ExecOptions(device=str(dev)))
    chunks, _ = device.plan_launches(table, queries, cache)
    picked = {}
    for chunk in chunks:
        kind = "fused_eval" if chunk[0][1].sig.has_predicate else "group_aggregate"
        picked.setdefault(kind, chunk)
    for kind, chunk in picked.items():
        name, args = device.kernel_call([pl for _, pl in chunk], cache)
        radix = args[-1]
        # bytes: what decides each row's fate is read for every row (clause
        # columns + descriptors, or the mask), values and codes only for
        # the rows that pass; ops: two compares a clause, V adds a pass
        if name == "fused_eval":
            xs, lo, hi, gmap, values, codes_c, _ = args
            keep = fused.predicate_rows(xs, lo, hi, gmap)
            head = sum(t.numel() * 4 for t in (xs, lo, hi, gmap))
            ops = 2 * xs.numel()
        else:
            values, mask, codes_c, _ = args
            keep = mask != 0
            head = mask.numel() * 4
            ops = mask.numel()
        keep = keep & (codes_c >= 0) & (codes_c < radix)
        b, v, _ = values.shape
        passing = int(keep.sum())
        nbytes = head + passing * (v + 1) * 4 + b * v * radix * 4
        ops += passing * v
        library = None
        if name == "group_aggregate":
            rows = keep.nonzero(as_tuple=True)
            flat = ((rows[0][:, None] * v + torch.arange(v, device=dev)) * radix
                    + codes_c[rows][:, None].long()).view(-1)
            vals = (values * mask[:, None, :]).transpose(1, 2)[rows].reshape(-1)
            acc = torch.zeros(b * v * radix, device=dev)
            library = ("torch.Tensor.index_add_", lambda: acc.index_add_(0, flat, vals))
        kernel = fused.fused_eval if name == "fused_eval" else groupagg.group_aggregate
        plain = fused.fused_eval_plain if name == "fused_eval" else groupagg.group_aggregate_plain
        shape = "x".join(str(s) for s in args[0].shape) + f", radix {radix}"
        cases.append(Case(name, kernel, plain, args, "sums", nbytes, ops, library, shape))
    return cases


def picker_cases(n_rows: int, n_feat: int, n_partitions: int, dev, seed: int) -> list[Case]:
    """The picker's kernels at the Session path's shapes, from seeded data:
    one GBDT level (the funnel fit's rows, sampled features and 16 nodes)
    and the prefix sums of its histograms; one KMeans assignment of feature
    selection (every partition against its largest cluster bucket)."""
    import numpy as np
    import torch

    from repro_torch.core.clustering import bucket_size
    from repro_torch.core.gbdt import NUM_BINS
    from repro_torch.kernels import pdist, tree_hist

    rng = np.random.default_rng(seed)
    cases = []
    # tree_hist: rowsample 0.5 of the training rows padded to a power of
    # two, colsample 0.7 of the features, the deepest level's 16 nodes
    nt = min(n_rows, max(32, int(0.5 * n_rows)))
    r, c, nodes = bucket_size(nt), max(1, int(0.7 * n_feat)), 16
    codes_t = torch.from_numpy(rng.integers(0, NUM_BINS, size=(c, r), dtype=np.int32)).to(dev)
    fids = torch.from_numpy(np.sort(rng.choice(n_feat, size=c, replace=False))
                            .astype(np.int32)).to(dev)
    node = np.full(r, -1, np.int32)
    node[:nt] = rng.integers(0, nodes, size=nt)
    node = torch.from_numpy(node).to(dev)
    g = torch.from_numpy(rng.normal(size=r).astype(np.float32)).to(dev)
    h = torch.from_numpy((rng.random(r) + 0.5).astype(np.float32)).to(dev)
    args = (codes_t.T, fids, node, g, h, nodes, n_feat, NUM_BINS)
    out_elems = 2 * nodes * n_feat * NUM_BINS
    seg = ((node.long()[None, :] * n_feat + fids.long()[:, None]) * NUM_BINS
           + codes_t.long())[:, node >= 0].T.reshape(-1)  # row-major (row, column)
    src = torch.stack([g[node >= 0], h[node >= 0]], 1).repeat_interleave(c, 0)
    acc = torch.zeros((nodes * n_feat * NUM_BINS, 2), device=dev)
    cases.append(Case(
        "tree_hist", tree_hist.tree_hist, tree_hist.tree_hist_plain, args, "bits",
        (c * r + 3 * r + c) * 4 + out_elems * 4, 2 * nt * c,
        ("torch.Tensor.index_put_(accumulate=True)",
         lambda: acc.index_put_((seg,), src, accumulate=True)),
        f"{r}x{c}, {nodes} nodes, {n_feat} features"))
    hist = tree_hist.tree_hist(*args)
    cases.append(Case("cumsum_seq", tree_hist.cumsum_seq, tree_hist.cumsum_seq_plain, (hist,),
                      "bits", 2 * out_elems * 4, out_elems,
                      ("torch.cumsum", lambda: torch.cumsum(hist, dim=-1)),
                      "x".join(str(s) for s in hist.shape)))
    # pdist_sq: feature selection clusters every partition (a power-of-two
    # row bucket) into its largest budget, 20% of the partitions
    n, k = bucket_size(n_partitions), bucket_size(int(0.2 * n_partitions))
    x = torch.from_numpy(rng.normal(size=(n, n_feat)).astype(np.float32)).to(dev)
    cent = torch.from_numpy(rng.normal(size=(k, n_feat)).astype(np.float32)).to(dev)
    cases.append(Case("pdist_sq", pdist.pdist_sq, pdist.pdist_sq_plain, (x, cent), (1e-4, 1e-3),
                      (n * n_feat + k * n_feat + n * k) * 4,
                      2 * n * k * n_feat + 2 * (n + k) * n_feat,
                      ("torch.cdist(x, c) ** 2", lambda: torch.cdist(x, cent) ** 2),
                      f"{n}x{n_feat} by {k}x{n_feat}"))
    return cases


def compare(got, want, tol) -> float:
    """Max abs error; raises unless bit-equal ("bits"), counts bit-equal and
    sums allclose(1e-5, 1e-4) ("sums"), allclose(2e-5, 2e-4) ("close":
    moments), or allclose at an explicit (rtol, atol)."""
    import numpy as np

    g, w = got.cpu().numpy(), want.cpu().numpy()
    if tol == "bits":
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))
    elif tol == "sums":
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    elif tol == "close":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1])
    return float(np.nanmax(np.abs(g - w))) if g.size else 0.0


TOLERANCE_TEXT = {
    "bits": "bit-equal",
    "sums": "counts bit-equal, sums rtol 1e-5 atol 1e-4 (f32 sums in another order)",
    "close": "rtol 1e-5 atol 1e-4 (f32 sums in another order)",
}


def run_kernel_phase(cases: list[Case]) -> dict:
    """Phase 3 → {name: record} for the kernels line (launches added later)."""
    import torch

    from repro_torch.kernels import _build

    records = {}
    for case in cases:
        name, kernel, plain, args = case.name, case.kernel, case.plain, case.args
        got = kernel(*args)
        again = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got.nan_to_num(), again.nan_to_num()):
            raise AssertionError(f"{name}: two runs gave different bits")
        err = compare(got, want, case.tol)
        extra = ""
        if name == "pdist_sq":
            if not torch.equal(got.argmin(dim=1), want.argmin(dim=1)):
                raise AssertionError("pdist_sq: nearest centers differ from the plain version")
            extra = "; argmin equal"
        ms = cuda_ms(lambda: kernel(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        lib_ms = cuda_ms(case.library[1], 20) if case.library else None
        bound_ms, bound_by = bound(case.nbytes, case.ops)
        tol = TOLERANCE_TEXT.get(case.tol, f"rtol {case.tol[0]:g} atol {case.tol[1]:g}"
                                 if isinstance(case.tol, tuple) else case.tol)
        print(f"[kernel] {name} {case.shape}: max_abs_err {err:.3g} ({tol}{extra}); "
              f"two runs bit-equal; {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), library "
              f"{'%.4f ms (%s)' % (lib_ms, case.library[0]) if case.library else 'none'}",
              flush=True)
        src, replaces = SOURCES[name]
        records[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        }
    missing = set(SOURCES) - set(records)
    if missing:
        raise AssertionError(f"no operands for {sorted(missing)}")
    _build.LAUNCHES.reset()
    return records


# --------------------------------------------------------------------------
# checks of answers and sketches against the host backend
# --------------------------------------------------------------------------
def check_answers(host, dev_answers) -> float:
    """Group keys and counts bit-equal; every f32 sum within SUM_RTOL of the
    largest |host| value of its component (f32 sums of up to R rows, each
    warp folding R/8 of them serially: the rounding bound is about
    (R/8)·2^-24 ≈ 1.2e-4 of the summed magnitude at R = 16384)."""
    import numpy as np

    worst = 0.0
    for h, d in zip(host, dev_answers):
        np.testing.assert_array_equal(h.group_keys, d.group_keys)
        np.testing.assert_array_equal(h.raw[:, :, 0], d.raw[:, :, 0])
        if h.raw.size:
            scale = np.maximum(np.abs(h.raw).max(axis=(0, 1)), 1e-30)
            rel = float((np.abs(d.raw - h.raw).max(axis=(0, 1)) / scale).max())
            if rel > SUM_RTOL:
                raise AssertionError(f"sum error {rel:.3g} of scale > {SUM_RTOL}")
            worst = max(worst, rel)
    return worst


def check_sketches(table, sk, names):
    """The device sketches of ``names`` against a host build of those
    columns: counts, heavy hitters, AKMV, bitmaps bit-equal; measures
    at rtol 2e-4 (f32 moments)."""
    import numpy as np

    from repro_torch.backends import ExecOptions
    from repro_torch.core.sketches import build_sketches
    from repro_torch.data.table import Table

    sub = Table(tuple(table.spec(n) for n in names), {n: table.columns[n] for n in names},
                name=table.name)
    host = build_sketches(sub, options=ExecOptions(backend="host"))
    for n in names:
        h, d = host.columns[n], sk.columns[n]
        np.testing.assert_allclose(d.measures, h.measures, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(d.ndv, h.ndv)
        np.testing.assert_array_equal(d.dv_freq, h.dv_freq)
        np.testing.assert_array_equal(d.hh_stats, h.hh_stats)
        assert d.hh_items == h.hh_items
        for f in ("cat_counts", "hist_edges", "bitmap", "global_hh"):
            if getattr(h, f) is not None:
                np.testing.assert_array_equal(getattr(d, f), getattr(h, f))


def uniform_errors(answers, num_partitions: int, seed: int) -> list[dict]:
    """`error_metrics` of a 5% uniform partition sample, per query."""
    import numpy as np

    from repro_torch.queries.engine import error_metrics

    rng = np.random.default_rng(seed)
    n = max(1, num_partitions // 20)
    rows = []
    for ans in answers:
        ids = np.sort(rng.choice(num_partitions, size=n, replace=False))
        est = ans.estimate(ids, np.full(n, num_partitions / n))
        rows.append(error_metrics(ans.truth(), est))
    return rows


def mean_metrics(rows: list[dict]) -> dict:
    import numpy as np

    return {k: float(np.mean([m[k] for m in rows])) for k in rows[0]}


def planned_errors(planned, truth_answers) -> list[dict]:
    """`error_metrics` of each planned answer against its exact answer: the
    estimate aligned to the true groups, a group it missed counting 1."""
    import numpy as np

    from repro_torch.queries.engine import error_metrics

    rows = []
    for ans, truth in zip(planned, truth_answers):
        est = np.full((truth.group_keys.size, truth.num_aggregates), np.nan)
        at = {int(k): i for i, k in enumerate(ans.group_keys)}
        for gi, key in enumerate(truth.group_keys):
            if int(key) in at:
                est[gi] = ans.estimate[at[int(key)]]
        rows.append(error_metrics(truth.truth(), est))
    return rows


# --------------------------------------------------------------------------
# the profile of a path
# --------------------------------------------------------------------------
LABELS = ("sketches", "ingest", "eval", "picker", "funnel", "featsel", "planner", "answers")


def print_profile(prof, wall_s: float) -> None:
    """The path's phases (host wall inside each ``record_function`` label
    of the port) and the device's busy time: the union of its kernel and
    copy intervals, by name, from one `torch.profiler` trace of the run.
    Reads the raw trace events: the Session path records millions, too
    many to build the profiler's per-event Python objects for."""
    from torch.autograd import DeviceType

    phases, spans, by_name = {}, [], {}
    for e in prof.profiler.kineto_results.events():
        user = e.is_user_annotation()
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            if user or name.split(".")[0] in LABELS:
                continue  # the labels' device-side ranges
            start, dur = e.start_ns(), e.duration_ns()
            spans.append((start, start + dur))
            tot, n = by_name.get(name, (0, 0))
            by_name[name] = (tot + dur, n + 1)
        elif user and e.name().split(".")[0] in LABELS:
            tot, n = phases.get(e.name(), (0, 0))
            phases[e.name()] = (tot + e.duration_ns(), n + 1)
    for name, (tot, n) in sorted(phases.items(), key=lambda kv: -kv[1][0]):
        print(f"[phase] {name}: {tot / 1e6:.1f} ms host wall over {n} call(s)", flush=True)
    busy_ns, end = 0, float("-inf")
    for lo, hi in sorted(spans):  # union of device intervals
        if hi > end:
            busy_ns += hi - max(lo, end)
            end = hi
    wall_ms = wall_s * 1e3
    print(f"[device] busy {busy_ns / 1e6:.1f} ms of {wall_ms:.1f} ms path wall "
          f"(idle share {1 - busy_ns / 1e6 / wall_ms:.4f}); {len(spans)} device events",
          flush=True)
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[device] {tot / 1e6:9.2f} ms x{n:<7} {name[:90]}", flush=True)


def launches_of(names) -> dict:
    """Launch counts since the last reset; raises if a kernel of the path
    never launched."""
    from repro_torch.kernels import _build

    launches = {k[0]: n for k, n in _build.LAUNCHES.counts().items()}
    idle = [n for n in names if launches.get(n, 0) == 0]
    if idle:
        raise AssertionError(f"the path never launched {idle}")
    return launches


def profiler():
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


# --------------------------------------------------------------------------
# phase 4: the offline plane (slice 1's path)
# --------------------------------------------------------------------------
def offline_path(full, queries, args) -> None:
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.core.sketches import build_sketches
    from repro_torch.data.table import Table
    from repro_torch.kernels import _build
    from repro_torch.queries.engine import EvalCache, per_partition_answers_batch

    p = min(args.offline_partitions, full.num_partitions)
    table = Table(full.schema, {k: v[:p] for k, v in full.columns.items()}, name=full.name)
    opts = ExecOptions()
    _build.LAUNCHES.reset()
    with profiler() as prof:
        t = time.perf_counter()
        sk = build_sketches(table, options=opts)
        torch.cuda.synchronize()
        t_sketch = time.perf_counter() - t
        t = time.perf_counter()
        cache = EvalCache(table, options=opts)
        answers = per_partition_answers_batch(table, queries, cache=cache, options=opts)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t
    launches = launches_of(OFFLINE_KERNELS)
    print(f"[offline] {p}x{table.rows_per_partition}: build_sketches {t_sketch:.2f} s, "
          f"per_partition_answers_batch {t_eval:.2f} s ({len(queries)} queries, cold); "
          f"launches {json.dumps(launches, sort_keys=True)}", flush=True)
    print_profile(prof, t_sketch + t_eval)

    t = time.perf_counter()
    per_partition_answers_batch(table, queries, cache=cache, options=opts)
    torch.cuda.synchronize()
    print(f"[offline] warm per_partition_answers_batch {time.perf_counter() - t:.2f} s",
          flush=True)

    t = time.perf_counter()
    host = per_partition_answers_batch(table, queries[:4], options=opts.replace(backend="host"))
    worst = check_answers(host, answers[:4])
    check_sketches(table, sk, ("l_extendedprice", "l_partkey"))
    print(f"[check] offline plane, 4 queries vs host backend: keys and counts bit-equal, "
          f"worst sum error {worst:.3g} of scale (limit {SUM_RTOL}); 2 columns of sketches "
          f"vs host match; {time.perf_counter() - t:.2f} s", flush=True)
    if not all(np.isfinite(ans.raw).all() for ans in answers):
        raise AssertionError("non-finite per-partition answer")


# --------------------------------------------------------------------------
# phase 5: the Session path
# --------------------------------------------------------------------------
def session_path(table, args) -> tuple:
    """Session(table) + prepare + execute on held-out queries → (session,
    launches, per-query execute seconds, planned answers, held-out queries)."""
    import torch

    from repro_torch.api import QuerySpec, Session
    from repro_torch.core.picker import PickerConfig
    from repro_torch.kernels import _build
    from repro_torch.queries.generator import WorkloadSpec

    held_out = WorkloadSpec(table, seed=args.seed + 1).sample_workload(args.held_out)
    _build.LAUNCHES.reset()
    with profiler() as prof:
        t0 = time.perf_counter()
        sess = Session(table)
        torch.cuda.synchronize()
        t_store = time.perf_counter() - t0
        sess.prepare(WorkloadSpec(table, seed=args.seed), num_train_queries=args.queries,
                     picker_config=PickerConfig(seed=args.seed))
        torch.cuda.synchronize()
        t_prepare = time.perf_counter() - t0
        planned, walls = [], []
        for q in held_out:
            t = time.perf_counter()
            planned.append(sess.execute(QuerySpec(q, error_bound=ERROR_BOUND)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        t_path = time.perf_counter() - t0
    launches = launches_of(SOURCES)
    print(f"[main] Session(table) {t_store:.2f} s (sketch store), Session(table) + prepare "
          f"{t_prepare:.2f} s ({args.queries} training queries), {len(held_out)} executes "
          f"{sum(walls):.2f} s; launches {json.dumps(launches, sort_keys=True)}", flush=True)
    print_profile(prof, t_path)
    return sess, launches, walls, planned, held_out


def check_forest(sess, table, args) -> None:
    """Phase 6: the first trees of funnel model 0, fitted again from the
    training features on the card and on the host; bit-equal to each other
    and to the trained forest's first trees."""
    import numpy as np

    from repro_torch.backends import ExecOptions
    from repro_torch.core.funnel import make_labels
    from repro_torch.core.gbdt import fit_gbdt
    from repro_torch.queries.engine import per_partition_answers_batch
    from repro_torch.queries.generator import WorkloadSpec

    t = time.perf_counter()
    queries = WorkloadSpec(table, seed=args.seed).sample_workload(args.queries)
    fb, funnel = sess.picker.fb, sess.picker.funnel
    answers = per_partition_answers_batch(table, queries, cache=sess.answers._eval_cache,
                                          options=sess.options)
    x = np.concatenate([fb.features(q) for q in queries], axis=0)
    y = np.concatenate([make_labels(a.contribution(), funnel.thresholds[0])[0] for a in answers])
    binner = funnel.forests[0].binner
    codes = binner.transform(x)
    kw = dict(num_trees=FOREST_CHECK_TREES, depth=sess.picker.config.tree_depth, binner=binner,
              seed=sess.picker.config.seed, rowsample=0.5, colsample=0.7, codes=codes)
    t_fit = time.perf_counter()
    dev = fit_gbdt(x, y, options=ExecOptions(), **kw)
    t_dev = time.perf_counter() - t_fit
    t_fit = time.perf_counter()
    host = fit_gbdt(x, y, options=ExecOptions(backend="host"), **kw)
    t_host = time.perf_counter() - t_fit
    trained = funnel.forests[0]
    for a, b, what in ((dev, host, "host fit"),
                       (dev, trained, "trained model 0")):
        np.testing.assert_array_equal(a.feat, b.feat[:FOREST_CHECK_TREES], err_msg=what)
        np.testing.assert_array_equal(a.thr, b.thr[:FOREST_CHECK_TREES], err_msg=what)
        np.testing.assert_array_equal(a.leaf.view(np.uint32),
                                      b.leaf[:FOREST_CHECK_TREES].view(np.uint32), err_msg=what)
    print(f"[check] forest: the first {FOREST_CHECK_TREES} trees of funnel model 0 on "
          f"{x.shape[0]}x{x.shape[1]} codes, device fit {t_dev:.2f} s vs host fit {t_host:.2f} s: "
          f"bit-equal, and equal to the trained model's; {time.perf_counter() - t:.2f} s",
          flush=True)


def report_answers(sess, table, planned, walls, held_out, args) -> None:
    """Held-out answers against the exact ones: coverage (the share within
    the error bound) and errors, beside a 5%-uniform partition sample."""
    import numpy as np

    from repro_torch.queries.engine import per_partition_answers_batch

    t = time.perf_counter()
    truth = per_partition_answers_batch(table, held_out, cache=sess.answers._eval_cache,
                                        options=sess.options)
    errs = planned_errors(planned, truth)
    uni = uniform_errors(truth, table.num_partitions, args.seed)
    read = np.array([a.partitions_read for a in planned], np.float64)
    rel = np.array([m["avg_rel_err"] for m in errs])
    uni_rel = np.array([m["avg_rel_err"] for m in uni])
    if not all(np.isfinite(a.raw).all() for a in truth):
        raise AssertionError("non-finite exact answer")
    if not all(np.isfinite(np.nan_to_num(a.estimate, nan=0.0)).all() for a in planned):
        raise AssertionError("non-finite planned estimate")
    print(f"[answer] Session.execute at error_bound {ERROR_BOUND}, {len(planned)} held-out "
          f"queries: execute p50 {np.median(walls):.3f} s max {max(walls):.3f} s; partitions "
          f"read mean {read.mean():.1f} of {table.num_partitions} (min {read.min():.0f}, max "
          f"{read.max():.0f}); coverage {float((rel <= ERROR_BOUND).mean()):.4f}; mean "
          f"avg_rel_err {rel.mean():.4f}; metrics {json.dumps(mean_metrics(errs), sort_keys=True)}"
          f" (exact answers in {time.perf_counter() - t:.2f} s)", flush=True)
    print(f"[answer] 5% uniform sample ({max(1, table.num_partitions // 20)} partitions), same "
          f"queries: coverage {float((uni_rel <= ERROR_BOUND).mean()):.4f}; mean avg_rel_err "
          f"{uni_rel.mean():.4f}; metrics {json.dumps(mean_metrics(uni), sort_keys=True)}",
          flush=True)
    stats = {k: v for k, v in sess.stats().items() if k != "read_rate_emas"}
    print(f"[answer] session stats {json.dumps(stats, sort_keys=True)}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.data.datasets import make_dataset
    from repro_torch.core.features import build_feature_schema
    from repro_torch.kernels import _build
    from repro_torch.queries.generator import WorkloadSpec

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: IEEE f32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    full = dict(partitions=1024, rows=16384, queries=48, held_out=16)
    cuts = {k: getattr(args, k) for k, v in full.items() if getattr(args, k) != v}
    if cuts:
        print(f"[reduced] {json.dumps(cuts)} (full size: 1024 partitions x 16384 rows, "
              "48 training and 16 held-out queries)", flush=True)
    print(f"[reduced] the offline plane runs on the first {args.offline_partitions} "
          f"partitions; the Session path drives its kernels at full size", flush=True)

    t = time.perf_counter()
    logs = _build.build_all()
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    t = time.perf_counter()
    table = make_dataset("tpch", num_partitions=args.partitions,
                         rows_per_partition=args.rows, seed=args.seed)
    queries = WorkloadSpec(table, seed=args.seed).sample_workload(args.queries)
    n_feat = build_feature_schema(table).dim
    print(f"[data] tpch {table.num_partitions}x{table.rows_per_partition} "
          f"({len(table.schema)} columns), {len(queries)} queries, feature dim {n_feat}, "
          f"in {time.perf_counter() - t:.2f} s", flush=True)

    records = run_kernel_phase(
        kernel_cases(table, queries, dev)
        + picker_cases(args.queries * table.num_partitions, n_feat, table.num_partitions,
                       dev, args.seed))

    offline_path(table, queries, args)

    sess, launches, walls, planned, held_out = session_path(table, args)
    for name, rec in records.items():
        rec["launches"] = launches.get(name, 0)
    report_answers(sess, table, planned, walls, held_out, args)

    check_forest(sess, table, args)

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
