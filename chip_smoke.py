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
   within the tolerance printed beside them; with the kernel's time (a
   replay of a CUDA graph of its calls: the card's time, beside the older
   reading from events around a Python loop, the host's dispatch where
   that is longer), the plain version's and that of a PyTorch library
   call computing the same function (a yardstick the port never calls;
   from a graph where it can be captured), each the median of ``ROUNDS``
   timed rounds with their min and max, and the least time the card could
   take; then further shapes of the path (pdist_sq at each of feature
   selection's center buckets, fused_eval at a planner chunk read) and
   cases that stress the designs (sparse masks, a radix of 4 and the
   widest radix bucket, the first 16 stack rows alone against the full
   launch, level-0 and leaf-sum GBDT histograms), checked and timed (their
   plain versions untimed), listed under their kernel's ``cases``; and
   whether ``torch.cumsum`` gives cumsum_seq's bits;
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
   and on the host: the forests must be bit-equal; and tree_hist on
   those binned training codes at level 0 and at the leaf sums of the
   trained first tree, against its plain version;
7. the streaming append path on the same prepared Session: the training
   answers cached, a warm-up append that overflows the device stack's
   partition bucket, then six appends of ``--partitions`` / 64 partitions
   each folded into the sketches and every cached answer (profiled),
   held-out executes on the grown table, ``predicate_mask_device`` against
   the host mask for every held-out query, and a cold rebuild of sketches
   and answers that the folded ones must equal bit for bit;
8. the ``kernels`` JSON line, then ``{"ok": true, ...}`` as the last line.
   Each kernel's ``session_launches`` and ``stream_launches`` count its
   launches in the Session path and in the streaming path, and
   ``launches`` is their sum.

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
    "group_aggregate": ("src/repro_torch/csrc/groupagg.cu", "src/repro/kernels/groupagg.py:63"),
    "moments": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/moments.py:72"),
    "histogram_range": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/histogram.py:60"),
    "bincount": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/histogram.py:96"),
    "tree_hist": ("src/repro_torch/csrc/tree_hist.cu", "src/repro/kernels/tree_hist.py:78"),
    # the reference's prefix sum is an XLA loop, not a Pallas kernel
    "cumsum_seq": ("src/repro_torch/csrc/tree_hist.cu", "src/repro/core/gbdt.py:321"),
    "pdist_sq": ("src/repro_torch/csrc/pdist.cu", "src/repro/kernels/pdist.py:53"),
    "predicate_eval": ("src/repro_torch/csrc/predicate.cu", "src/repro/kernels/predicate.py:79"),
}
OFFLINE_KERNELS = ("fused_eval", "group_aggregate", "moments", "histogram_range", "bincount")
SESSION_KERNELS = tuple(k for k in SOURCES if k != "predicate_eval")
STREAM_KERNELS = ("fused_eval", "moments", "histogram_range", "bincount", "predicate_eval")
APPENDS = 6  # timed appends of the streaming phase, after the warm-up one
ROUNDS = 5  # timed rounds of every kernel case; the median is recorded


def append_size(partitions: int) -> int:
    """Partitions per append: 16 at the full 1024.  The warm-up append
    then crosses a power-of-two stack bucket and the ``APPENDS`` after it
    stay inside the next one."""
    return max(1, partitions // 64)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--partitions", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--queries", type=int, default=48)
    ap.add_argument("--held-out", type=int, default=16)
    ap.add_argument("--offline-partitions", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def graph_ms(fn, iters: int, rounds: int = ROUNDS) -> tuple[float, float, float]:
    """Device time of ``fn``: ``iters`` calls captured in one CUDA graph
    (after a warm-up call on a side stream, as capture asks), the graph
    replayed once a round between CUDA events → (median, min, max) over
    ``rounds`` rounds of the time a call.  The replay launches the kernels
    back to back with no host work between them, so a kernel shorter than
    the host's dispatch of one call is timed on the card, not on the host."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times), min(times), max(times)


def library_ms(fn, iters: int) -> tuple[tuple[float, float, float], str]:
    """A library call's time and how it was taken: from a CUDA graph like
    the kernels, or, where the call cannot be captured (it reads a result
    back on the host, as ``torch.bincount`` does to size its output), from
    CUDA events around a loop of calls, host dispatch included."""
    try:
        return graph_ms(fn, iters), "graph"
    except RuntimeError:
        import torch

        torch.cuda.synchronize()
        return cuda_ms(fn, iters), "events"


def cuda_ms(fn, iters: int, rounds: int = ROUNDS) -> tuple[float, float, float]:
    """Time of ``fn`` from CUDA events around a loop of ``iters`` calls
    from Python, after one warm-up call: the mean over the ``iters`` calls
    in each of ``rounds`` rounds → (median, min, max) of the rounds.  The
    host dispatches each call while the card runs the last, so where a
    call's kernels take less time than its dispatch this measures the
    host's dispatch per call."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times), min(times), max(times)


def spread(t: tuple[float, float, float]) -> str:
    return f"{t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f})"


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
    record: bool = True  # False: a second case of a kernel, checked and printed only
    check: object = None  # (output) -> note; raises if a further contract fails


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at main-path shapes
# --------------------------------------------------------------------------
def group_aggregate_case(values, mask, codes, radix, shape, record=True, check=None) -> Case:
    """group_aggregate on these operands.  Bytes: the mask of every row,
    values and code of the rows that pass, the output; ops: a test a row,
    V adds a passing row.  Library: ``index_add_`` of the passing rows."""
    import torch

    from repro_torch.kernels import groupagg

    keep = (mask != 0) & (codes >= 0) & (codes < radix)
    b, v, _ = values.shape
    passing = int(keep.sum())
    nbytes = mask.numel() * 4 + passing * (v + 1) * 4 + b * v * radix * 4
    ops = mask.numel() + passing * v
    rows = keep.nonzero(as_tuple=True)
    flat = ((rows[0][:, None] * v + torch.arange(v, device=values.device)) * radix
            + codes[rows][:, None].long()).view(-1)
    vals = (values * mask[:, None, :]).transpose(1, 2)[rows].reshape(-1)
    acc = torch.zeros(b * v * radix, device=values.device)
    return Case("group_aggregate", groupagg.group_aggregate, groupagg.group_aggregate_plain,
                (values, mask, codes, radix), "sums", nbytes, ops,
                ("torch.Tensor.index_add_", lambda: acc.index_add_(0, flat, vals)), shape,
                record, check)


def group_aggregate_stress(values, mask, codes, radix, seed: int) -> list[Case]:
    """The eval chunk with a 5% mask, with its codes folded to a radix
    of 4, with seeded codes over the widest radix bucket the census can
    give (``MAX_GROUPS``: one block of three warps an SM), and its first
    16 stack rows alone, which must give the bits the full launch gives
    them (the streaming path's delta == cold)."""
    import torch

    from repro_torch.kernels import groupagg
    from repro_torch.queries.device import _radix_bucket
    from repro_torch.queries.engine import MAX_GROUPS

    b, v, r = values.shape
    gen = torch.Generator().manual_seed(seed)
    sparse = (torch.rand((b, r), generator=gen) < 0.05).to(torch.float32).to(values.device)
    codes4 = torch.where(codes >= 0, codes % 4, codes)
    wide = _radix_bucket(MAX_GROUPS)
    codes_wide = torch.where(
        codes >= 0, torch.randint(0, wide, (b, r), generator=gen, dtype=torch.int32)
        .to(codes.device), codes)
    full = groupagg.group_aggregate(values, mask, codes, radix)
    head = [t[:16] for t in (values, mask, codes)]

    def same_as_full(out):
        if not torch.equal(out.view(torch.int32), full[:16].view(torch.int32)):
            raise AssertionError("group_aggregate: 16 stack rows alone differ from the full launch")
        return "16 rows alone bit-equal to the full launch"

    shape = f"{b}x{v}x{r}"
    return [
        group_aggregate_case(values, sparse, codes, radix, f"{shape}, radix {radix}, 5% mask",
                             record=False),
        group_aggregate_case(values, mask, codes4, 4, f"{shape}, codes mod 4, radix 4",
                             record=False),
        group_aggregate_case(values, mask, codes_wide, wide,
                             f"{shape}, seeded codes, radix {wide}", record=False),
        group_aggregate_case(*head, radix, f"16x{v}x{r}, radix {radix}, first 16 stack rows",
                             record=False, check=same_as_full),
    ]


def fused_eval_case(args, shape, record=True) -> Case:
    """fused_eval on these operands.  Bytes: clause columns and descriptors
    for every row, values and codes only for the rows that pass; ops: two
    compares a clause, V adds a pass."""
    from repro_torch.kernels import fused

    xs, lo, hi, gmap, values, codes, radix = args
    keep = fused.predicate_rows(xs, lo, hi, gmap) & (codes >= 0) & (codes < radix)
    b, v, _ = values.shape
    passing = int(keep.sum())
    nbytes = (sum(t.numel() * 4 for t in (xs, lo, hi, gmap)) + passing * (v + 1) * 4
              + b * v * radix * 4)
    return Case("fused_eval", fused.fused_eval, fused.fused_eval_plain, args, "sums", nbytes,
                2 * xs.numel() + passing * v, None, shape, record)


def chunk_read_case(table, held_out, dev) -> Case:
    """fused_eval as the planner's chunk reads launch it: the first held-out
    query with a predicate the kernel takes, on a 16-partition subset table
    of its own (`AnswerStore.get_subset`), so B = 16 stack rows."""
    import numpy as np

    from repro_torch.backends import ExecOptions
    from repro_torch.data.table import Table
    from repro_torch.planner.planner import PlannerConfig
    from repro_torch.queries import device
    from repro_torch.queries.engine import EvalCache

    ids = np.arange(PlannerConfig().chunk)
    view = Table(table.schema, {k: v[ids] for k, v in table.columns.items()},
                 name=f"{table.name}/subset")
    cache = EvalCache(view, options=ExecOptions(device=str(dev)))
    for q in held_out:
        chunks, _ = device.plan_launches(view, [q], cache)
        if chunks and chunks[0][0][1].sig.has_predicate:
            _, args = device.kernel_call([pl for _, pl in chunks[0]], cache)
            shape = ("x".join(str(s) for s in args[0].shape)
                     + f", radix {args[-1]}, a planner chunk read")
            return fused_eval_case(args, shape, record=False)
    raise AssertionError("no held-out query reads through fused_eval")


def kernel_cases(table, queries, held_out, dev) -> list[Case]:
    """The offline plane's kernels with the operands the main path hands
    them: one numeric and one categorical column of the table, and the
    first stacked chunk of each eval kernel in the workload's launch order
    (and fused_eval at a planner chunk read of a held-out query);
    predicate_eval on the clauses of the workload query with the most of
    them, with the shared (C, G) map that `predicate_mask_device` passes
    and again with per-partition bounds and a (P, C, G) map."""
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.kernels import histogram, moments, predicate
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
    for chunk in picked.values():
        name, args = device.kernel_call([pl for _, pl in chunk], cache)
        radix = args[-1]
        shape = "x".join(str(s) for s in args[0].shape) + f", radix {radix}"
        if name == "group_aggregate":
            values, mask, codes_c, _ = args
            cases.append(group_aggregate_case(values, mask, codes_c, radix, shape))
            cases += group_aggregate_stress(values, mask, codes_c, radix, seed=len(cases))
            continue
        cases.append(fused_eval_case(args, shape))
        cases.append(chunk_read_case(table, held_out, dev))

    canon = max((device.canonicalize_predicate(table, q.predicate, cache) for q in queries),
                key=lambda c: -1 if c is None else len(c.cols))
    cols, lo, hi, gmap, ng = device.predicate_call(canon, cache)
    c = cols.shape[1]
    for per_partition in (False, True):
        if per_partition:  # the stacked-query form: bounds and map per partition row
            lo, hi = lo.expand(p, c).contiguous(), hi.expand(p, c).contiguous()
            gmap = gmap.expand(p, c, ng).contiguous()
        # bytes: every clause column and descriptor read once, the mask and
        # the count written once; ops: two compares a clause, one test a group
        nbytes = sum(t.numel() * 4 for t in (cols, lo, hi, gmap)) + p * r * 4 + p * 4
        cases.append(Case(
            "predicate_eval", predicate.predicate_eval,
            lambda *a: predicate.predicate_eval_plain(*a[:4]),
            (cols, lo, hi, gmap, ng), "bits", nbytes, 2 * cols.numel() + p * r * ng, None,
            f"{p}x{c}x{r}, {ng} OR-groups of {len(canon.cols)} clauses, "
            + ("per-partition bounds, (P, C, G) map" if per_partition else "(C, G) map"),
            record=not per_partition))
    return cases


def tree_hist_case(codes_t, fids, node, g, h, nodes, n_feat, bins, shape,
                   record=True) -> Case:
    """tree_hist on (C, R) column-major codes.  Bytes: codes, node, g, h,
    feature ids and the output once; ops: G and H adds of each live (row,
    column).  Library: ``index_put_(accumulate=True)`` of the same adds."""
    import torch

    from repro_torch.kernels import tree_hist

    c, r = codes_t.shape
    live = node >= 0
    out_elems = 2 * nodes * n_feat * bins
    seg = ((node.long()[None, :] * n_feat + fids.long()[:, None]) * bins
           + codes_t.long())[:, live].T.reshape(-1)  # row-major (row, column)
    src = torch.stack([g[live], h[live]], 1).repeat_interleave(c, 0)
    acc = torch.zeros((nodes * n_feat * bins, 2), device=codes_t.device)
    return Case(
        "tree_hist", tree_hist.tree_hist, tree_hist.tree_hist_plain,
        (codes_t.T, fids, node, g, h, nodes, n_feat, bins), "bits",
        (c * r + 3 * r + c) * 4 + out_elems * 4, 2 * int(live.sum()) * c,
        ("torch.Tensor.index_put_(accumulate=True)",
         lambda: acc.index_put_((seg,), src, accumulate=True)), shape, record)


def picker_cases(n_rows: int, n_feat: int, n_partitions: int, dev, seed: int) -> list[Case]:
    """The picker's kernels at the Session path's shapes, from seeded data:
    one GBDT level (the funnel fit's rows, sampled features and 16 nodes)
    and the prefix sums of its histograms; one KMeans assignment of feature
    selection (every partition against its largest cluster bucket, then
    against the two other buckets, not recorded).  Not recorded: tree_hist
    at level 0 (every row in node 0) with one near-constant column, and at
    the leaf-sum shape (1 column, 32 nodes, 1 bin)."""
    import numpy as np
    import torch

    from repro_torch.core.clustering import bucket_size
    from repro_torch.core.featsel import DEFAULT_BUDGET_FRACS
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
    cases.append(tree_hist_case(codes_t, fids, node, g, h, nodes, n_feat, NUM_BINS,
                                f"{r}x{c}, {nodes} nodes, {n_feat} features"))
    hist = tree_hist.tree_hist(*cases[-1].args)
    out_elems = hist.numel()

    def same_as_cumsum(out):  # is torch.cumsum the same function, bit for bit?
        same = torch.equal(out.view(torch.int32), torch.cumsum(hist, dim=-1).view(torch.int32))
        return f"torch.cumsum {'bit-equal' if same else 'NOT bit-equal'} to cumsum_seq"

    cases.append(Case("cumsum_seq", tree_hist.cumsum_seq, tree_hist.cumsum_seq_plain, (hist,),
                      "bits", 2 * out_elems * 4, out_elems,
                      ("torch.cumsum", lambda: torch.cumsum(hist, dim=-1)),
                      "x".join(str(s) for s in hist.shape), check=same_as_cumsum))
    # level 0: every live row in node 0, column 0 near-constant (97% of the
    # rows in one bin, so one segment holds most rows)
    codes0 = codes_t.clone()
    codes0[0, torch.from_numpy(rng.random(r) < 0.97).to(dev)] = 17
    node0 = torch.where(node >= 0, 0, -1).to(torch.int32)
    cases.append(tree_hist_case(codes0, fids, node0, g, h, nodes, n_feat, NUM_BINS,
                                f"{r}x{c}, level 0 (node 0), column 0 near-constant",
                                record=False))
    # the leaf sums of one tree: 1 column of 1 bin over 2^depth = 32 nodes
    leaf = np.full(r, -1, np.int32)
    leaf[:nt] = rng.integers(0, 32, size=nt)
    cases.append(tree_hist_case(torch.zeros((1, r), dtype=torch.int32, device=dev),
                                torch.zeros(1, dtype=torch.int32, device=dev),
                                torch.from_numpy(leaf).to(dev), g, h, 32, 1, 1,
                                f"{r}x1, 32 nodes, 1 bin (leaf sums)", record=False))
    # pdist_sq: feature selection clusters every partition (a power-of-two
    # row bucket) into each budget's center bucket; recorded at the largest
    # (20% of the partitions), then the two others (a third of the
    # launches each)
    n = bucket_size(n_partitions)
    x = torch.from_numpy(rng.normal(size=(n, n_feat)).astype(np.float32)).to(dev)
    for frac in sorted(DEFAULT_BUDGET_FRACS, reverse=True):
        k = bucket_size(int(frac * n_partitions))
        cent = torch.from_numpy(rng.normal(size=(k, n_feat)).astype(np.float32)).to(dev)
        cases.append(Case(
            "pdist_sq", pdist.pdist_sq, pdist.pdist_sq_plain, (x, cent), (1e-4, 1e-3),
            (n * n_feat + k * n_feat + n * k) * 4, 2 * n * k * n_feat + 2 * (n + k) * n_feat,
            ("torch.cdist(x, c) ** 2", lambda c=cent: torch.cdist(x, c) ** 2),
            f"{n}x{n_feat} by {k}x{n_feat}", record=frac == max(DEFAULT_BUDGET_FRACS)))
    return cases


def session_tree_hist_cases(codes, forest, seed: int) -> list[Case]:
    """tree_hist on the funnel's own binned training codes, as the device
    fit launches it: rowsample 0.5 of the rows padded to a power of two;
    at level 0 (colsample 0.7 of the features, 16 node slots, every
    sampled row in node 0) and at the leaf sums (the rows' leaves under
    the trained forest's first tree: 1 column, 2^depth nodes, 1 bin)."""
    import numpy as np
    import torch

    from repro_torch.core.clustering import bucket_size
    from repro_torch.core.gbdt import NUM_BINS

    rng = np.random.default_rng(seed)
    n, n_feat = codes.shape
    nt = min(n, max(32, int(0.5 * n)))
    r = bucket_size(nt)
    rows = np.sort(rng.choice(n, size=nt, replace=False))
    fs = np.sort(rng.choice(n_feat, size=max(1, int(0.7 * n_feat)), replace=False))
    sub = np.zeros((fs.size, r), np.int32)
    sub[:, :nt] = codes[rows][:, fs].T
    node = np.full(r, -1, np.int32)
    node[:nt] = 0
    leaf = np.full(r, -1, np.int32)
    idx = np.zeros(nt, np.int64)  # internal node of each sampled row, then its leaf
    for _ in range(forest.depth):
        go_right = codes[rows, forest.feat[0, idx]] > forest.thr[0, idx]
        idx = 2 * idx + 1 + go_right
    leaf[:nt] = idx - (2**forest.depth - 1)
    g = rng.normal(size=r).astype(np.float32)
    h = (rng.random(r) + 0.5).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")

    g, h = dev(g), dev(h)
    return [
        tree_hist_case(dev(sub), dev(fs.astype(np.int32)), dev(node), g, h, 16, n_feat,
                       NUM_BINS, f"{r}x{fs.size}, level 0 on the Session's binned training "
                       "codes", record=False),
        tree_hist_case(torch.zeros((1, r), dtype=torch.int32, device="cuda"),
                       torch.zeros(1, dtype=torch.int32, device="cuda"), dev(leaf), g, h,
                       2**forest.depth, 1, 1, f"{r}x1, {2**forest.depth} nodes, 1 bin: the "
                       "leaf sums of the Session's first tree", record=False),
    ]


def parts(out) -> tuple:
    """A kernel's outputs as a tuple of tensors."""
    return out if isinstance(out, tuple) else (out,)


def compare(got, want, tol) -> float:
    """Max abs error; raises unless bit-equal ("bits"), counts bit-equal and
    sums allclose(1e-5, 1e-4) ("sums"), allclose(2e-5, 2e-4) ("close":
    moments), or allclose at an explicit (rtol, atol).  Kernels with
    several outputs are held output by output."""
    import numpy as np

    if isinstance(got, tuple):
        return max(compare(g, w, tol) for g, w in zip(got, parts(want)))

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


def run_kernel_phase(cases: list[Case], every_kernel: bool = True) -> dict:
    """Phase 3 → {name: record} for the kernels line (launches added later);
    raises if ``every_kernel`` and a kernel of ``SOURCES`` has no case."""
    import torch

    from repro_torch.kernels import _build

    records = {}
    for case in cases:
        name, kernel, plain, args = case.name, case.kernel, case.plain, case.args
        got = kernel(*args)
        again = kernel(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a.nan_to_num(), b.nan_to_num())
                   for a, b in zip(parts(got), parts(again))):
            raise AssertionError(f"{name}: two runs gave different bits")
        err = compare(got, want, case.tol)
        extra = ""
        if name == "pdist_sq":
            if not torch.equal(got.argmin(dim=1), want.argmin(dim=1)):
                raise AssertionError("pdist_sq: nearest centers differ from the plain version")
            extra = "; argmin equal"
        if case.check is not None:
            extra += "; " + case.check(got)
        # the kernel's time from a CUDA graph of 20 calls; beside it the
        # events around a Python loop of 20 calls (host dispatch per call
        # where that is longer than the kernel)
        ms = graph_ms(lambda: kernel(*args), 20)
        dispatch = cuda_ms(lambda: kernel(*args), 20)
        # the plain version's time is recorded only (events: it launches
        # many kernels and some read back); a stress case uses it for the
        # check above
        plain_ms = cuda_ms(lambda: plain(*args), 1) if case.record else None
        lib_ms, lib_how = library_ms(case.library[1], 20) if case.library else (None, None)
        bound_ms, bound_by = bound(case.nbytes, case.ops)
        tol = TOLERANCE_TEXT.get(case.tol, f"rtol {case.tol[0]:g} atol {case.tol[1]:g}"
                                 if isinstance(case.tol, tuple) else case.tol)
        print(f"[kernel] {name} {case.shape}: max_abs_err {err:.3g} ({tol}{extra}); "
              f"two runs bit-equal; medians of {ROUNDS} rounds: {spread(ms)} (graph), "
              f"{spread(dispatch)} (events over a Python loop: host dispatch per call), plain "
              f"{spread(plain_ms) if plain_ms else 'not timed'}, bound {bound_ms:.4f} ms "
              f"({bound_by}), library "
              + (f"{spread(lib_ms)} ({lib_how}; {case.library[0]})" if case.library else "none"),
              flush=True)
        shape_rec = {"shape": case.shape, "ms": ms[0], "ms_events": dispatch[0],
                     "bound_ms": bound_ms, "library_ms": lib_ms[0] if lib_ms else None}
        if not case.record:
            if name in records:
                records[name]["cases"].append(shape_rec)
            continue
        src, replaces = SOURCES[name]
        records[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
            "ms_events": dispatch[0], "plain_ms": plain_ms[0], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms[0] if lib_ms else None,
            "library_timing": lib_how, "shape": case.shape, "cases": [],
        }
        if case.check is not None:
            records[name]["check"] = extra.lstrip("; ")
    missing = set(SOURCES) - set(records)
    if every_kernel and missing:
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
LABELS = ("sketches", "ingest", "eval", "picker", "funnel", "featsel", "planner", "answers",
          "stream")


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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for i, (name, (tot, n)) in enumerate(ranked):
        # the 12 largest, and every kernel of the port's own sources
        if i < 12 or "(anonymous namespace)::" in name:
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
    launches = launches_of(SESSION_KERNELS)
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
    run_kernel_phase(session_tree_hist_cases(codes, trained, args.seed), every_kernel=False)


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


# --------------------------------------------------------------------------
# phase 7: the streaming append path on the prepared Session
# --------------------------------------------------------------------------
SKETCH_FIELDS = ("measures", "hist_edges", "cat_counts", "ndv", "dv_freq", "hh_stats",
                 "hh_items", "global_hh", "bitmap", "discrete_span", "part_spans")


def check_sketches_bits(got, want) -> None:
    """Every field of every column sketch bit-equal."""
    import numpy as np

    assert got.num_partitions == want.num_partitions
    for name, w in want.columns.items():
        g = got.columns[name]
        for field in SKETCH_FIELDS:
            a, b = getattr(g, field), getattr(w, field)
            if isinstance(b, np.ndarray):
                if a.dtype != b.dtype or a.shape != b.shape:
                    raise AssertionError(f"{name}.{field}: {a.dtype}{a.shape} != "
                                         f"{b.dtype}{b.shape}")
                np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                              np.ascontiguousarray(b).view(np.uint8),
                                              err_msg=f"{name}.{field}")
            elif a != b:
                raise AssertionError(f"{name}.{field}: {a!r} != {b!r}")


def check_answers_bits(got, want) -> None:
    import numpy as np

    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.group_keys, w.group_keys)
        np.testing.assert_array_equal(np.ascontiguousarray(g.raw).view(np.uint64),
                                      np.ascontiguousarray(w.raw).view(np.uint64))


def stream_path(sess, train_queries, held_out, args) -> dict:
    """The streaming append path on the prepared Session → its launches.

    The training answers are cached; a warm-up append overflows the device
    stack's partition bucket, and the held-out queries that miss re-pad
    the stack at the next bucket (without a miss it would stay dropped and
    no later append would take the in-slack path).  Then ``APPENDS``
    appends, each folded into the sketches and into every cached answer
    (one delta evaluation), with the launch keys of each; held-out
    executes on the grown table; `predicate_mask_device` for every
    held-out query; and a cold rebuild the folded state must equal."""
    import numpy as np
    import torch

    from repro_torch.api import QuerySpec
    from repro_torch.core import ingest
    from repro_torch.core.sketches import build_sketches
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.table import append_partitions
    from repro_torch.kernels import _build
    from repro_torch.queries import device
    from repro_torch.queries.engine import EvalCache, per_partition_answers_batch, predicate_mask

    table, answers, store = sess.table, sess.answers, sess.sketches
    cache = answers._eval_cache
    everything = list(train_queries) + list(held_out)
    before = dict(incremental=store.incremental_updates, full=store.full_rebuilds,
                  appends=cache.stack_appends)

    def delta(seed):
        return make_dataset("tpch", num_partitions=append_size(args.partitions),
                            rows_per_partition=table.rows_per_partition, layout="random",
                            seed=seed)

    _build.LAUNCHES.reset()
    t = time.perf_counter()
    answers.get_batch(train_queries)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t
    # the fill builds the stack if no earlier phase left one
    rebuilds = cache.stack_rebuilds
    warm, p0 = delta(99), table.num_partitions
    t = time.perf_counter()
    append_partitions(table, warm)
    store.sketches()
    answers.get_batch(everything)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t
    bucket = cache.device_stack().shape[1]
    if cache.stack_rebuilds != rebuilds + 1:
        raise AssertionError("the warm-up append did not re-pad the device stack")
    print(f"[stream] {len(train_queries)} training answers cached in {t_fill:.2f} s; warm-up "
          f"append {p0} -> {table.num_partitions} partitions with its sketch fold and "
          f"{len(everything)} answers ({len(held_out)} misses) in {t_warm:.2f} s; device stack "
          f"re-padded at {bucket} partitions", flush=True)

    deltas = [delta(100 + i) for i in range(APPENDS)]
    walls, keys = [], []
    with profiler() as prof:
        t_window = time.perf_counter()
        for i, d in enumerate(deltas):
            device.TRACES.reset()
            ingest.TRACES.reset()
            t0 = time.perf_counter()
            append_partitions(table, d)
            t1 = time.perf_counter()
            store.sketches()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            got = answers.get_batch(everything)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            walls.append((t1 - t0, t2 - t1, t3 - t2))
            keys.append((frozenset(device.TRACES.counts()), frozenset(ingest.TRACES.counts())))
            print(f"[stream] append {i + 1}: {table.num_partitions} partitions; table append "
                  f"{t1 - t0:.3f} s, sketch fold {t2 - t1:.3f} s, answer refresh {t3 - t2:.3f} s "
                  f"({len(everything)} answers by one delta evaluation)", flush=True)
        t_window = time.perf_counter() - t_window
    print_profile(prof, t_window)
    if any(k != keys[0] for k in keys) or not all(keys[0]):
        raise AssertionError(f"launch keys moved across in-bucket appends: {keys}")
    if cache.stack_appends != before["appends"] + APPENDS:
        raise AssertionError(f"{cache.stack_appends - before['appends']} in-slack stack "
                             f"appends, expected {APPENDS}")
    if cache.device_stack().shape[1] != bucket or any(
            a.raw.shape[0] != table.num_partitions for a in got):
        raise AssertionError("the stack or an answer does not cover the grown table")

    planned, exec_walls = [], []
    for q in held_out:
        t = time.perf_counter()
        planned.append(sess.execute(QuerySpec(q, error_bound=ERROR_BOUND)))
        torch.cuda.synchronize()
        exec_walls.append(time.perf_counter() - t)
    errs = planned_errors(planned, got[len(train_queries):])
    rel = np.array([m["avg_rel_err"] for m in errs])
    read = np.array([a.partitions_read for a in planned], np.float64)
    print(f"[stream] {len(held_out)} executes at error_bound {ERROR_BOUND} on the grown "
          f"{table.num_partitions}-partition table: p50 {np.median(exec_walls):.3f} s; partitions "
          f"read mean {read.mean():.1f}; coverage {float((rel <= ERROR_BOUND).mean()):.4f}; mean "
          f"avg_rel_err {rel.mean():.4f}", flush=True)

    t = time.perf_counter()
    checked = routed = 0
    for q in held_out:
        mask = device.predicate_mask_device(table, q.predicate, cache)
        if mask is None:
            routed += 1
            continue
        np.testing.assert_array_equal(mask, predicate_mask(table, q.predicate))
        checked += 1
    torch.cuda.synchronize()
    print(f"[check] predicate_mask_device on the grown table: {checked} held-out predicates "
          f"bit-equal to the host mask, {routed} routed to the host (None); "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    launches = launches_of(STREAM_KERNELS + (
        ("group_aggregate",) if any(not q.predicate.groups for q in everything) else ()))

    t = time.perf_counter()
    cold_sk = build_sketches(table, options=sess.options)
    torch.cuda.synchronize()
    t_sk = time.perf_counter() - t
    t = time.perf_counter()
    cold = per_partition_answers_batch(table, everything, options=sess.options,
                                       cache=EvalCache(table, options=sess.options))
    torch.cuda.synchronize()
    t_ans = time.perf_counter() - t
    check_sketches_bits(store.sketches(), cold_sk)
    check_answers_bits(got, cold)
    updates = store.incremental_updates - before["incremental"]
    if updates != APPENDS + 1 or store.full_rebuilds != before["full"]:
        raise AssertionError(f"sketch folds {updates}, full rebuilds "
                             f"{store.full_rebuilds - before['full']}")
    fold = np.array([w[1] + w[2] for w in walls])
    print(f"[stream] cold rebuild of the grown table: build_sketches {t_sk:.2f} s + "
          f"{len(everything)} answers {t_ans:.2f} s = {t_sk + t_ans:.2f} s; one append's fold "
          f"(sketches + answers) mean {fold.mean():.3f} s, max {fold.max():.3f} s: "
          f"{(t_sk + t_ans) / fold.mean():.1f}x cheaper than a cold rebuild", flush=True)
    stats = {k: v for k, v in sess.stats().items() if k != "read_rate_emas"}
    print(f"[check] streaming: sketches (every field of {len(cold_sk.columns)} columns) and "
          f"{len(everything)} answers bit-equal to a cold rebuild; sketch folds {updates}, "
          f"in-slack stack appends {cache.stack_appends - before['appends']}, launch keys flat "
          f"over {APPENDS} appends ({len(keys[0][0])} eval, {len(keys[0][1])} ingest); "
          f"launches {json.dumps(launches, sort_keys=True)}; session stats "
          f"{json.dumps(stats, sort_keys=True)}", flush=True)
    return launches


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
              "48 training and 16 held-out queries, 6 appends of 16 partitions)", flush=True)
    print(f"[reduced] the offline plane runs on the first {args.offline_partitions} "
          f"partitions; the Session and streaming paths drive their kernels at full size",
          flush=True)

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

    held_out = WorkloadSpec(table, seed=args.seed + 1).sample_workload(args.held_out)
    records = run_kernel_phase(
        kernel_cases(table, queries, held_out, dev)
        + picker_cases(args.queries * table.num_partitions, n_feat, table.num_partitions,
                       dev, args.seed))

    offline_path(table, queries, args)

    sess, launches, walls, planned, held_out = session_path(table, args)
    report_answers(sess, table, planned, walls, held_out, args)

    check_forest(sess, table, args)

    stream = stream_path(sess, queries, held_out, args)
    for name, rec in records.items():
        rec["session_launches"] = launches.get(name, 0)
        rec["stream_launches"] = stream.get(name, 0)
        rec["launches"] = rec["session_launches"] + rec["stream_launches"]

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
