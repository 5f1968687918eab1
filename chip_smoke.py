#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--partitions 1024] [--rows 16384] [--queries 48] [--seed 0]

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path hands it: counts, histograms and bincounts must
   be bit-equal, f32 sums within the tolerance printed beside them; with
   the kernel's time, the plain version's, the memory bound and the time
   of a PyTorch library call computing the same function (a yardstick the
   port never calls);
4. the main path at full size — ``build_sketches`` on the default options
   (the device backend on CUDA), a seeded 48-query workload and
   ``per_partition_answers_batch`` — with every kernel's launch count
   (each must be > 0), held against the port's own host backend on 4
   queries and 2 columns, and a 5%-uniform-sample ``error_metrics`` as
   the end-to-end answer;
5. the ``kernels`` JSON line, then ``{"ok": true, ...}`` as the last line.

Without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--partitions", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--queries", type=int, default=48)
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


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at main-path shapes
# --------------------------------------------------------------------------
def kernel_cases(table, queries, dev):
    """→ [(name, kernel_fn, plain_fn, args, exact, bytes, ops, library)] with
    the operands the main path hands each kernel: one numeric and one
    categorical column of the table, and the first stacked chunk of each
    eval kernel in the workload's launch order."""
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

    cases.append(("moments", moments.moments, moments.moments_plain, (x,), False,
                  p * r * 4 + p * 8 * 4, p * r * 10,
                  ("torch.aminmax + torch.sum over x and log x", lib_moments)))

    edges = np.quantile(data.astype(np.float64), np.linspace(0, 1, 11), axis=1).T
    e = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(dev)
    nb = e.shape[1] - 1
    offs = torch.arange(p, device=dev)[:, None] * (nb + 2)

    def lib_hist():
        k = torch.searchsorted(e, x, right=True) - 1  # lo <= x < hi
        k = torch.where(x == e[:, -1:], nb - 1, k).clamp_(-1, nb)  # last bucket closed
        return torch.bincount((k + 1 + offs).view(-1), minlength=p * (nb + 2))

    cases.append(("histogram_range", histogram.histogram_range,
                  histogram.histogram_range_plain, (x, e), True,
                  p * r * 4 + p * (2 * nb + 1) * 4, p * r * nb * 3,
                  ("torch.searchsorted + torch.bincount", lib_hist)))

    card = table.spec("l_partkey").cardinality
    codes = torch.from_numpy(np.ascontiguousarray(table.columns["l_partkey"])).to(dev)
    seg = (codes.long() + torch.arange(p, device=dev)[:, None] * card).view(-1)
    cases.append(("bincount", histogram.bincount, histogram.bincount_plain, (codes, card),
                  True, p * r * 4 + p * card * 4, p * r,
                  ("torch.bincount on offset codes",
                   lambda: torch.bincount(seg, minlength=p * card))))

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
        cases.append((name, kernel, plain, args, False, nbytes, ops, library))
    return cases


def compare(got, want, exact: bool) -> float:
    """Max abs error; raises unless bit-equal (exact) or allclose(1e-5, 1e-4)
    on sums with component 0 (counts) bit-equal."""
    import numpy as np

    g, w = got.cpu().numpy(), want.cpu().numpy()
    if exact or g.ndim == 3:
        cnt = (g, w) if exact else (g[:, 0], w[:, 0])
        np.testing.assert_array_equal(*cnt)
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    return float(np.nanmax(np.abs(g - w))) if g.size else 0.0


def run_kernel_phase(table, queries, dev):
    """Phase 3 → {name: record} for the kernels line (launches added later)."""
    from repro_torch.kernels import _build

    sources = {
        "fused_eval": ("src/repro_torch/csrc/eval.cu", "src/repro/kernels/fused.py:84"),
        "group_aggregate": ("src/repro_torch/csrc/eval.cu", "src/repro/kernels/groupagg.py:63"),
        "moments": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/moments.py:72"),
        "histogram_range": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/histogram.py:60"),
        "bincount": ("src/repro_torch/csrc/ingest.cu", "src/repro/kernels/histogram.py:96"),
    }
    records = {}
    for name, kernel, plain, args, exact, nbytes, ops, library in kernel_cases(table, queries, dev):
        got = kernel(*args)
        again = kernel(*args)
        want = plain(*args)
        import torch

        torch.cuda.synchronize()
        if not torch.equal(got.nan_to_num(), again.nan_to_num()):
            raise AssertionError(f"{name}: two runs gave different bits")
        err = compare(got, want, exact)
        ms = cuda_ms(lambda: kernel(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        lib_ms = cuda_ms(library[1], 20) if library else None
        bound_ms, bound_by = bound(nbytes, ops)
        tol = ("bit-equal" if exact else
               "counts bit-equal, sums rtol 1e-5 atol 1e-4 (f32 sums in another order)")
        shape = "x".join(str(s) for s in args[0].shape)
        print(f"[kernel] {name} {shape}: max_abs_err {err:.3g} ({tol}); {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"library {'%.4f ms' % lib_ms if lib_ms is not None else 'none'}"
              f"{' (' + library[0] + ')' if library else ''}", flush=True)
        src, replaces = sources[name]
        records[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        }
    missing = set(sources) - set(records)
    if missing:
        raise AssertionError(f"main path gave no operands for {sorted(missing)}")
    _build.LAUNCHES.reset()
    return records


# --------------------------------------------------------------------------
# phase 4: the main path
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


def sample_error(answers, num_partitions: int, seed: int) -> dict:
    """Mean `error_metrics` of a 5% uniform partition sample, over queries."""
    import numpy as np

    from repro_torch.queries.engine import error_metrics

    rng = np.random.default_rng(seed)
    n = max(1, num_partitions // 20)
    rows = []
    for ans in answers:
        ids = np.sort(rng.choice(num_partitions, size=n, replace=False))
        est = ans.estimate(ids, np.full(n, num_partitions / n))
        rows.append(error_metrics(ans.truth(), est))
    return {k: float(np.mean([m[k] for m in rows])) for k in rows[0]}


LABELS = ("sketches", "ingest", "eval")  # record_function prefixes of the port


def print_profile(prof, wall_s: float) -> None:
    """The main path's phases (host wall inside each ``sketches.*``/
    ``ingest.*``/``eval.*`` label) and the device's busy time: the union
    of its kernel and copy intervals, by name, from one `torch.profiler`
    trace of the run."""
    from torch.autograd import DeviceType

    for e in sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total):
        if e.key.split(".")[0] in LABELS and e.cpu_time_total > 0:
            print(f"[phase] {e.key}: {e.cpu_time_total / 1e3:.1f} ms host wall over "
                  f"{e.count} call(s)", flush=True)
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.name.split(".")[0] in LABELS):
            continue  # host ops and the labels' device-side ranges
        spans.append((e.time_range.start, e.time_range.end))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):  # union of device intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    wall_ms = wall_s * 1e3
    print(f"[device] busy {busy_us / 1e3:.1f} ms of {wall_ms:.1f} ms main-path wall "
          f"(idle share {1 - busy_us / 1e3 / wall_ms:.4f})", flush=True)
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[device] {tot / 1e3:9.2f} ms x{n:<5} {name[:90]}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.core.sketches import build_sketches
    from repro_torch.data.datasets import make_dataset
    from repro_torch.kernels import _build
    from repro_torch.queries.engine import EvalCache, per_partition_answers_batch
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
    cuts = {k: v for k, v, d in (("partitions", args.partitions, 1024),
                                 ("rows", args.rows, 16384),
                                 ("queries", args.queries, 48)) if v != d}
    if cuts:
        print(f"[reduced] {json.dumps(cuts)} (full size: 1024 partitions x 16384 rows, "
              "48 queries)", flush=True)

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
    t_data = time.perf_counter() - t
    print(f"[data] tpch {table.num_partitions}x{table.rows_per_partition} "
          f"({len(table.schema)} columns), {len(queries)} queries in {t_data:.2f} s",
          flush=True)

    records = run_kernel_phase(table, queries, dev)

    opts = ExecOptions()
    _build.LAUNCHES.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        sk = build_sketches(table, options=opts)
        torch.cuda.synchronize()
        t_sketch = time.perf_counter() - t
        t = time.perf_counter()
        cache = EvalCache(table, options=opts)
        answers = per_partition_answers_batch(table, queries, cache=cache, options=opts)
        torch.cuda.synchronize()
        t_eval = time.perf_counter() - t
    launches = {k[0]: n for k, n in _build.LAUNCHES.counts().items()}
    for name, rec in records.items():
        rec["launches"] = launches.get(name, 0)
    print(f"[main] build_sketches {t_sketch:.2f} s, per_partition_answers_batch "
          f"{t_eval:.2f} s (cold: includes the column stack upload); launches "
          f"{json.dumps(launches, sort_keys=True)}", flush=True)
    idle = [n for n, rec in records.items() if rec["launches"] == 0]
    if idle:
        raise AssertionError(f"the main path never launched {idle}")
    print_profile(prof, t_sketch + t_eval)

    t = time.perf_counter()
    per_partition_answers_batch(table, queries, cache=cache, options=opts)
    torch.cuda.synchronize()
    print(f"[main] warm per_partition_answers_batch {time.perf_counter() - t:.2f} s",
          flush=True)

    t = time.perf_counter()
    host = per_partition_answers_batch(table, queries[:4], options=opts.replace(backend="host"))
    worst = check_answers(host, answers[:4])
    check_sketches(table, sk, ("l_extendedprice", "l_partkey"))
    print(f"[check] 4 queries vs host backend: keys and counts bit-equal, worst sum "
          f"error {worst:.3g} of scale (limit {SUM_RTOL}); 2 columns of sketches vs host "
          f"match; {time.perf_counter() - t:.2f} s", flush=True)
    if not all(np.isfinite(ans.raw).all() for ans in answers):
        raise AssertionError("non-finite per-partition answer")
    err = sample_error(answers, table.num_partitions, args.seed)
    print(f"[answer] 5% uniform sample, mean over {len(answers)} queries: "
          f"{json.dumps(err, sort_keys=True)}", flush=True)

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
