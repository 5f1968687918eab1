#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--partitions 1024] [--rows 16384] [--queries 48]
                          [--held-out 16] [--offline-partitions 256] [--seed 0]

Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once, while the table is drawn);
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
   launch for group_aggregate, moments and histogram_range, moments on
   non-finite rows, histogram_range on NaN, duplicate and unsorted edges
   at NB 10 and 33, level-0 and leaf-sum GBDT histograms), checked and
   timed (their plain versions untimed), listed under their kernel's
   ``cases``; and
   whether ``torch.cumsum`` gives cumsum_seq's bits;
4. the offline plane (slice 1's path) on the first ``--offline-partitions``
   partitions: ``build_sketches`` and ``per_partition_answers_batch`` on
   the default options, every one of its kernels launched, held against
   the port's host backend; then both again on ``ExecOptions(mesh=1)``
   and on a plane of 3 logical shards of the card, bit-equal to the
   single-device run;
5. the Session path at full size: ``Session(table).prepare(WorkloadSpec
   (table), num_train_queries=48)`` with the default ``PickerConfig``,
   then ``Session.execute(QuerySpec(q, error_bound=0.05))`` on held-out
   queries, the executes under ``torch.profiler`` (their parts' host
   walls and the device's busy time): every kernel launched, the walls of
   ``Session(table)`` and ``prepare``, execute times, partitions read,
   coverage and error against the exact answers, beside a 5%-uniform
   partition sample;
6. the first trees of the first funnel model fitted again on the card
   and on the host: the forests must be bit-equal; and tree_hist on
   those binned training codes at level 0 and at the leaf sums of the
   trained first tree, against its plain version;
7. the partition data plane on 3 logical shards of the card
   (``PartitionPlane(("cuda:0",) * 3)``: the 1024-partition stack pads to
   1026 slots, 342 a shard), every check bit-equal to the single device:
   ``[plane]`` ingest (``build_statistics``), the training answers (and
   their launch keys at the local size, as many as the single-device
   census), the held-out executes through an ``AnswerStore`` on the plane
   (equal to phase 5's byte for byte; each 16-partition chunk read on
   6 + 6 + 6 slots), and on a copy of the table two appends, the first
   overflowing into a re-pad at 2049 slots, the second written into the
   slack (folded answers against a cold single-device evaluation,
   ``delta_statistics``); where more than one CUDA device is visible, the
   answers and executes again on all of them.  ``plane_launches`` counts
   only the plane's own calls (the counts are set to 0 just before each
   and read just after; the single-device references run outside), and
   each plane kernel's count must be a multiple of the plane's shards;
8. the streaming append path on the same prepared Session: the training
   answers cached, a warm-up append that overflows the device stack's
   partition bucket, then ``APPENDS`` (3) appends of ``--partitions`` / 64
   partitions each folded into the sketches and every cached answer
   (profiled), held-out executes on the grown table,
   ``predicate_mask_device`` against the host mask for every held-out
   query, and a cold rebuild of sketches and answers that the folded ones
   must equal bit for bit;
9. the serving path on the same Session over the grown table:
   ``[batch]`` a ``BatchPicker`` over the Session's picker
   answers the held-out queries at a 5% budget, cold and warm (selections
   equal to the single-query ``pick``, no new KMeans key on the warm
   pass); ``[faults]`` a second route on ``ExecOptions(faults=GATE)``,
   sharing the Session's sketch store, executes them at the 5% bound
   (coverage ≥ 0.9 with failed reads, ``degraded`` reported exactly, no
   launch key beyond the fault-free executes'); ``[serve]`` a ``FrontDoor`` on a
   ``VirtualClock`` over a route whose every read fails and the card
   Session (every ticket resolves, fault-free answers bit-equal to direct
   executes, the breaker opens, a burst sheds only at the top of the
   brownout ladder, no new launch key), then the ``start()`` pump thread
   on new queries from two submitter threads; ``[relaxed]`` phase 6's
   trees refitted with ``parity_relaxation`` on the card, within the
   reference's tolerances of the host forest;
10. the lifecycle path on the same Session over the grown table:
   ``[lifecycle]`` ``Session.save`` to a fresh temporary directory with a
   ``WriteAheadLog`` beside it, then through the WAL a soft delete of 5%
   of the live partitions (chosen by ``--seed``), a compaction, a
   rebalance over 4 shards and an append of ``--partitions`` / 64
   partitions, each folded (sketches, the device stack, every cached
   answer) and followed by the held-out executes (after the delete: no
   tombstoned partition read, coverage ≥ 0.9 against the exact answers
   over the live partitions); then a cold oracle on a copy of the table
   (sketches, cached answers and executes bit-equal; no full sketch
   rebuild, two in-bucket stack rewrites, no eval launch key beyond the
   streaming appends') and
   new queries over the rewritten stack bit-equal to a cold
   ``EvalCache``'s; ``[wal]`` a delete that crashes at ``wal.apply``,
   ``wal.recover`` of the directory against ``replay`` on the live table
   (tables, sketches, answers and executes equal);
11. (phases 11 to 13 run in a second process on the same card, started
   after phase 3 and beside phases 4 to 10, its output printed after
   phase 10; each process counts its own launches) the LM substrate's
   serving path and ``launch/serve.py --aqp``:
   ``[lm]`` `repro_torch.launch.serve.main` at full width on the card for
   qwen1.5-0.5b (the serve default: MHA, a tied head), yi-6b (GQA, an
   untied head), recurrentgemma-9b at full depth (RG-LRU blocks beside
   local MQA attention, 38 layers with a ragged tail), mamba2-130m
   whole (SSD blocks), whisper-small whole (12 encoder layers over 1,500
   frame embeddings, 12 decoder layers with cross-attention) and
   internvl2-26b at full depth (48 layers after a 256-token image
   prefix, ``--max-len 312``), ``--batch 4 --prompt-len 32 --gen 16``,
   its prefill and decode times, each decode step against the bytes it
   must read (weights, whisper's cross K/V), tokens/s, parameter bytes
   and peak device memory, and a warm rerun of the loop; checked (a) the
   full forward over prompt and generated tokens (with the same frames
   or image) against the prefill and decode logits at every generated
   position, (b) the first 2 layers (the hybrid's first unit, 3;
   whisper's first 2 encoder layers too) on the card against the CPU at
   batch 1, both at the reference's tolerance (``LM_TOL``;
   ``HYBRID_TOL`` for the hybrid); then
   the MoE family: `launch/serve.main` at mixtral-8x22b's and
   deepseek-v2-236b's smoke configs on the card, and `serve_loop` at
   full width on their first ``MOE_LAYERS`` layers (seeded random
   weights drawn on the card; each MoE call's ``drop_frac``, each decode
   step against its weight-read bound, a warm rerun), checked (b) on 2
   layers card against CPU at the published capacity and (a) decoding
   against the forward at a capacity that drops nothing, each time with
   the two runs' routing compared token by token (a token routed apart
   must see router logits within ``LM_TOL``) and the logits compared on
   one run's routing decisions; then ``[aqp]`` ``main(["--aqp"])`` at
   its defaults on the card, its kernel launches counted, with the same
   ``mean reads`` and ``modes`` as on the CPU;
12. the LM training path: ``[train]`` `repro_torch.launch.train.main` at
   full width on the card for qwen1.5-0.5b (the launcher's default),
   ``--steps 6 --batch 8 --ckpt-every 3`` into a temporary directory: the
   token store's and the PS³ plane's build times, each step's time and
   tokens/s, the first and last loss, parameter and optimizer-state
   bytes, peak device memory and each checkpoint save's time and bytes;
   checked (a) ``step_3`` alone resumed to step 6 gives the uninterrupted
   run's losses at the reference's resume tolerance (``TRAIN_TOL``), (b)
   the first 2 layers of the trained model at batch 1, card against CPU:
   `lm.loss_fn` and every gradient at the CPU tests' tolerances, (c) the
   card's plane picks the shards and weights of ``PS3DataPlane(...,
   backend="host")`` on the CPU; then ``[check] dist``, the multi-device
   layer on a one-rank NCCL group (the machine has one card):
   `distributed.compress.compressed_pod_mean` on the trained model's
   gradients bit-equal to its plain form with one pod and within the
   int8 bound, ``step_3`` restored onto a (1, 1) CUDA ``DeviceMesh``
   through `distributed.sharding.param_shardings` bit-equal to the plain
   restore, and a step with ``compress_pod_grads`` bit-equal to one
   without; then every other family: mamba2-130m whole through
   ``launch/train.main`` (4 steps, checkpoints every 2, (a) a resume from
   step 2; the launcher keeps the reference launcher's options, remat
   off and one microbatch), and `train.steps.make_train_step` on a
   ``PS3DataPlane``'s batches at full width under each full config's
   `train.steps.dryrun_train_options` (the reference dry run's state
   dtype, microbatch count, accumulator and remat: int8 states, 8
   microbatches and a bf16 accumulator for the MoE cuts, f32 states and
   8 microbatches for internvl2-26b, f32 states and one microbatch for
   the rest, remat on for all) for recurrentgemma-9b on one pattern unit
   (3 layers), mixtral-8x22b on 1 layer, deepseek-v2-236b on its lead
   and one MoE layer, whisper-small whole (with frame embeddings),
   internvl2-26b on 2 layers (with image embeddings) and mamba2-130m
   whole: each arch's ``[train]`` line (layers, options, parameter and
   state bytes, step times, tokens/s, first and last loss, peak memory),
   every loss finite, (b) card against CPU at batch 1 (32 tokens for the
   MoE and internvl cuts), MoE routing compared token by token, the
   recurrent families in f32 where bf16 misses, and (e) one step's
   gradients under those options against one under
   ``TrainOptions(remat=False)``, card against card, at
   ``TRAIN_OPTIONS_REL_L2`` (remat's own gap printed on internvl2-26b);
13. the examples' twins (``examples/*_torch.py``) through their
   ``main()`` with their references' own arguments on the card:
   ``[example]`` their output, wall, key outputs and kernel launches (the
   two PS³ twins must launch kernels);
14. (in a third process, which starts its work when phases 11 to 13 have
   ended, beside phases 4 to 10: its fake process group never meets
   phase 12's NCCL group) the dry run
   (`repro_torch.launch.dryrun`): ``[dryrun]`` (a) phase 11's
   qwen1.5-0.5b decode step at its serving shape and phase 12's warm
   mamba2-130m train step under its dry-run options, each run once on
   the card with seeded random weights under `FlopCounterMode` and traced
   as a `lower_cell` row on a (1, 1) mesh of fake CUDA tensors: the
   row's FLOPs equal the count exactly and its ``argument_bytes`` the
   live model, state and inputs; its bound terms (the memory term the
   bytes floor, `roofline.floor_bytes`) and `roofline.step_bound`,
   printed after phase 10 beside the step phase 11 or 12 measured and
   their ratio, and beside the time the eager step's own op-by-op bytes
   would take; (b) qwen1.5-0.5b ``decode_32k`` on the fake 16 × 16
   group (the card's torch release's `DTensor` partitioning), its row
   and trace time; (c) qwen1.5-0.5b's and mamba2-130m's ``train_4k`` on
   the same group, each held to its audit (the FLOPs a device, counted
   below `DTensor`, equal the placements' shares, computed above it),
   with its trace time and the torch release; (b) and (c) each beside
   the reference's own row of the cell (``results/dryrun_reference.json``,
   read as data): FLOPs, link bytes and memory a device and the port's
   over the reference's, held to `reference_bounds` (FLOPs within 1.5
   for qwen's train step and 2 elsewhere, and at least 0.9 where the
   reference splits the step over its devices; qwen's train memory
   within 2);
15. the ``kernels`` JSON line, then ``{"ok": true, ...}`` as the last line.
   Each kernel's ``session_launches``, ``plane_launches``,
   ``stream_launches``, ``serve_launches``, ``lifecycle_launches``,
   ``aqp_launches``, ``train_launches`` and ``example_launches`` count
   its launches in the Session, plane, streaming, serving, lifecycle,
   ``--aqp``, training and examples paths, and ``launches`` is their
   sum.  The LM model launches no hand-written kernel (its reference has
   no Pallas kernel); the training path's launches are its PS³ planes'
   (every arch's run).

A ``[time] phase N <name> <s>`` line follows every phase (phases 11 to
13 and 14 on their own processes' clocks, then ``[time] phase 11-13
wait`` and ``[time] phase 14 dryrun wait`` on the first's); ``[reduced]``
lines list what was cut to keep the run inside its time limit.

Without a CUDA device, or without the repository beside it, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

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
APPENDS = 3  # timed appends of the streaming phase, after the warm-up one
ROUNDS = 5  # timed rounds of every kernel case; the median is recorded
PLANE_SHARDS = 3  # logical shards of phase 7: 1024 slots would never pad on 2 or 4
SERVE_QUERIES = 8  # held-out queries of phase 9's FrontDoor (see CUTS)
LIFECYCLE_QUERIES = 8  # held-out queries of phase 10 after the delete and in [wal] (see CUTS)
# depth cut so that the run stays inside its time limit (no check dropped)
CUTS = (
    "phase 9 [faults]: the faulted route shares the Session's sketch store instead of "
    "building its own Session(table) (ExecOptions.faults gates only the planner's chunk "
    "reads and AnswerStore's exact reads)",
    f"phase 8 [stream]: {APPENDS} timed appends after the warm-up append (6 before)",
    "phase 5 [main]: torch.profiler traces the held-out executes only, not Session(table) "
    "+ prepare (whose trace of 2.0 M device events took about 150 s to stop; its last "
    "profile is in PERF.md § 5), to make room for phase 12",
    f"phase 9 [serve]: the FrontDoor's service model and one closed-loop pass of its 2 "
    f"tenants over the first {SERVE_QUERIES} held-out queries (2 passes over 16 before), each "
    f"fault-free answer held to one direct execute of its query (one a ticket before), to "
    f"make room for phase 11's whisper-small and internvl2-26b",
    "phase 9 [serve]: the dead route shares the Session's sketch store too, as [faults]' "
    "route does, instead of building its own Session(table) (whose ingest launches were the "
    "serving path's only moments, histogram_range and bincount launches), to make room for "
    "phase 12's training of every family",
    f"phase 10 [lifecycle] and [wal]: the executes after the compaction, the rebalance and "
    f"the append, the cold oracle's planner answers and the recovered Session's answers and "
    f"executes on the first {LIFECYCLE_QUERIES} held-out queries (16 before; the delete's "
    f"coverage gate keeps all 16), to make room for phase 12's training of every family",
    "phase 12 [train]: at full width, recurrentgemma-9b on 3 of 38 layers (one pattern "
    "unit), mixtral-8x22b on 1 of 56, deepseek-v2-236b on 2 of 60 (its dense lead and one MoE "
    "layer) and internvl2-26b on 2 of 48 (their whole models do not fit one card with "
    "gradients and AdamW state); whisper-small and mamba2-130m whole; 3 steps each under the "
    "dry-run options (mamba2-130m: 4 more through launch/train.main)",
    "phase 12 [check] train (b): batch 1 x 32 tokens for the mixtral-8x22b, deepseek-v2-236b "
    "and internvl2-26b cuts, to keep their CPU side short (128 tokens for the others)",
)


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
    # the second process of phases 11 to 13 (see LMPhases): its result
    # file, the card line phase 1 printed and the first process's pid
    ap.add_argument("--lm-phases", metavar="RESULT_JSON", help=argparse.SUPPRESS)
    # the third process, phase 14's dry run (see DryRunPhase): its result
    # file, and the second process's, whose writing it waits for
    ap.add_argument("--dryrun-phase", metavar="RESULT_JSON", help=argparse.SUPPRESS)
    ap.add_argument("--after", metavar="RESULT_JSON", help=argparse.SUPPRESS)
    ap.add_argument("--card", help=argparse.SUPPRESS)
    ap.add_argument("--parent", type=int, help=argparse.SUPPRESS)
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
    shape = f"{b}x{v}x{r}"
    return [
        group_aggregate_case(values, sparse, codes, radix, f"{shape}, radix {radix}, 5% mask",
                             record=False),
        group_aggregate_case(values, mask, codes4, 4, f"{shape}, codes mod 4, radix 4",
                             record=False),
        group_aggregate_case(values, mask, codes_wide, wide,
                             f"{shape}, seeded codes, radix {wide}", record=False),
        group_aggregate_case(*head, radix, f"16x{v}x{r}, radix {radix}, first 16 stack rows",
                             record=False, check=same_rows("group_aggregate", full)),
    ]


def fused_eval_case(args, shape, record=True, check=None) -> Case:
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
                2 * xs.numel() + passing * v, None, shape, record, check)


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


def same_rows(name: str, full, rows: int = 16):
    """Check of a launch over the first ``rows`` stack rows (partitions)
    alone: it must give the bits the full launch gives them (the streaming
    delta == cold)."""
    import torch

    def check(out):
        if not torch.equal(out.view(torch.int32), full[:rows].view(torch.int32)):
            raise AssertionError(f"{name}: {rows} rows alone differ from the full launch")
        return f"{rows} rows alone bit-equal to the {full.shape[0]}-row launch"
    return check


def shard_rows(args, p: int, shard: int = 1, shards: int = PLANE_SHARDS):
    """The operands of the stack rows shard ``shard`` of a ``shards``-shard
    plane launches: partitions [shard·L, (shard + 1)·L) of each stacked
    query of a ``p``-partition stack (L = P padded to a multiple of
    ``shards``, over ``shards``) → (operands, their rows in the full launch)."""
    import torch

    local = -(-p // shards)
    lo, hi = shard * local, min((shard + 1) * local, p)
    dev = args[0].device
    idx = torch.cat([torch.arange(i * p + lo, i * p + hi, device=dev)
                     for i in range(args[0].shape[0] // p)])
    return tuple(a.index_select(0, idx).contiguous() if torch.is_tensor(a) else a
                 for a in args), idx


def shard_check(name: str, full, idx):
    """Check of a shard's launch: the bits the full launch gives its rows."""
    import torch

    def check(out):
        if not torch.equal(out.view(torch.int32), full.index_select(0, idx).view(torch.int32)):
            raise AssertionError(f"{name}: a plane shard's rows differ from the full launch")
        return f"a plane shard's {idx.numel()} rows bit-equal to the {full.shape[0]}-row launch"
    return check


def moments_case(x, shape, record=False, library=None, check=None) -> Case:
    """moments on ``x``.  Bytes: the column and the output; ops: ten a value.
    Beyond "close": min and max bit-equal to the plain version, log-min and
    log-max within rtol 1e-6 (logf against torch.log: ulps)."""
    import numpy as np

    from repro_torch.kernels import moments

    p, r = x.shape
    want = moments.moments_plain(x).cpu().numpy()

    def exact(out):
        got = out.cpu().numpy()
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
        np.testing.assert_allclose(got[:, 4:6], want[:, 4:6], rtol=1e-6)
        return ("min/max bit-equal, log-min/max rtol 1e-6"
                + (f"; {check(out)}" if check is not None else ""))
    return Case("moments", moments.moments, moments.moments_plain, (x,), "close",
                p * r * 4 + p * 8 * 4, p * r * 10, library, shape, record, exact)


def histogram_case(x, e, shape, record=False, library=None, check=None) -> Case:
    """histogram_range on ``x`` against edges ``e``, bit-equal.  Bytes: the
    column, the edges and the output; ops: three a value and bucket."""
    from repro_torch.kernels import histogram

    p, r = x.shape
    nb = e.shape[1] - 1
    return Case("histogram_range", histogram.histogram_range,
                histogram.histogram_range_plain, (x, e), "bits",
                p * r * 4 + p * (2 * nb + 1) * 4, p * r * nb * 3, library, shape, record, check)


def ingest_stress(data, dev, seed: int) -> list[Case]:
    """Unrecorded moments and histogram_range cases off the main path's
    shapes: moments on seeded mixed-sign rows with NaN, +inf, -inf (and both
    infinities) and an all-NaN row; histogram_range on the column's first 16
    partitions cut to 2050 rows (rows not 16-byte aligned) with NaN values,
    values at and above the top edge, duplicate edges, an all-NaN partition
    (its quantile edges are NaN), unsorted edges, infinite values and open
    ends, at NB = 10 and at NB = 33 (the general instance)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    xm = (rng.normal(size=(16, 16384)) * 3 + 1.5).astype(np.float32)
    xm[1, 7] = np.nan
    xm[2, 9] = np.inf
    xm[3, 11] = -np.inf
    xm[4, 3], xm[4, 5] = np.inf, -np.inf
    xm[5] = np.nan
    cases = [moments_case(torch.from_numpy(xm).to(dev), "16x16384, mixed sign, NaN, +inf, "
                          "-inf and both infinities, an all-NaN row")]

    xs = np.array(data[:16, :2050], np.float64)
    xs[0, ::13] = np.nan  # NaN values count nowhere (edges from the rest)
    xs[1] = np.nan  # an all-NaN partition: NaN edges
    xs[2] = np.round(xs[2] / 1e4)  # few distinct values: duplicate edges
    xs[3, ::17], xs[3, 5::17] = np.inf, -np.inf
    xs[5, ::11], xs[5, 3::11] = np.inf, -np.inf
    for nb in (10, 33):
        with np.errstate(invalid="ignore"):  # inf - inf between infinite quantiles
            e = np.quantile(xs, np.linspace(0, 1, nb + 1), axis=1).T
        e[0] = np.nanquantile(xs[0], np.linspace(0, 1, nb + 1))
        e[4] = e[4, rng.permutation(nb + 1)]  # unsorted
        e[5, 0], e[5, -1] = -np.inf, np.inf  # open ends
        x = xs.copy()
        x[6:, 1] = e[6:, -1]  # the last bucket is closed
        x[6:, 2] = e[6:, -1] + 1  # above the top edge: nowhere
        x32 = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
        e32 = torch.from_numpy(np.ascontiguousarray(e, np.float32)).to(dev)
        cases.append(histogram_case(x32, e32, f"{xs.shape[0]}x{xs.shape[1]}, NB {nb}: NaN "
                                    "values and edges, values at and above the top edge, "
                                    "duplicate and unsorted edges, infinite values and ends"
                                    + (", the general instance" if nb > 16 else "")))
    return cases


def kernel_cases(table, queries, held_out, dev) -> list[Case]:
    """The offline plane's kernels with the operands the main path hands
    them: one numeric and one categorical column of the table (and the
    counting passes on its first 16 partitions alone, as a streaming delta
    launches them, plus `ingest_stress`), the first stacked chunk of each
    eval kernel in the workload's launch order (and fused_eval at a planner
    chunk read of a held-out query);
    predicate_eval on the clauses of the workload query with the most of
    them, with the shared (C, G) map that `predicate_mask_device` passes
    and again with per-partition bounds and a (P, C, G) map."""
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.kernels import fused, groupagg, histogram, moments, predicate
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

    # the main path's shape, then its first 16 partitions alone: a streaming
    # delta's launch, which must give the full launch's rows
    cases.append(moments_case(x, f"{p}x{r}", record=True, library=(
        "torch.aminmax + torch.sum over x and log x", lib_moments)))
    head = x[:16].clone()
    cases.append(moments_case(head, f"16x{r}, the first 16 partitions alone",
                              check=same_rows("moments", moments.moments(x))))

    edges = np.quantile(data.astype(np.float64), np.linspace(0, 1, 11), axis=1).T
    e = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(dev)
    nb = e.shape[1] - 1
    offs = torch.arange(p, device=dev)[:, None] * (nb + 2)

    def lib_hist():
        k = torch.searchsorted(e, x, right=True) - 1  # lo <= x < hi
        k = torch.where(x == e[:, -1:], nb - 1, k).clamp_(-1, nb)  # last bucket closed
        return torch.bincount((k + 1 + offs).view(-1), minlength=p * (nb + 2))

    cases.append(histogram_case(x, e, f"{p}x{r}", record=True, library=(
        "torch.searchsorted + torch.bincount", lib_hist)))
    cases.append(histogram_case(head, e[:16].clone(), f"16x{r}, the first 16 partitions alone",
                                check=same_rows("histogram_range",
                                                histogram.histogram_range(x, e))))
    cases += ingest_stress(data, dev, seed=len(cases))

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
        part, idx = shard_rows(args, cache.device_stack().shape[1])
        part_shape = ("x".join(str(s) for s in part[0].shape) + f", radix {radix}, shard 1 of "
                      f"the {PLANE_SHARDS}-shard plane")
        if name == "group_aggregate":
            values, mask, codes_c, _ = args
            cases.append(group_aggregate_case(values, mask, codes_c, radix, shape))
            cases += group_aggregate_stress(values, mask, codes_c, radix, seed=len(cases))
            cases.append(group_aggregate_case(
                *part, part_shape, record=False,
                check=shard_check(name, groupagg.group_aggregate(*args), idx)))
            continue
        cases.append(fused_eval_case(args, shape))
        cases.append(chunk_read_case(table, held_out, dev))
        cases.append(fused_eval_case(part, part_shape, record=False,
                                     check=shard_check(name, fused.fused_eval(*args), idx)))

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

    # the degenerate plane (one shard) and the logical 3-shard plane: the
    # same sketches and answers, bit for bit
    t = time.perf_counter()
    for mesh in (1, logical_plane(opts.torch_device())):
        o = opts.replace(mesh=mesh)
        check_sketches_bits(build_sketches(table, options=o), sk)
        cache_p = EvalCache(table, options=o)
        check_answers_bits(per_partition_answers_batch(table, queries, cache=cache_p, options=o),
                           answers)
    print(f"[plane] offline plane on ExecOptions(mesh=1) and on {PLANE_SHARDS} logical shards "
          f"({p} -> {cache_p.device_stack().shape[1]} slots): every sketch field and "
          f"{len(queries)} answers bit-equal to the single-device run; "
          f"{time.perf_counter() - t:.2f} s", flush=True)


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
    t0 = time.perf_counter()
    sess = Session(table)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    sess.prepare(WorkloadSpec(table, seed=args.seed), num_train_queries=args.queries,
                 picker_config=PickerConfig(seed=args.seed))
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    planned, walls = [], []
    with profiler() as prof:  # the executes only: see CUTS
        for q in held_out:
            t = time.perf_counter()
            planned.append(sess.execute(QuerySpec(q, error_bound=ERROR_BOUND)))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
    launches = launches_of(SESSION_KERNELS)
    print(f"[main] Session(table) {t_store:.2f} s (sketch store), Session(table) + prepare "
          f"{t_prepare:.2f} s ({args.queries} training queries), {len(held_out)} executes "
          f"{sum(walls):.2f} s; launches {json.dumps(launches, sort_keys=True)}", flush=True)
    print_profile(prof, sum(walls))
    return sess, launches, walls, planned, held_out


def check_forest(sess, table, args) -> dict:
    """Phase 6: the first trees of funnel model 0, fitted again from the
    training features on the card and on the host; bit-equal to each other
    and to the trained forest's first trees.  → the fit's inputs and the
    host forest, for the serving phase's relaxed fit."""
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
    return dict(x=x, y=y, kw=kw, host=host, host_s=t_host)


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
# phase 7: the partition data plane, on logical shards of the card
# --------------------------------------------------------------------------
PLANE_KERNELS = ("fused_eval", "group_aggregate", "moments", "histogram_range", "bincount")


class PlaneLaunches:
    """The launches of the plane's own calls, and only theirs: each call
    runs with every count set to 0 just before it and read just after, so
    the single-device references between them count nowhere.  A plane
    kernel launches once a shard, so its count in a call that is not a
    multiple of the plane's shards raises."""

    def __init__(self):
        self.total: dict[str, int] = {}

    def __call__(self, plane, fn, *args, **kwargs):
        from repro_torch.kernels import _build

        _build.LAUNCHES.reset()
        out = fn(*args, **kwargs)
        counts = {k[0]: n for k, n in _build.LAUNCHES.counts().items()}
        odd = {k: n for k, n in counts.items()
               if k in PLANE_KERNELS and n % plane.num_devices}
        if odd:
            raise AssertionError(f"[plane] {getattr(fn, '__name__', fn)} launched {odd}: not "
                                 f"once a shard of {plane.num_devices}")
        for k, n in counts.items():
            self.total[k] = self.total.get(k, 0) + n
        return out


def logical_plane(dev, shards: int = PLANE_SHARDS):
    """``shards`` logical shards of one card: every split, pad, per-shard
    launch, write across shards and gather of a plane of devices."""
    from repro_torch.distributed.dataplane import PartitionPlane

    return PartitionPlane((str(dev),) * shards)


def check_stats_bits(got, want, what: str) -> None:
    """Every tensor of `build_statistics` bit-equal (other values equal)."""
    import numpy as np

    for col, tensors in want.items():
        if tensors.keys() != got[col].keys():
            raise AssertionError(f"{what}: {col} has keys {sorted(got[col])}")
        for key, w in tensors.items():
            g = got[col][key]
            if isinstance(w, np.ndarray):
                if g.dtype != w.dtype or g.shape != w.shape or g.tobytes() != w.tobytes():
                    raise AssertionError(f"{what}: {col}.{key} differs")
            elif g != w:
                raise AssertionError(f"{what}: {col}.{key} {g!r} != {w!r}")


def plane_ingest(table, opts, single, counted: PlaneLaunches) -> None:
    """`[plane]` ingest: the full `build_statistics` on the plane, bit-equal
    to the single device's."""
    import torch

    from repro_torch.core import ingest

    plane = opts.plane()
    t = time.perf_counter()
    want = ingest.build_statistics(table, discrete_counts=True, options=single)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t
    t = time.perf_counter()
    got = counted(plane, ingest.build_statistics, table, discrete_counts=True, options=opts)
    torch.cuda.synchronize()
    t_plane = time.perf_counter() - t
    check_stats_bits(got, want, "[plane] ingest")
    p = table.num_partitions
    print(f"[plane] ingest: build_statistics(discrete_counts=True) of {p}x"
          f"{table.rows_per_partition} on {plane.num_devices} shards of {plane.local(p)} "
          f"partitions ({plane.padded(p)} slots) {t_plane:.2f} s, single device {t_single:.2f} "
          f"s; every tensor of {len(want)} columns bit-equal", flush=True)


def plane_answers(table, queries, opts, single, counted: PlaneLaunches,
                  tag: str = "[plane]") -> None:
    """`[plane]` answers: the workload through `per_partition_answers_batch`
    on a plane `EvalCache` against a fresh single-device one, bit-equal;
    the plane's launch keys at the local stack size, as many as the
    single-device census has."""
    import torch

    from repro_torch.queries import device
    from repro_torch.queries.engine import EvalCache, per_partition_answers_batch

    t = time.perf_counter()
    want = per_partition_answers_batch(table, queries, options=single,
                                       cache=EvalCache(table, options=single))
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t
    census = device.workload_census(table, queries, EvalCache(table, options=single))
    cache = EvalCache(table, options=opts)
    device.TRACES.reset()
    t = time.perf_counter()
    got = counted(cache.plane, per_partition_answers_batch, table, queries, options=opts,
                  cache=cache)
    torch.cuda.synchronize()
    t_plane = time.perf_counter() - t
    keys = set(device.TRACES.counts())
    check_answers_bits(got, want)
    stack = cache.device_stack()
    local = stack.local
    if keys != device.workload_census(table, queries, cache):
        raise AssertionError(f"{tag} launch keys {sorted(keys)} are not the plane's census")
    if any(k[1] % local for k in keys):
        raise AssertionError(f"{tag} a launch key is not at the local size {local}: {keys}")
    if len(keys) != len(census):
        raise AssertionError(f"{tag} {len(keys)} launch keys, the single-device census has "
                             f"{len(census)}")
    print(f"{tag} answers: {len(queries)} queries on {len(stack.shards)} shards of {local} "
          f"partitions ({stack.shape[1]} slots) {t_plane:.2f} s, single device {t_single:.2f} "
          f"s; group keys and raw tensors bit-equal; {len(keys)} launch keys at the local size, "
          f"as many as the single-device census", flush=True)


def plane_executes(sess, held_out, planned, opts, counted: PlaneLaunches,
                   tag: str = "[plane]") -> None:
    """`[plane]` executes: a planner over ``sess``'s picker and sketch store
    with an `AnswerStore` on the plane; the held-out executes must equal
    phase 5's byte for byte.  Each chunk read evaluates its 16 partitions
    on the plane (6 + 6 + 6 slots on 3 shards, 2 of them pad)."""
    import torch

    from repro_torch.api import QuerySpec
    from repro_torch.queries import device
    from repro_torch.queries.engine import stack_partitions

    plane = opts.plane()
    route = grafted_session(sess, opts, share_sketches=True)
    chunk_local = plane.local(stack_partitions(sess.planner_config.chunk))
    full_local = plane.local(stack_partitions(sess.table.num_partitions))
    device.TRACES.reset()
    got, walls = [], []
    for q in held_out:
        t = time.perf_counter()
        got.append(counted(plane, route.execute, QuerySpec(q, error_bound=ERROR_BOUND)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    check_same_planned(got, planned, f"{tag} executes")
    rows = sorted({k[1] for k in device.TRACES.counts()})
    if min(rows) != chunk_local or any(r % chunk_local and r % full_local for r in rows):
        raise AssertionError(f"{tag} chunk reads launched {rows} rows, not at the local "
                             f"{chunk_local} (or {full_local})")
    print(f"{tag} executes: {len(held_out)} at error_bound {ERROR_BOUND} through an AnswerStore "
          f"on {plane.num_devices} shards, p50 {sorted(walls)[len(walls) // 2]:.3f} s; "
          f"estimates, group keys, CI halfwidths and partitions read equal to phase 5's byte for "
          f"byte; chunk reads of {sess.planner_config.chunk} partitions launched at {chunk_local} "
          f"a shard ({plane.padded(stack_partitions(sess.planner_config.chunk))} slots); launch "
          f"rows {rows}", flush=True)


def plane_appends(sess, train_queries, held_out, opts, single, counted: PlaneLaunches,
                  args) -> None:
    """`[plane]` appends, on a deep copy of the table (later phases see it
    unchanged): an `AnswerStore` on the plane with the training answers
    cached, an append that overflows the plane's stack into a re-pad, then
    one written into the slack.  After each the folded answers must equal a
    cold single-device evaluation and `delta_statistics` on the plane the
    single device's, bit for bit."""
    import copy

    import torch

    from repro_torch.core import ingest
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.table import append_partitions
    from repro_torch.queries.engine import AnswerStore, EvalCache, per_partition_answers_batch

    table = copy.deepcopy(sess.table)
    everything = list(train_queries) + list(held_out)
    store = AnswerStore(table, options=opts)
    cache = store._eval_cache
    plane = store.plane
    t = time.perf_counter()
    counted(plane, store.get_batch, train_queries)
    torch.cuda.synchronize()
    before = cache.device_stack().shape[1]
    print(f"[plane] appends: {len(train_queries)} answers cached on the plane in "
          f"{time.perf_counter() - t:.2f} s; the stack holds {before} slots", flush=True)
    kinds = []
    for i, seed in enumerate((100, 101)):
        start = table.num_partitions
        counts = (cache.stack_rebuilds, cache.stack_appends)
        slots = cache.device_stack().shape[1]
        delta = make_dataset("tpch", num_partitions=append_size(args.partitions),
                             rows_per_partition=table.rows_per_partition, layout="random",
                             seed=seed)
        t = time.perf_counter()
        append_partitions(table, delta.columns)
        got = counted(plane, store.get_batch, everything)
        torch.cuda.synchronize()
        t_fold = time.perf_counter() - t
        stack = cache.device_stack()
        t = time.perf_counter()
        cold = per_partition_answers_batch(table, everything, options=single,
                                           cache=EvalCache(table, options=single))
        torch.cuda.synchronize()
        t_cold = time.perf_counter() - t
        check_answers_bits(got, cold)
        check_stats_bits(counted(plane, ingest.delta_statistics, table, start,
                                 discrete_counts=True, options=opts),
                         ingest.delta_statistics(table, start, discrete_counts=True,
                                                 options=single), "[plane] delta_statistics")
        # past the slots: one re-pad (and re-shard); else one write into the slack
        kinds.append("re-pad" if table.num_partitions > slots else "in-slack append")
        want = (counts[0] + 1, counts[1]) if kinds[-1] == "re-pad" else (counts[0], counts[1] + 1)
        if (cache.stack_rebuilds, cache.stack_appends) != want:
            raise AssertionError(f"[plane] append {i + 1}: stack_rebuilds "
                                 f"{cache.stack_rebuilds}, stack_appends {cache.stack_appends}, "
                                 f"expected {want} ({kinds[-1]})")
        print(f"[plane] append {i + 1} (seed {seed}): {start} -> {table.num_partitions} "
              f"partitions, fold of {len(everything)} answers ({len(held_out)} misses) "
              f"{t_fold:.2f} s, cold single-device {t_cold:.2f} s; stack {stack.shape[1]} slots, "
              f"{stack.local} a shard; stack_rebuilds {cache.stack_rebuilds} stack_appends "
              f"{cache.stack_appends} ({kinds[-1]}); answers and delta_statistics bit-equal",
              flush=True)
    if args.partitions == 1024 and kinds != ["re-pad", "in-slack append"]:
        raise AssertionError(f"[plane] the appends took {kinds}, not a re-pad then an append")


def plane_path(sess, train_queries, held_out, planned, args) -> dict:
    """Phase 7 → the launches of the plane's own calls (`PlaneLaunches`)."""
    import torch

    single = sess.options.replace(mesh=None)
    opts = single.replace(mesh=logical_plane(single.torch_device()))
    counted = PlaneLaunches()
    plane_ingest(sess.table, opts, single, counted)
    plane_answers(sess.table, train_queries, opts, single, counted)
    plane_executes(sess, held_out, planned, opts, counted)
    plane_appends(sess, train_queries, held_out, opts, single, counted, args)
    if torch.cuda.device_count() >= 2:
        saved = os.environ.get("REPRO_MESH")
        os.environ["REPRO_MESH"] = "all"
        try:
            real = single.replace(mesh="auto")
            tag = f"[plane] {real.plane().num_devices} devices:"
            plane_answers(sess.table, train_queries, real, single, counted, tag)
            plane_executes(sess, held_out, planned, real, counted, tag)
        finally:
            if saved is None:
                os.environ.pop("REPRO_MESH")
            else:
                os.environ["REPRO_MESH"] = saved
    else:
        print("[plane] one CUDA device is visible: the plane ran as logical shards of it; "
              "launches on separate devices were not run", flush=True)
    torch.cuda.synchronize()
    idle = [k for k in PLANE_KERNELS if counted.total.get(k, 0) == 0]
    if idle:
        raise AssertionError(f"the plane never launched {idle}")
    print(f"[plane] launches of the plane's own calls (each a multiple of its shards) "
          f"{json.dumps(counted.total, sort_keys=True)}", flush=True)
    return counted.total


# --------------------------------------------------------------------------
# phase 8: the streaming append path on the prepared Session
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


def stream_path(sess, train_queries, held_out, args) -> tuple[dict, frozenset]:
    """The streaming append path on the prepared Session → its launches
    and the eval launch keys of one in-bucket append.

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
    return launches, keys[0][0]


# --------------------------------------------------------------------------
# phase 9: the serving path on the prepared Session
# --------------------------------------------------------------------------
SERVE_KERNELS = ("fused_eval", "pdist_sq", "tree_hist", "cumsum_seq")
# the reference's coverage-gate policy (`tests/test_faults.py`): 5% of read
# attempts fail transiently, 2% time out, 5% straggle, 1.25% of partitions
# lose every replica
GATE = dict(seed=20240807, dead_frac=0.0125, fail_frac=0.05, timeout_frac=0.02,
            straggler_frac=0.05)
RELAXED_RTOL = dict(leaf=(1e-4, 1e-5), pred=(1e-4, 1e-4))  # `tests/test_gbdt_device.py`


@contextlib.contextmanager
def shared_sketch_store(store):
    """Sessions built inside take ``store`` as their sketch store instead of
    building one (a cold build of the table's sketches, 25 s at full size)."""
    from repro_torch import api

    saved = api.SketchStore
    api.SketchStore = lambda table, options=None: store
    try:
        yield
    finally:
        api.SketchStore = saved


def grafted_session(sess, options, share_sketches: bool = False):
    """A Session over ``sess``'s table on ``options`` with ``sess``'s trained
    picker, as `benchmarks/bench_serving_load._grafted_session` grafts one:
    its own answer store and planner, and its own sketch store unless
    ``share_sketches`` (then ``sess``'s)."""
    from repro_torch.api import Session
    from repro_torch.planner import QueryPlanner

    with (shared_sketch_store(sess.sketches) if share_sketches
          else contextlib.nullcontext()):
        route = Session(sess.table, options=options)
    route.picker = sess.picker
    route.planner = QueryPlanner(route.picker, route.answers, views=route.views,
                                 config=route.planner_config)
    route._fb_version = sess.table.version
    return route


def batch_phase(sess, held_out, truth) -> None:
    """`[batch]`: BatchPicker over the Session's picker at a 5% budget."""
    import numpy as np
    import torch

    from repro_torch.core import clustering
    from repro_torch.serving import BatchPicker

    budget = max(1, int(ERROR_BOUND * sess.table.num_partitions))
    bp = BatchPicker(sess.picker)
    t = time.perf_counter()
    cold = bp.answer_batch(held_out, budget)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t
    keys = set(clustering.trace_counts())
    stats = bp.serve_stats()
    t = time.perf_counter()
    warm = bp.answer_batch(held_out, budget)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t
    if set(clustering.trace_counts()) != keys:
        raise AssertionError("the warm BatchPicker pass ran a new KMeans shape key")
    for q, (est, sel), (west, wsel), exact in zip(held_out, cold, warm, truth, strict=True):
        single = sess.picker.pick(q, budget)
        for got in (sel, wsel):
            np.testing.assert_array_equal(got.ids, single.ids)
            np.testing.assert_array_equal(got.weights, single.weights)
        np.testing.assert_array_equal(est, west)
        np.testing.assert_allclose(est, exact.estimate(sel.ids, sel.weights), rtol=SUM_RTOL,
                                   atol=1e-6, equal_nan=True)
    warm_stats = bp.serve_stats()
    print(f"[batch] BatchPicker.answer_batch of {len(held_out)} held-out queries at budget "
          f"{budget} of {sess.table.num_partitions}: cold {t_cold:.2f} s ({stats['answer_misses']} "
          f"misses in one stacked pass), warm {t_warm:.2f} s; {warm_stats['picks_per_sec']:.2f} "
          f"picks/s over {warm_stats['picks']} picks; KMeans census {stats['shape_buckets']} "
          f"shape keys after the cold pass, {warm_stats['shape_buckets']} after the warm one "
          f"({json.dumps(warm_stats['bucket_traces'], sort_keys=True)})", flush=True)
    print(f"[check] batch: every selection equals the picker's single-query pick (ids and "
          f"weights), warm estimates bit-equal to cold, estimates within {SUM_RTOL} of the "
          f"Session's exact answers; the warm pass ran no new KMeans key", flush=True)


def faults_phase(sess, held_out, truth) -> None:
    """`[faults]`: a grafted route on ``ExecOptions(faults=GATE)``."""
    import numpy as np
    import torch

    from repro_torch.api import QuerySpec
    from repro_torch.faults import FaultPolicy
    from repro_torch.planner import QueryPlanner
    from repro_torch.queries import device
    from repro_torch.queries.engine import AnswerStore

    # fault-free executes on a fresh answer store: the launch keys to hold
    clean = QueryPlanner(sess.picker, AnswerStore(sess.table, options=sess.options),
                         config=sess.planner_config)
    device.TRACES.reset()
    for q in held_out:
        clean.answer(q, error_bound=ERROR_BOUND)
    torch.cuda.synchronize()
    clean_keys = set(device.TRACES.counts())
    t = time.perf_counter()
    # the route shares sess's sketch store: `ExecOptions.faults` gates only
    # the planner's chunk reads and `AnswerStore`'s exact reads
    route = grafted_session(sess, sess.options.replace(faults=FaultPolicy(**GATE)),
                            share_sketches=True)
    torch.cuda.synchronize()
    t_route = time.perf_counter() - t
    device.TRACES.reset()
    planned, walls = [], []
    for q in held_out:
        t = time.perf_counter()
        planned.append(route.execute(QuerySpec(q, error_bound=ERROR_BOUND)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    keys = set(device.TRACES.counts())
    rel = np.array([m["avg_rel_err"] for m in planned_errors(planned, truth)])
    coverage = float((rel <= ERROR_BOUND).mean())
    failed = [a.plan.partitions_failed for a in planned]
    stats = route.stats()
    for a in planned:
        if a.plan.partitions_failed and not a.plan.degraded:
            raise AssertionError("an answer with failed reads was not reported degraded")
        if len(a.plan.failed_ids) != a.plan.partitions_failed:
            raise AssertionError("failed_ids and partitions_failed disagree")
    if stats["degraded_answers"] != sum(a.plan.degraded for a in planned) or \
            stats["partitions_failed"] != sum(failed):
        raise AssertionError(f"session fault counters disagree with the answers: {stats}")
    if sum(failed) == 0:
        raise AssertionError("GATE injected no permanent failure")
    if coverage < 0.9:
        raise AssertionError(f"coverage {coverage} under GATE, below 0.9")
    if not keys <= clean_keys:
        raise AssertionError(f"faulted reads launched new keys {sorted(keys - clean_keys)}")
    read = np.array([a.partitions_read for a in planned], np.float64)
    print(f"[faults] route on FaultPolicy{json.dumps(GATE)}: Session(table) {t_route:.2f} s "
          f"(sharing the Session's sketch store); {len(held_out)} executes at error_bound "
          f"{ERROR_BOUND}: p50 {np.median(walls):.3f} s; partitions read mean {read.mean():.1f}; partitions failed "
          f"{sum(failed)} over {sum(1 for f in failed if f)} answers; degraded "
          f"{stats['degraded_answers']} of {len(planned)}; coverage {coverage:.4f}; mean "
          f"avg_rel_err {rel.mean():.4f}", flush=True)
    print(f"[faults] fault report {json.dumps(stats['fault_report'], sort_keys=True)}",
          flush=True)
    print(f"[check] faults: coverage {coverage:.4f} >= 0.9 with {sum(failed)} failed reads, "
          f"degraded reported exactly; eval launch keys {len(keys)}, within the fault-free "
          f"executes' {len(clean_keys)}", flush=True)


def serve_phase(sess, held_out, fresh) -> None:
    """`[serve]`: a FrontDoor on a VirtualClock over a dead route and the
    card Session, then the real-clock pump thread on ``fresh`` queries
    (no cached answer: their chunk reads launch the eval kernels)."""
    import numpy as np
    import torch

    from repro_torch.api import QuerySpec
    from repro_torch.errors import OverloadError
    from repro_torch.faults import FaultPolicy, VirtualClock
    from repro_torch.kernels import _build
    from repro_torch.serving import FrontDoor, FrontDoorConfig

    specs = [QuerySpec(q, error_bound=ERROR_BOUND) for q in held_out]
    # the service model, from warm executes (`bench_serving_load._calibrate`)
    for spec in specs:
        sess.execute(spec)
    walls, parts = [], []
    for spec in specs:
        t = time.perf_counter()
        ans = sess.execute(spec)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        parts.append(max(1, ans.partitions_read))
    beta = float(np.median(np.asarray(walls) / np.asarray(parts)))
    alpha = max(1e-4, 0.25 * float(np.min(walls)))
    dead = grafted_session(sess, sess.options.replace(
        faults=FaultPolicy(seed=GATE["seed"], dead_frac=1.0, max_attempts=1)),
        share_sketches=True)
    clk = VirtualClock()
    door = FrontDoor(sess, routes=[("faulty", dead), ("card", sess)], clock=clk,
                     service_model=lambda p: alpha + beta * p,
                     config=FrontDoorConfig(max_queue=16, batch_cap=4, tenant_queue_cap=16,
                                            tenant_slots=4, tenant_rate=1e9, tenant_burst=1e9))
    tickets = []
    t = time.perf_counter()
    for spec in specs:  # two tenants, one request each in flight
        tickets += [(spec, door.submit(spec, tenant=f"tenant{k}")) for k in range(2)]
        door.run_until_idle()
    t_loop = time.perf_counter() - t
    loop_ticks = door.ticks
    if not all(tk.done() and tk.error is None for _, tk in tickets):
        raise AssertionError("a closed-loop ticket did not resolve to an answer")
    if door.breakers["faulty"].trips < 1:
        raise AssertionError("the breaker never opened on the faulty route")
    clean = [(spec, tk) for spec, tk in tickets
             if tk.degrade_level == 0 and tk.answer.plan.partitions_failed == 0]
    directs = {}
    for spec, tk in clean:
        if id(spec) not in directs:
            directs[id(spec)] = sess.execute(spec)
        direct = directs[id(spec)]
        np.testing.assert_array_equal(tk.answer.group_keys, direct.group_keys)
        np.testing.assert_array_equal(np.ascontiguousarray(tk.answer.estimate).view(np.uint64),
                                      np.ascontiguousarray(direct.estimate).view(np.uint64))
    loop = door.serve_stats()
    # an overload burst: more than the global queue holds, all at once
    burst, refused = [], []
    for i in range(24):
        try:
            burst.append(door.submit(specs[i % len(specs)], tenant=f"tenant{i % 2}"))
        except OverloadError as e:
            refused.append(e.reason)
            if door.level != door.config.brownout_levels:
                raise AssertionError("shed before the brownout ladder reached its top")
    t = time.perf_counter()
    door.run_until_idle()
    t_burst = time.perf_counter() - t
    st = door.serve_stats()
    if not refused or st["sheds"] != st["sheds_at_max_level"] or \
            st["first_degrade_tick"] > st["first_shed_tick"]:
        raise AssertionError(f"the burst did not degrade before shedding: {st}")
    if not all(tk.done() for tk in burst):
        raise AssertionError("a burst ticket did not resolve")
    if st["eval_compiles"] or st["serve_compiles"]:
        raise AssertionError(f"the door's traffic ran new launch keys: {st}")
    adm = sum(v["admitted"] for v in st["tenants"].values())
    deg = sum(v["degraded"] for v in st["tenants"].values())
    lat = loop["latency"]
    print(f"[serve] FrontDoor on a VirtualClock, service model {alpha:.4f} s + {beta:.6f} s x "
          f"partitions read (warm executes), routes faulty (dead_frac 1.0) then card: "
          f"{len(tickets)} closed-loop requests (2 tenants x {len(specs)}) over "
          f"{loop_ticks} flushes, host wall {t_loop / max(loop_ticks, 1):.3f} s per flush; "
          f"virtual latency p50 {lat['p50']:.4f} s, p99 {lat['p99']:.4f} s (virtual seconds); "
          f"{len(clean)} fault-free answers bit-equal to direct executes of their "
          f"{len(directs)} queries; breaker "
          f"{json.dumps(st['breakers'], sort_keys=True)}", flush=True)
    print(f"[serve] burst of 24: {len(burst)} admitted, {len(refused)} shed "
          f"({sorted(set(refused))}), drained in {t_burst:.2f} s host wall over "
          f"{st['ticks'] - loop_ticks} flushes; first degrade at flush {st['first_degrade_tick']}, "
          f"first shed at {st['first_shed_tick']}; totals admitted {adm}, degraded {deg}, shed "
          f"{st['sheds']}; virtual p50 {st['latency']['p50']:.4f} s p99 "
          f"{st['latency']['p99']:.4f} s; eval_compiles {st['eval_compiles']}, serve_compiles "
          f"{st['serve_compiles']}; healthz {json.dumps(door.healthz(), sort_keys=True)}",
          flush=True)

    # the real-clock pump: the kernels launch from its thread
    pump = FrontDoor(sess, config=FrontDoorConfig(tenant_rate=1e9, tenant_burst=1e9))
    fresh = [QuerySpec(q, error_bound=ERROR_BOUND) for q in fresh]
    results, errors = {}, []

    def client(k):
        try:
            for i in range(k, len(fresh), 2):
                results[i] = pump.submit(fresh[i], tenant=f"thread{k}").result(timeout=600)
        except Exception as e:  # the phase fails below
            errors.append(e)

    def eval_launches():
        counts = _build.LAUNCHES.counts()
        return counts.get(("fused_eval",), 0) + counts.get(("group_aggregate",), 0)

    before = eval_launches()
    t = time.perf_counter()
    pump.start(interval=0.001)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
    finally:
        pump.stop()
    torch.cuda.synchronize()
    launched = eval_launches() - before
    if errors or sorted(results) != list(range(len(fresh))) or any(th.is_alive()
                                                                    for th in threads):
        raise AssertionError(f"the pump did not resolve every ticket: {errors}")
    if launched == 0:
        raise AssertionError("the pump thread launched no eval kernel")
    print(f"[serve] pump thread: {len(fresh)} new queries at error_bound {ERROR_BOUND} from 2 "
          f"submitter threads resolved in {time.perf_counter() - t:.2f} s; fused_eval and "
          f"group_aggregate launched {launched} times from the pump thread", flush=True)
    print(f"[check] serve: every ticket resolved; fault-free answers bit-equal to direct "
          f"executes; the breaker opened on the faulty route; shed only at brownout level "
          f"{door.config.brownout_levels}; no new eval or KMeans key", flush=True)


def relaxed_phase(sess, fit) -> None:
    """`[relaxed]`: phase 6's first trees fitted with ``parity_relaxation``
    on the card, held to the host forest at the reference's tolerances."""
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.core.gbdt import fit_gbdt

    x, y, kw, host = fit["x"], fit["y"], fit["kw"], fit["host"]
    t = time.perf_counter()
    default = fit_gbdt(x, y, options=ExecOptions(), **kw)
    torch.cuda.synchronize()
    t_default = time.perf_counter() - t
    t = time.perf_counter()
    relaxed = fit_gbdt(x, y, options=ExecOptions(), parity_relaxation=True, **kw)
    torch.cuda.synchronize()
    t_relaxed = time.perf_counter() - t
    np.testing.assert_array_equal(default.leaf.view(np.uint32), host.leaf.view(np.uint32))
    np.testing.assert_array_equal(relaxed.feat, host.feat)
    np.testing.assert_array_equal(relaxed.thr, host.thr)
    rtol, atol = RELAXED_RTOL["leaf"]
    np.testing.assert_allclose(relaxed.leaf, host.leaf, rtol=rtol, atol=atol)
    codes = host.binner.transform(x)
    p_relaxed, p_host = relaxed.predict_codes(codes), host.predict_codes(codes)
    rtol, atol = RELAXED_RTOL["pred"]
    np.testing.assert_allclose(p_relaxed, p_host, rtol=rtol, atol=atol)
    same = bool(np.array_equal(relaxed.leaf.view(np.uint32), host.leaf.view(np.uint32)))
    print(f"[relaxed] the first {FOREST_CHECK_TREES} trees of funnel model 0 on "
          f"{x.shape[0]}x{x.shape[1]}: parity_relaxation fit {t_relaxed:.2f} s vs default device "
          f"fit {t_default:.2f} s (host fit {fit['host_s']:.2f} s in phase 6); feat and thr "
          f"equal, leaves max abs diff {float(np.abs(relaxed.leaf - host.leaf).max()):.3g} "
          f"(bit-equal: {same}), predictions max abs diff "
          f"{float(np.abs(p_relaxed - p_host).max()):.3g}", flush=True)
    print(f"[check] relaxed: within leaves rtol {RELAXED_RTOL['leaf'][0]:g} atol "
          f"{RELAXED_RTOL['leaf'][1]:g} and predictions rtol {RELAXED_RTOL['pred'][0]:g} atol "
          f"{RELAXED_RTOL['pred'][1]:g} of the host forest", flush=True)


def serve_path(sess, held_out, fit, args) -> dict:
    """Phase 8 on the grown table → its launches."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.queries.generator import WorkloadSpec

    truth = sess.answers.get_batch(held_out)
    fresh = WorkloadSpec(sess.table, seed=args.seed + 2).sample_workload(4)
    _build.LAUNCHES.reset()
    t = time.perf_counter()
    batch_phase(sess, held_out, truth)
    faults_phase(sess, held_out, truth)
    serve_phase(sess, held_out[:SERVE_QUERIES], fresh)
    relaxed_phase(sess, fit)
    torch.cuda.synchronize()
    launches = launches_of(SERVE_KERNELS)
    print(f"[serve] the serving phase took {time.perf_counter() - t:.2f} s; launches "
          f"{json.dumps(launches, sort_keys=True)}", flush=True)
    return launches


# --------------------------------------------------------------------------
# phase 10: the lifecycle path on the prepared Session
# --------------------------------------------------------------------------
LIFECYCLE_KERNELS = ("fused_eval", "moments", "histogram_range", "bincount")
DELETE_FRAC = 0.05  # soft-deleted share of the live partitions
CRASH_DELETES = 8  # partitions of the delete that crashes at ``wal.apply``
SHARDS = 4
NEW_QUERIES = 8  # full-stack answers over the rewritten stack


@contextlib.contextmanager
def timing(owner, name: str, sink: list):
    """Wrap ``owner.name`` (a method of a class or an instance) so each
    call appends its wall seconds, the card synchronized, to ``sink``."""
    import torch

    saved = vars(owner).get(name)
    fn = getattr(owner, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t)

    setattr(owner, name, timed)
    try:
        yield sink
    finally:
        if saved is None:
            delattr(owner, name)
        else:
            setattr(owner, name, saved)


def fold(sess) -> tuple[float, float, float]:
    """Fold the table's pending events into the Session's stores →
    (sketches, eval cache incl. any stack rewrite, answers + views) s.
    Every cached full answer is brought current (after an append, one
    delta evaluation), as the streaming phase does."""
    import torch

    t0 = time.perf_counter()
    sess.sketches.sketches()
    t1 = time.perf_counter()
    sess.answers._eval_cache._sync()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sess.answers.get_batch([a.query for a in sess.answers._cache.values()])
    sess.views.refresh()
    torch.cuda.synchronize()
    return t1 - t0, t2 - t1, time.perf_counter() - t2


def run_executes(sess, held_out) -> tuple[list, list]:
    """The held-out queries at the error bound → (answers, wall seconds)."""
    import torch

    from repro_torch.api import QuerySpec

    planned, walls = [], []
    for q in held_out:
        t = time.perf_counter()
        planned.append(sess.execute(QuerySpec(q, error_bound=ERROR_BOUND)))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return planned, walls


def coverage_of(planned, truth) -> tuple[float, float]:
    import numpy as np

    rel = np.array([m["avg_rel_err"] for m in planned_errors(planned, truth)])
    return float((rel <= ERROR_BOUND).mean()), float(rel.mean())


def check_same_planned(got, want, what: str) -> None:
    """Estimates, group keys, CI halfwidths and partitions read, byte for byte."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for field in ("group_keys", "estimate", "ci_halfwidth"):
            if getattr(g, field).tobytes() != getattr(w, field).tobytes():
                raise AssertionError(f"{what}: query {i} {field} differs")
        if g.partitions_read != w.partitions_read:
            raise AssertionError(f"{what}: query {i} read {g.partitions_read} partitions, "
                                 f"not {w.partitions_read}")


def cold_oracle(sess):
    """A from-scratch planner on a deep copy of the Session's physical
    table, tombstones and directory: fresh sketch store, answer store,
    views and planner, with the Session's funnel and cluster mask."""
    import copy

    from repro_torch.core.features import FeatureBuilder
    from repro_torch.core.picker import PS3Picker
    from repro_torch.core.sketches import SketchStore
    from repro_torch.planner import QueryPlanner, ViewStore
    from repro_torch.queries.engine import AnswerStore

    t = copy.deepcopy(sess.table)
    store = SketchStore(t, options=sess.options)
    p = sess.picker
    picker = PS3Picker(t, FeatureBuilder(t, store.sketches()), p.funnel, p.cluster_mask,
                       p.config, options=sess.options)
    answers = AnswerStore(t, options=sess.options)
    views = ViewStore(t, options=sess.options)
    for v in sess.views._views:
        views.register(v.groupby, v.aggregates)
    return store, answers, QueryPlanner(picker, answers, views=views,
                                        config=sess.planner_config)


def lifecycle_ops(sess, log, held_out, known, args) -> list:
    """`[lifecycle]`: a delete of ``DELETE_FRAC`` of the live partitions,
    a compaction, a rebalance and an append, each through the WAL, folded
    and followed by the held-out executes → the last executes.  They may
    launch no eval key outside ``known`` (the streaming appends' keys and
    those launched since the last reset)."""
    import numpy as np
    import torch

    from repro_torch import lifecycle
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.table import Table
    from repro_torch.queries import device
    from repro_torch.queries.engine import per_partition_answers_batch

    table, cache = sess.table, sess.answers._eval_cache
    rng = np.random.default_rng(args.seed)
    live_ext = table.ext_ids[table.live_mask()]
    victims = rng.choice(live_ext, size=int(round(DELETE_FRAC * live_ext.size)), replace=False)
    delta = make_dataset("tpch", num_partitions=append_size(args.partitions),
                         rows_per_partition=table.rows_per_partition, layout="random",
                         seed=100 + APPENDS)
    ops = (
        ("delete", lambda: log.delete(table, victims)),
        ("compact", lambda: log.compact(table)),
        ("rebalance", lambda: log.rebalance(table, lifecycle.rebalance_plan(table, SHARDS))),
        ("append", lambda: log.append(table, dict(delta.columns))),
    )
    planned, new_keys = None, set()
    known = set(known) | set(device.TRACES.counts())
    for name, op in ops:
        queries = held_out if name == "delete" else held_out[:LIFECYCLE_QUERIES]
        keys = frozenset(device.TRACES.counts())
        p0 = table.num_partitions
        t = time.perf_counter()
        op()
        t_op = time.perf_counter() - t
        rewrites = []
        with timing(cache, "_rewrite_stack", rewrites):
            t_sk, t_cache, t_ans = fold(sess)
        reads, read = [], sess.planner._read

        def record(query, new_ids, *a, **k):
            reads.append(np.asarray(new_ids))
            return read(query, new_ids, *a, **k)

        sess.planner._read = record
        try:
            planned, walls = run_executes(sess, queries)
        finally:
            del sess.planner._read
        new_keys |= frozenset(device.TRACES.counts()) - keys
        if name == "delete":
            dead = np.array(sorted(table.tombstones), np.int64)
            if any(np.isin(ids, dead).any() for ids in reads):
                raise AssertionError("an execute read a tombstoned partition")
            live = table.live_mask()
            truth_table = Table(table.schema, {k: v[live] for k, v in table.columns.items()},
                                name=f"{table.name}/live")
            truth = per_partition_answers_batch(truth_table, queries, options=sess.options)
            what = f"against the exact answers over the {truth_table.num_partitions} live"
        else:
            truth = sess.answers.get_batch(queries)
            what = f"against the exact answers over all {table.num_partitions}"
        torch.cuda.synchronize()
        cov, mean_err = coverage_of(planned, truth)
        if name == "delete" and cov < 0.9:
            raise AssertionError(f"coverage {cov} over the live partitions is under 0.9 "
                                 "(bench_lifecycle's gate)")
        read_n = np.array([a.partitions_read for a in planned], np.float64)
        rewrite = f", _rewrite_stack {rewrites[0]:.3f} s" if rewrites else ""
        print(f"[lifecycle] {name} through the WAL: {p0} -> {table.num_partitions} partitions "
              f"({table.num_live} live) in {t_op:.3f} s; fold: sketches {t_sk:.3f} s, eval "
              f"cache {t_cache:.3f} s{rewrite}, answers and views {t_ans:.3f} s; "
              f"{len(queries)} executes p50 {np.median(walls):.3f} s, partitions read mean "
              f"{read_n.mean():.1f}; coverage {cov:.4f}, mean avg_rel_err {mean_err:.4f} {what} "
              f"partitions", flush=True)
    if new_keys - known:
        raise AssertionError(f"the lifecycle ops added launch keys: {sorted(new_keys - known)}")
    return planned


def lifecycle_checks(sess, planned, held_out, before, args) -> None:
    """`[lifecycle]` against a cold oracle on a deep copy of the table."""
    import torch

    from repro_torch.queries.engine import EvalCache, per_partition_answers_batch
    from repro_torch.queries.generator import WorkloadSpec

    cache = sess.answers._eval_cache
    t = time.perf_counter()
    store, answers, planner = cold_oracle(sess)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t
    check_sketches_bits(sess.sketches.sketches(), store.sketches())
    queries = [a.query for a in sess.answers._cache.values()]
    t = time.perf_counter()
    cold = answers.get_batch(queries)
    torch.cuda.synchronize()
    t_answers = time.perf_counter() - t
    check_answers_bits(sess.answers.get_batch(queries), cold)
    t = time.perf_counter()
    oracle = [planner.answer(q, error_bound=ERROR_BOUND) for q in held_out]
    t_plan = time.perf_counter() - t
    check_same_planned(planned, oracle, "live executes against the cold oracle's")
    stats = sess.stats()
    if stats["sketch_full_rebuilds"] != before["full"]:
        raise AssertionError("a lifecycle fold rebuilt the sketches in full")
    if stats["stack_rewrites"] != before["rewrites"] + 2:
        raise AssertionError(f"{stats['stack_rewrites'] - before['rewrites']} stack rewrites, "
                             "expected 2")
    bucket = cache.device_stack().shape[1]
    if bucket != before["bucket"] or cache.stack_rebuilds != before["rebuilds"]:
        raise AssertionError(f"the stack left its {before['bucket']}-slot bucket")
    fresh = WorkloadSpec(sess.table, seed=args.seed + 3).sample_workload(NEW_QUERIES)
    t = time.perf_counter()
    got = per_partition_answers_batch(sess.table, fresh, cache=cache, options=sess.options)
    torch.cuda.synchronize()
    t_live = time.perf_counter() - t
    want = per_partition_answers_batch(sess.table, fresh, options=sess.options,
                                       cache=EvalCache(sess.table, options=sess.options))
    check_answers_bits(got, want)
    print(f"[lifecycle] cold oracle on a copy of the table: stores and planner {t_build:.2f} s, "
          f"{len(queries)} answers {t_answers:.2f} s, {len(held_out)} planner answers "
          f"{t_plan:.2f} s", flush=True)
    print(f"[check] lifecycle: sketches (every field) and {len(queries)} cached answers "
          f"bit-equal to the cold oracle's; {len(held_out)} executes equal in estimates, group "
          f"keys, CI halfwidths and partitions read; sketch full rebuilds unmoved "
          f"({stats['sketch_full_rebuilds']}), stack rewrites "
          f"{stats['stack_rewrites'] - before['rewrites']}, stack in its {bucket}-slot bucket, "
          f"no eval launch key beyond the streaming appends'; {NEW_QUERIES} new queries over "
          f"the rewritten stack "
          f"({t_live:.2f} s) bit-equal to a cold EvalCache's", flush=True)


def wal_checks(sess, log, root, held_out, args) -> None:
    """`[wal]`: a delete that crashes at ``wal.apply``, `wal.recover` of the
    directory and `replay` on the live table; the two must agree."""
    import numpy as np

    from repro_torch import api, wal
    from repro_torch.errors import InjectedCrash
    from repro_torch.faults import FaultInjector, FaultPolicy

    table = sess.table
    rng = np.random.default_rng(args.seed + 1)
    victims = rng.choice(table.ext_ids[table.live_mask()], size=CRASH_DELETES, replace=False)
    crashing = wal.WriteAheadLog(log.directory, injector=FaultInjector(
        FaultPolicy(seed=args.seed).with_crash("wal.apply")))
    try:
        crashing.delete(table, victims)
    except InjectedCrash as e:
        if e.point != "wal.apply":
            raise
    else:
        raise AssertionError("the delete did not crash at wal.apply")
    records = log._record_ids()
    if len(records) != 5 or table.tombstones:
        raise AssertionError(f"records {records}, tombstones {sorted(table.tombstones)}")
    builds, replays = [], []
    t = time.perf_counter()
    with timing(api.SketchStore, "__init__", builds), \
            timing(wal.WriteAheadLog, "replay", replays):
        rec = wal.recover(root)
    t_recover = time.perf_counter() - t
    t = time.perf_counter()
    if wal.WriteAheadLog(log.directory).replay(table) != 1:
        raise AssertionError("the live replay did not apply the crashed delete")
    t_live = time.perf_counter() - t
    a, b = rec.table, table
    if (a.version, a.tombstones, a.next_ext, a.lifecycle_log) != (
            b.version, b.tombstones, b.next_ext, b.lifecycle_log) or \
            a.ext_ids.tobytes() != b.ext_ids.tobytes():
        raise AssertionError("the recovered table's lifecycle state differs")
    for k, v in b.columns.items():
        if v.tobytes() != a.columns[k].tobytes():
            raise AssertionError(f"the recovered column {k} differs")
    t = time.perf_counter()
    rec_sk = rec.sketches.sketches()
    t_rebuild = time.perf_counter() - t
    check_sketches_bits(rec_sk, sess.sketches.sketches())
    # the replayed chain moves an append, so the recovered answer store
    # dropped its entries (events_foldable); a planner read slices a
    # cached full answer (every occupied group of the table) where it
    # would evaluate a chunk (the chunk's groups), so warm the held-out
    # answers first and both Sessions answer from full entries
    t = time.perf_counter()
    check_answers_bits(rec.answers.get_batch(held_out), sess.answers.get_batch(held_out))
    t_warm = time.perf_counter() - t
    got, walls = run_executes(rec, held_out)
    want, _ = run_executes(sess, held_out)
    check_same_planned(got, want, "recovered executes against the live Session's")
    print(f"[wal] crash at wal.apply with the delete of {CRASH_DELETES} durable; wal.recover "
          f"{t_recover:.2f} s: restore {t_recover - replays[0]:.2f} s (its Session(table) "
          f"sketch build {builds[0]:.2f} s), replay of {len(records)} records "
          f"{replays[0]:.3f} s; live replay {t_live:.3f} s; {len(held_out)} answers warmed on "
          f"the recovered Session {t_warm:.2f} s, then {len(held_out)} executes p50 "
          f"{np.median(walls):.3f} s; its sketches rebuilt in full in {t_rebuild:.2f} s "
          f"(full rebuilds {rec.stats()['sketch_full_rebuilds']}: the replayed chain moves an "
          f"append, which events_foldable refuses)", flush=True)
    print(f"[check] wal: recovered and live tables equal in bytes, tombstones "
          f"({len(a.tombstones)}), ext_ids, next_ext and lifecycle_log; sketches and "
          f"{len(held_out)} answers bit-equal; {len(held_out)} executes byte-equal", flush=True)


def lifecycle_path(sess, held_out, stream_keys, args) -> dict:
    """Phase 9 on the grown table → its launches."""
    import shutil
    import tempfile

    import torch

    from repro_torch import lifecycle, wal
    from repro_torch.kernels import _build

    cache = sess.answers._eval_cache
    root = tempfile.mkdtemp(prefix="chip_smoke_lifecycle_")
    _build.LAUNCHES.reset()
    t_phase = time.perf_counter()
    try:
        lifecycle.ensure_directory(sess.table)
        snap = os.path.join(root, "snapshot")
        t = time.perf_counter()
        sess.save(snap)
        t_save = time.perf_counter() - t
        sizes = {name: os.path.getsize(os.path.join(snap, name))
                 for name in sorted(os.listdir(snap))}
        print(f"[lifecycle] Session.save {t_save:.2f} s, {sum(sizes.values())} bytes "
              f"{json.dumps(sizes)} ({len(sess.answers._cache)} full and "
              f"{len(sess.answers._partial)} partial answers cached)", flush=True)
        log = wal.WriteAheadLog(os.path.join(root, "wal"))
        before = dict(full=sess.sketches.full_rebuilds, rewrites=cache.stack_rewrites,
                      rebuilds=cache.stack_rebuilds, bucket=cache.device_stack().shape[1])
        planned = lifecycle_ops(sess, log, held_out, stream_keys, args)
        lifecycle_checks(sess, planned, held_out[:LIFECYCLE_QUERIES], before, args)
        wal_checks(sess, log, root, held_out[:LIFECYCLE_QUERIES], args)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    launches = launches_of(LIFECYCLE_KERNELS + (
        ("group_aggregate",) if any(not a.query.predicate.groups
                                    for a in sess.answers._cache.values()) else ()))
    print(f"[lifecycle] the lifecycle phase took {time.perf_counter() - t_phase:.2f} s; "
          f"launches {json.dumps(launches, sort_keys=True)}", flush=True)
    return launches


# --------------------------------------------------------------------------
# phase 11: the LM substrate's serving path, and launch/serve.py --aqp
# --------------------------------------------------------------------------
# the serve default (MHA, tied head); GQA, untied head; the hybrid at full
# depth (38 layers, a ragged tail: RG-LRU blocks beside local MQA
# attention); the SSM whole (SSD blocks, tied head); the encoder-decoder
# whole (12 encoder layers over 1,500 frames, cross-attention); the VLM
# at full depth (48 layers after a 256-token image prefix)
LM_ARCHS = ("qwen1.5-0.5b", "yi-6b", "recurrentgemma-9b", "mamba2-130m", "whisper-small",
            "internvl2-26b")
LM_BATCH, LM_PROMPT, LM_GEN = 4, 32, 16
LM_FLAGS = ("--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN))
# the VLM's cache holds its image positions before the prompt: serve.main's
# default (prompt + gen + 8) refuses it
LM_MAX_LEN = {"internvl2-26b": 256 + LM_PROMPT + LM_GEN + 8}
LM_TOL = dict(rtol=5e-2, atol=5e-2)  # the reference's decode-vs-forward tolerance
# ... and its hybrid atol: the recurrence accumulates bf16 gate noise
# across layers (`tests/test_arch_smoke.py`)
HYBRID_TOL = dict(rtol=5e-2, atol=0.15)
# At full width the reference's own two lowerings leave a few logits in
# ten thousand outside LM_TOL (qwen1.5-0.5b: up to 261 of 607,744, its
# prefill or decode against its forward; `tools/lm_lowering_gap.py`), so a
# share of one in a thousand may lie outside; the correlation rule holds
LM_OUTSIDE = 1e-3
LM_CUT = dict(layers=2, prompt=16, steps=2)  # the card-vs-CPU check, batch 1
# ... on the hybrid's first whole unit: two RG-LRU blocks and the attention
LM_CUT_LAYERS = {"recurrentgemma-9b": 3}
# Check (a) runs on the model cast to f32 for these families, fed the
# served tokens: at full width on random weights, bf16 rounding noise
# grows through their recurrent states step after step (the bf16 decode
# leaves 30% of the logits outside the tolerance at the 16th step, and
# the reference's own jitted prefill and forward of mamba2-130m already
# disagree on 45% at the prompt's last position: ROADMAP.md § 3); in f32
# the two paths agree to 1e-3 or better.  The bf16 gap is printed beside
# it.
F32_CHECK = ("hybrid", "ssm")
# ... and on the first layers of these archs, whose f32 copy does not fit
# beside the bf16 model (internvl2-26b whole in f32: 79 GB): at full
# depth its bf16 decode leaves more than LM_OUTSIDE of a step's logits
# outside LM_TOL, a share that grows with depth, where the reference's
# own lowerings leave as many as the port's on the cuts it can run on the
# CPU (`tools/lm_depth_gap.py`, ROADMAP.md § 3); in f32 the two paths
# agree.  The bf16 gap at full depth is printed, and held to the
# correlation rule
F32_LAYERS = {"internvl2-26b": 16}
# the MoE family at full width: the layers served (deepseek: its dense
# lead and 4 MoE layers), as many as fit one card with room to spare
MOE_LAYERS = {"mixtral-8x22b": 8, "deepseek-v2-236b": 5}
AQP_KERNELS = ("fused_eval", "group_aggregate", "moments", "histogram_range", "bincount",
               "tree_hist", "cumsum_seq")


def lm_tol(cfg) -> dict:
    return HYBRID_TOL if cfg.family == "hybrid" else LM_TOL


def cut_layers(cfg) -> int:
    """The layers of check (b) for ``cfg``'s arch."""
    return LM_CUT_LAYERS.get(cfg.name, LM_CUT["layers"])


def decode_bound(model, batch: int) -> tuple[dict, int, float]:
    """(bytes by part, their sum, ms): what a decode step of ``batch``
    tokens must read, over ``HBM_BYTES_PER_S``.  ``weights``: every weight
    but the embedding table, whose B rows it gathers, unless the table is
    the tied head, and but what only the prefill reads (whisper's encoder
    and its cross-attentions' ``wk``/``wv``); every MoE expert and a ragged
    tail's padded slot count: the step runs them.  ``cross_kv``: whisper's
    cross-attention K/V over the frames, read whole by every decoder
    layer."""
    from repro_torch.models import lm

    cfg = model.cfg
    prefill_only = [] if cfg.tie_embeddings else [model.embed.table]
    parts = {}
    if model.encoder is not None:
        prefill_only += [*model.encoder.parameters(), *(
            p for xp in model.cross for name, p in xp.attn.named_parameters()
            if name in ("wk", "wv", "bk", "bv"))]
        parts["cross_kv"] = (2 * cfg.n_layers * batch * cfg.enc_positions * cfg.n_kv_heads
                             * cfg.d_head * 2)
    parts = {"weights": lm.param_bytes(model) - sum(p.numel() * p.element_size()
                                                     for p in prefill_only), **parts}
    nbytes = sum(parts.values())
    return parts, nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def gap_of(want, got, tol) -> tuple[float, int, float, float]:
    """numpy's ``assert_allclose`` rule at ``tol`` (``|got - want| ≤ atol +
    rtol·|want|``; NaN fails) → (max_abs_err, logits outside, their share,
    correlation)."""
    import torch

    a, b = want.float().cpu(), got.float().cpu()
    err = (a - b).abs()
    outside = int((~(err <= tol["atol"] + tol["rtol"] * a.abs())).sum())
    corr = float(torch.corrcoef(torch.stack([a.ravel(), b.ravel()]))[0, 1])
    return float(err.max()), outside, outside / a.numel(), corr


def check_logits(what: str, want, got, tol=LM_TOL) -> tuple[float, int, float, float]:
    """`gap_of`, which must leave at most a share ``LM_OUTSIDE`` of the
    logits outside ``tol`` and a correlation above 0.999
    (`tests/test_arch_smoke.py`); raises."""
    gap = gap_of(want, got, tol)
    if gap[2] > LM_OUTSIDE or not gap[3] > 0.999:
        raise AssertionError(f"{what}: {gap[1]} of {want.numel()} logits outside rtol "
                             f"{tol['rtol']} atol {tol['atol']}, correlation {gap[3]}")
    return gap


def summary(checks: list) -> str:
    return (f"max_abs_err {max(c[0] for c in checks):.4g}, {sum(c[1] for c in checks)} logits "
            f"outside (at most {max(c[2] for c in checks):.4%} of one position's), min "
            f"correlation {min(c[3] for c in checks):.6f}")


def cut_model(model, n_layers: int, device):
    """``model``'s embedding, first ``n_layers`` layers (its leading dense
    layers, then blocks from 0; whisper's cross-attentions with them and as
    many encoder layers, its positions and norm), final norm and head,
    copied onto ``device``."""
    from repro_torch.models import lm

    cfg = model.cfg
    cut = lm.LM(dataclasses.replace(cfg, n_layers=n_layers,
                                    n_enc_layers=min(cfg.n_enc_layers, n_layers)), device=device)
    kept = {"blocks": len(cut.blocks), "encoder.layers": cut.cfg.n_enc_layers,
            "cross": len(cut.cross)}

    def keep(name: str) -> bool:
        for prefix, n in kept.items():
            if name.startswith(prefix + "."):
                return int(name[len(prefix) + 1:].split(".")[0]) < n
        return True

    cut.load_state_dict({k: v for k, v in model.state_dict().items() if keep(k)})
    return cut


@contextlib.contextmanager
def moe_probe(calls: list, route: bool = False, force=None):
    """Records every `moe.moe_apply` call as a dict in ``calls``: its
    ``drop_frac`` (a device tensor, read after the run) and, with
    ``route``, its tokens' expert ids ``idx`` (T, k), f32 router
    ``logits`` (T, E) and largest k + 1 probabilities ``top``.  With
    ``force``, expert ids (T, k) a call in call order, `moe.route` picks
    those experts (its own probabilities gathered at them and
    renormalised, as `moe.route` renormalises its top k): the run repeats
    another run's routing decisions.  `lm` looks both functions up in
    `moe` at each call; nothing else changes."""
    from unittest import mock

    import torch

    from repro_torch.models import moe

    real_route, real_apply = moe.route, moe.moe_apply
    forced = None if force is None else iter(force)

    def routed(p, xt, cfg):
        logits, probs, gates, idx = real_route(p, xt, cfg)
        if forced is not None:
            idx = next(forced).to(idx.device)
            gates = torch.gather(probs, 1, idx)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        calls.append({"idx": idx, "logits": logits,
                      "top": probs.topk(cfg.top_k + 1, dim=-1).values})
        return logits, probs, gates, idx

    def applied(p, x, cfg):
        if not route:
            calls.append({})
        y, aux = real_apply(p, x, cfg)
        calls[-1]["drop_frac"] = aux["drop_frac"]
        return y, aux

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(moe, "moe_apply", applied))
        if route or forced is not None:
            stack.enter_context(mock.patch.object(moe, "route", routed))
        yield calls


def per_layer(calls: list, key: str, layers: int, b: int) -> list:
    """`moe_probe` records of a prefill or forward of (b, S) tokens through
    ``layers`` MoE layers, then one call a layer for each decode step →
    each layer's ``key`` as a (b, S + steps, ...) CPU tensor."""
    import torch

    first = [c[key].cpu().reshape(b, -1, c[key].shape[-1]) for c in calls[:layers]]
    steps = calls[layers:]
    return [torch.cat([first[j]] + [c[key].cpu()[:, None] for c in steps[j::layers]], dim=1)
            for j in range(layers)]


def serve_order(calls: list, layers: int, b: int, p: int) -> list:
    """A forward's expert ids (one call a layer over (b, S) tokens) in the
    call order of a prefill of its first ``p`` positions and a decode step
    for each later one: the ``force`` of `moe_probe`."""
    full = per_layer(calls, "idx", layers, b)
    out = [x[:, :p].reshape(b * p, -1) for x in full]
    for pos in range(p, full[0].shape[1] if layers else p):
        out += [x[:, pos] for x in full]
    return out


def routed_apart(want: list, got: list, layers: int, b: int, top_k: int):
    """Two runs' `moe_probe` routing (as `per_layer` reads it) → (each row's
    first position routed to another expert set (`sys.maxsize` where
    none), the flips as (layer, row, position, the k-th and (k+1)-th
    probabilities of ``want``)).  A flip in a later layer at a row's first
    position or after it is its consequence.  Raises unless, at each
    flip, the two runs' router logits agree at ``LM_TOL``: the router saw
    the same token up to the rounding that the model's logits are
    allowed, and only its decision at a near tie differs."""
    import numpy as np

    w_idx, g_idx = (per_layer(c, "idx", layers, b) for c in (want, got))
    w_logits, g_logits = (per_layer(c, "logits", layers, b) for c in (want, got))
    w_top = per_layer(want, "top", layers, b)
    first, flips = np.full(b, sys.maxsize), []
    for j in range(layers):
        apart = (w_idx[j].sort(dim=-1).values != g_idx[j].sort(dim=-1).values).any(dim=-1)
        for row, pos in zip(*np.nonzero(apart.numpy())):
            if pos < first[row]:
                kth, nxt = (float(v) for v in w_top[j][row, pos, top_k - 1:top_k + 1])
                a, g = w_logits[j][row, pos], g_logits[j][row, pos]
                if not bool(((a - g).abs() <= LM_TOL["atol"] + LM_TOL["rtol"] * a.abs()).all()):
                    raise AssertionError(f"layer {j} row {row} position {pos}: routed to other "
                                         f"experts (probabilities {kth} and {nxt}) from router "
                                         f"logits {a.tolist()} against {g.tolist()}")
                first[row] = pos
                flips.append((j, int(row), int(pos), kth, nxt))
    return first, flips


def run_fed(cfg, model, prompt, max_len: int, steps: int, fed=None, force=None, extras=None):
    """`lm.prefill` of ``prompt`` with ``extras`` (``img_embeds`` or
    ``enc_frames``), then ``steps`` `lm.decode_step`s fed ``fed`` ((B, 1)
    tokens a step; the greedy ones where None) from the position after the
    image prefix and the prompt, under `moe_probe` (``force``: its
    routing) → (the prefill's logits and each step's, the tokens fed, the
    probe's records)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm

    fed = [] if fed is None else list(fed)
    pos0 = serve.prefix_len(cfg) + prompt.shape[1]
    with torch.inference_mode(), moe_probe([], route=True, force=force) as calls:
        logits, cache = lm.prefill(cfg, model, prompt, max_len, **(extras or {}))
        seen = [logits]
        for i in range(steps):
            if i == len(fed):
                fed.append(torch.argmax(seen[-1][:, -1:], dim=-1))
            step, cache = lm.decode_step(cfg, model, cache, fed[i].to(prompt.device), pos0 + i)
            seen.append(step)
    return seen, fed, calls


def lm_card_vs_cpu(model, prompts, extras=None) -> str:
    """(b): the first `cut_layers` layers on the CPU and on the card,
    batch 1, at the arch's `lm_tol`: the prefill's logits at every prompt
    position (a VLM's whole image prefix too) and ``LM_CUT["steps"]``
    decode steps fed the CPU's greedy tokens.  An MoE
    model's routing is compared token by token (`routed_apart`), and its
    logits on a second card run that takes the CPU's routing decisions
    (`moe_probe`'s ``force``), with each call's ``drop_frac``."""
    from repro_torch.launch import serve

    prompt = prompts[:1, :LM_CUT["prompt"]]
    extras = {k: v[:1] for k, v in (extras or {}).items()}
    max_len = serve.prefix_len(model.cfg) + LM_CUT["prompt"] + LM_CUT["steps"]
    n_layers = cut_layers(model.cfg)
    t = time.perf_counter()
    cut = cut_model(model, n_layers, "cpu")
    want, fed, cpu_calls = run_fed(cut.cfg, cut, prompt.cpu(), max_len, LM_CUT["steps"],
                                   extras={k: v.cpu() for k, v in extras.items()})
    n_moe = sum(blk.kind == "moe" for blk in cut.blocks)
    t_cpu = time.perf_counter() - t
    t = time.perf_counter()
    cut = cut_model(model, n_layers, prompts.device)
    got, _, card_calls = run_fed(cut.cfg, cut, prompt, max_len, LM_CUT["steps"], fed,
                                 extras=extras)
    first, flips = routed_apart(cpu_calls, card_calls, n_moe, 1, model.cfg.top_k)
    if n_moe:
        got, _, card_calls = run_fed(cut.cfg, cut, prompt, max_len, LM_CUT["steps"], fed,
                                     force=[c["idx"] for c in cpu_calls])
    t_card = time.perf_counter() - t
    del cut
    # f32 means of the keep masks: equal counts agree to 1e-6 (a count
    # apart would be 1/(T·k) ≥ 1e-4 apart)
    drops = [[float(c["drop_frac"]) for c in calls] for calls in (card_calls, cpu_calls)]
    if any(abs(a - b) > 1e-6 for a, b in zip(*drops)):
        raise AssertionError(f"card vs CPU: drop_frac {drops[0]} against {drops[1]}")
    checks = [check_logits(f"card vs CPU, output {i}", w, g.cpu(), lm_tol(model.cfg))
              for i, (g, w) in enumerate(zip(got, want))]
    moe_text = (f"; {n_moe} MoE layers, drop_frac {drops[0]}, routed apart: {flips or 'none'}"
                f" (the logits on the CPU's routing)" if n_moe else "")
    return f"{summary(checks)}{moe_text}; CPU {t_cpu:.2f} s, card {t_card:.2f} s"


def lm_serve(arch: str, card: str) -> None:
    """``[lm]``: `launch/serve.main` at full width on the card, a warm
    rerun of its loop, then checks (a) and (b)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import lm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # what the earlier phases still hold
    t = time.perf_counter()
    run = serve.main(["--arch", arch, *LM_FLAGS, *(
        ("--max-len", str(LM_MAX_LEN[arch])) if arch in LM_MAX_LEN else ())])
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    cfg, model, s = run.cfg, run.model, run.served
    tol = lm_tol(cfg)
    b, p = run.prompts.shape
    gen = len(s.step_logits)
    warm = serve.serve_loop(cfg, model, run.prompts, gen, run.max_len, run.extras)
    if not (warm.tokens == s.tokens).all():
        raise AssertionError(f"{cfg.name}: a second run of the loop gave other tokens")
    parts, nbytes, bound_ms = decode_bound(model, b)
    step_ms = [x.decode_s / gen * 1e3 for x in (s, warm)]
    MEASURED_MS[f"{cfg.name} decode"] = step_ms[1]
    enc = (f"{cfg.n_enc_layers} encoder layers over {cfg.enc_positions} frames, "
           if cfg.family == "encdec" else "")
    extras = "".join(f", {k} {tuple(v.shape)}" for k, v in run.extras.items())
    print(f"[lm] {cfg.name} ({cfg.family}, blocks {'/'.join(cfg.block_pattern)}, {enc}"
          f"{cfg.n_layers} layers in {len(model.blocks)} blocks, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} kv heads, window {cfg.window}, vocab "
          f"{cfg.vocab}, {'tied' if cfg.tie_embeddings else 'untied'} head), batch {b}, prompt "
          f"{p}{extras}, cache {run.max_len}, gen {gen}: prefill {s.prefill_s * 1e3:.2f} ms, "
          f"decode {s.decode_s * 1e3:.2f} ms ({step_ms[0]:.2f} ms a step against a "
          f"{bound_ms:.4f} ms bound: {nbytes} bytes read a step "
          f"({', '.join(f'{k} {v}' for k, v in parts.items())}) at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; {b * gen / s.decode_s:.1f} tokens/s); warm "
          f"rerun prefill {warm.prefill_s * 1e3:.2f} ms, decode {warm.decode_s * 1e3:.2f} ms "
          f"({step_ms[1]:.2f} ms a step, {b * gen / warm.decode_s:.1f} tokens/s); parameters "
          f"{lm.param_bytes(model)} bytes; max_memory_allocated {peak - before} bytes above the "
          f"{before} the earlier phases hold; main() {wall:.2f} s; card {card}", flush=True)

    t = time.perf_counter()
    card_vs_cpu = lm_card_vs_cpu(model, run.prompts, run.extras)
    fed = [torch.as_tensor(s.tokens[:, i:i + 1], device=run.prompts.device) for i in range(gen)]
    seq = torch.cat([run.prompts] + fed, dim=1)
    outs = [s.prefill_logits[:, -1]] + [step[:, 0] for step in s.step_logits]
    gap, f32 = "", cfg.family in F32_CHECK or cfg.name in F32_LAYERS
    checked = model
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode())
        if f32:  # the bf16 run's own gap, printed; the check is on the f32 model
            full, _ = lm.forward(cfg, model, seq, **run.extras)
            gaps = [gap_of(full[:, p - 1 + i], got, tol) for i, got in enumerate(outs)]
            corr = min(g[3] for g in gaps)
            if cfg.name in F32_LAYERS and not corr > 0.999:
                raise AssertionError(f"{cfg.name}: the bf16 decode's correlation with the "
                                     f"forward is {corr}")
            gap = (f"; the bf16 decode against the bf16 forward at full depth (printed"
                   f"{', correlation checked' if cfg.name in F32_LAYERS else ', not checked'}): "
                   f"shares outside {[round(g[2], 6) for g in gaps]} by position, correlation "
                   f"at least {corr:.6f}")
            del full
            if cfg.name in F32_LAYERS:
                checked = cut_model(model, F32_LAYERS[cfg.name], run.prompts.device)
            checked.float()
            stack.enter_context(mock.patch.object(lm, "DTYPE", torch.float32))
            seen, _, _ = run_fed(checked.cfg, checked, run.prompts, run.max_len, gen, fed,
                                 extras=run.extras)
            outs = [seen[0][:, -1]] + [step[:, 0] for step in seen[1:]]
        full, _ = lm.forward(checked.cfg, checked, seq, **run.extras)
        checks = [check_logits(f"{cfg.name} position {p - 1 + i}", full[:, p - 1 + i], got, tol)
                  for i, got in enumerate(outs)]
        # the decode's greedy tokens are the forward's wherever its top-2
        # margin is wider than the tolerance
        top2 = full[:, p - 1:].float().topk(2, dim=-1)
        margin = top2.values[..., 0] - top2.values[..., 1]
        clear = margin > tol["atol"] + tol["rtol"] * top2.values[..., 0].abs()
        same = torch.stack([o.argmax(dim=-1) for o in outs], dim=1) == top2.indices[..., 0]
    if not bool((same | ~clear).all()):
        raise AssertionError(f"{cfg.name}: a generated token is not the forward's greedy token")
    if not bool(torch.isfinite(s.prefill_logits).all()) or s.tokens.shape != (b, gen + 1):
        raise AssertionError(f"{cfg.name}: non-finite prefill logits or tokens {s.tokens.shape}")
    where = "in bf16"
    if f32:
        where = (f"in f32 on the first {checked.cfg.n_layers} of {cfg.n_layers} layers"
                 if checked is not model else "in f32") + ", fed the served tokens"
    print(f"[check] {cfg.name}: (a) {where}, decode matches forward at all {gen + 1} generated "
          f"positions x {b} rows x {cfg.vocab} logits: {summary(checks)}; its greedy tokens equal "
          f"to the forward's at {int(clear.sum())} clear positions of {clear.numel()}{gap}; (b) "
          f"card vs CPU in bf16 on the first {cut_layers(cfg)} layers"
          f"{' (and encoder layers)' if cfg.family == 'encdec' else ''}: {card_vs_cpu} (rtol "
          f"{tol['rtol']} atol {tol['atol']} on all but {LM_OUTSIDE:.1%} of the logits, "
          f"correlation > 0.999); {time.perf_counter() - t:.2f} s", flush=True)
    del run, model, checked, s, warm, full
    torch.cuda.empty_cache()


def no_drop(cfg):
    """``cfg`` at a capacity factor of E/k: capacity ≥ T for any T tokens."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def agreeing_wukv(model, cfg) -> None:
    """Each MLA layer's ``wukv`` made of its first (kv_lora × nope) block
    repeated for every head's nope and v columns (nope = v), in place.
    The absorbed decode reads ``wukv`` as all heads' nope columns, then all
    heads' v columns; the prefill reads it per head, nope then v (the
    reference's layouts, `ROADMAP.md` § 3): only such a matrix reads the
    same both ways, so that decoding can match the forward."""
    import torch

    with torch.no_grad():
        for blk in [*model.lead, *model.blocks]:
            w = blk.mix.wukv
            w.copy_(w[:, :cfg.qk_nope_head_dim].repeat(1, 2 * cfg.n_heads))


def fan_in_experts(model) -> None:
    """Every expert weight rescaled in place from the init's 1/sqrt(E) to
    1/sqrt(fan_in).  At 1/sqrt(E) an expert's output is about 1e4 at
    mixtral's width and swamps the residual, whose bf16 rounding then
    differs between the forward's and the decode's batched products (on
    an H100, mixtral's first decode position left more logits outside
    ``LM_TOL`` than ``LM_OUTSIDE`` allows), as the reference's own decode
    and forward do at the smoke widths (`ROADMAP.md` § 3)."""
    import torch

    with torch.no_grad():
        for blk in model.blocks:
            for name in ("wi", "wg", "wo"):
                w = getattr(blk.ffn, name)
                w.copy_((w.float() * (w.shape[0] / w.shape[1]) ** 0.5).to(w.dtype))


def moe_serve(arch: str, card: str) -> None:
    """``[lm]`` for an MoE arch: `launch/serve.main` at its smoke config on
    the card, then `serve.serve_loop` at full width on the first
    ``MOE_LAYERS[arch]`` layers, seeded random weights drawn on the card
    (each MoE call's ``drop_frac`` read), and a warm rerun; then checks
    (b) the first 2 layers card against CPU at the published capacity
    and (a) decoding against the forward at a capacity that drops
    nothing (`no_drop`), on experts at 1/sqrt(fan_in) (`fan_in_experts`;
    deepseek also on `agreeing_wukv`)."""
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    device = ExecOptions().torch_device()
    t = time.perf_counter()
    smoke = serve.main(["--arch", arch, "--smoke"])
    if not all(bool(torch.isfinite(x).all()) for x in smoke.served.step_logits):
        raise AssertionError(f"{arch} --smoke: non-finite logits")
    print(f"[lm] main(['--arch', '{arch}', '--smoke']) on the card: {smoke.cfg.name}, tokens "
          f"{smoke.served.tokens[0].tolist()}, {time.perf_counter() - t:.2f} s", flush=True)
    del smoke

    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_LAYERS[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(device).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)), device=device)
    max_len = LM_PROMPT + LM_GEN + 8
    n_moe = sum(blk.kind == "moe" for blk in model.blocks)
    with moe_probe([]) as calls:
        s = serve.serve_loop(cfg, model, prompts, LM_GEN, max_len)
    peak = torch.cuda.max_memory_allocated()
    warm = serve.serve_loop(cfg, model, prompts, LM_GEN, max_len)
    if not (warm.tokens == s.tokens).all():
        raise AssertionError(f"{cfg.name}: a second run of the loop gave other tokens")
    drops = [float(c["drop_frac"]) for c in calls]
    decode_drops = np.asarray(drops[n_moe:]).reshape(LM_GEN, n_moe)
    _, nbytes, bound_ms = decode_bound(model, LM_BATCH)  # all E experts: dense over E
    step_ms = [x.decode_s / LM_GEN * 1e3 for x in (s, warm)]
    print(f"[lm] {cfg.name} at full width, {cfg.n_layers} of {get_config(arch).n_layers} layers "
          f"({cfg.first_dense_layers} dense lead, {n_moe} MoE; d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_experts} experts top-{cfg.top_k}, "
          f"{cfg.n_shared_experts} shared, d_ff_expert {cfg.d_ff_expert}, "
          f"{'MLA' if cfg.is_mla else f'window {cfg.window}'}, vocab {cfg.vocab}), batch "
          f"{LM_BATCH}, prompt {LM_PROMPT}, gen {LM_GEN}: prefill {s.prefill_s * 1e3:.2f} ms, "
          f"decode {s.decode_s * 1e3:.2f} ms ({step_ms[0]:.2f} ms a step against a "
          f"{bound_ms:.2f} ms bound: {nbytes} weight bytes at {HBM_BYTES_PER_S / 1e12} TB/s; "
          f"{LM_BATCH * LM_GEN / s.decode_s:.1f} tokens/s); warm rerun prefill "
          f"{warm.prefill_s * 1e3:.2f} ms, decode {warm.decode_s * 1e3:.2f} ms ({step_ms[1]:.2f} "
          f"ms a step); drop_frac prefill {drops[:n_moe]}, decode max per layer "
          f"{decode_drops.max(axis=0).tolist()}; parameters {lm.param_bytes(model)} bytes, "
          f"drawn on the card in {t_init:.2f} s; max_memory_allocated {peak - before} bytes "
          f"above the {before} the earlier phases hold; card {card}", flush=True)

    t = time.perf_counter()
    card_vs_cpu = lm_card_vs_cpu(model, prompts)
    t_b = time.perf_counter() - t

    t = time.perf_counter()
    nd = no_drop(cfg)
    fan_in_experts(model)
    if cfg.is_mla:
        agreeing_wukv(model, cfg)
    with moe_probe([], route=True) as served_calls:
        served = serve.serve_loop(nd, model, prompts, LM_GEN, max_len)
    fed = [torch.as_tensor(served.tokens[:, i:i + 1], device=prompts.device)
           for i in range(LM_GEN)]
    seq = torch.cat([prompts] + fed, dim=1)
    with torch.inference_mode(), moe_probe([], route=True) as full_calls:
        full, _ = lm.forward(nd, model, seq)
    first, flips = routed_apart(full_calls, served_calls, n_moe, LM_BATCH, cfg.top_k)
    # the decode again, on the forward's routing decisions
    seen, _, forced_calls = run_fed(nd, model, prompts, max_len, LM_GEN, fed,
                                    force=serve_order(full_calls, n_moe, LM_BATCH, LM_PROMPT))
    if any(float(c["drop_frac"]) for c in served_calls + full_calls + forced_calls):
        raise AssertionError(f"{cfg.name}: a call dropped tokens at capacity factor "
                             f"{nd.capacity_factor}")
    outs = [seen[0][:, -1]] + [step[:, 0] for step in seen[1:]]
    checks = [check_logits(f"{cfg.name} position {LM_PROMPT - 1 + i}", full[:, LM_PROMPT - 1 + i],
                           got) for i, got in enumerate(outs)]
    # the served tokens are the forward's greedy tokens wherever its top-2
    # margin is wider than the tolerance, up to each row's first flip
    top2 = full[:, LM_PROMPT - 1:].float().topk(2, dim=-1)
    margin = top2.values[..., 0] - top2.values[..., 1]
    clear = margin > LM_TOL["atol"] + LM_TOL["rtol"] * top2.values[..., 0].abs()
    clear &= torch.as_tensor(first[:, None] > np.arange(LM_PROMPT - 1, LM_PROMPT + LM_GEN)[None],
                             device=clear.device)
    same = torch.as_tensor(served.tokens, device=full.device) == top2.indices[..., 0]
    if not bool((same | ~clear).all()):
        raise AssertionError(f"{cfg.name}: a generated token is not the forward's greedy token")
    print(f"[check] {cfg.name}: (a) at capacity factor {nd.capacity_factor:.4g} (no call "
          f"drops), on fan-in experts{' and agreeing wukv' if cfg.is_mla else ''}: routed apart "
          f"from the forward in {int((first < sys.maxsize).sum())} of {LM_BATCH} rows, "
          f"{len(flips)} flips {flips or ''} (router logits within the tolerance); on the "
          f"forward's routing, decode matches forward at all "
          f"{LM_GEN + 1} generated positions x {LM_BATCH} rows x {cfg.vocab} logits: "
          f"{summary(checks)}; served tokens equal to the forward's greedy ones at "
          f"{int(clear.sum())} clear positions before a flip; {time.perf_counter() - t:.2f} s; "
          f"(b) card vs CPU on the first {LM_CUT['layers']} layers at the published capacity: "
          f"{card_vs_cpu}; {t_b:.2f} s", flush=True)
    del model, s, warm, served, full, seen
    torch.cuda.empty_cache()


def aqp_serve() -> dict:
    """``[aqp]``: `launch/serve.main(["--aqp"])` at its defaults on the card
    (its kernel launches counted), then on the CPU: the same ``mean
    reads`` and ``modes``."""
    import io

    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    lines = {}
    for where in ("cuda", "cpu"):
        out = io.StringIO()
        if where == "cuda":
            _build.LAUNCHES.reset()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            serve.main(["--aqp", "--device", where])
        wall = time.perf_counter() - t
        if where == "cuda":
            launches = launches_of(AQP_KERNELS)
            print(out.getvalue(), end="", flush=True)
        line = next(li for li in out.getvalue().splitlines() if "mean reads" in li)
        lines[where] = line[line.index("mean reads"):]
        print(f"[aqp] main(['--aqp', '--device', '{where}']) {wall:.2f} s", flush=True)
    if lines["cuda"] != lines["cpu"]:
        raise AssertionError(f"--aqp on the card: {lines['cuda']!r}; on the CPU: {lines['cpu']!r}")
    print(f"[check] --aqp: card and CPU print the same {lines['cuda']!r}; aqp launches "
          f"{json.dumps(launches, sort_keys=True)}", flush=True)
    return launches


def lm_path(card: str) -> dict:
    """Phase 11 → the ``--aqp`` run's launches."""
    print(f"[reduced] phase 11 (b) card vs CPU: the first {LM_CUT['layers']} layers of each "
          f"model ({LM_CUT_LAYERS} for the hybrid's first whole unit: two RG-LRU blocks and "
          f"its local MQA attention; whisper's first {LM_CUT['layers']} encoder layers with "
          f"them), batch 1, a {LM_CUT['prompt']}-token prompt (after internvl's whole image "
          f"prefix), {LM_CUT['steps']} decode steps (the full models run on the card only)",
          flush=True)
    print(f"[reduced] phase 11 check (a) in f32 on the first {F32_LAYERS} layers (the whole "
          f"model in f32 does not fit one card; its bf16 decode at full depth leaves more than "
          f"{LM_OUTSIDE:.1%} of a step's logits outside the tolerance, a share that grows with "
          f"depth: ROADMAP.md § 3); the bf16 gap at full depth printed and held to the "
          f"correlation rule", flush=True)
    print(f"[reduced] phase 11 MoE: full width on the first {MOE_LAYERS} layers (the whole "
          f"models, 141 B and 239 B parameters, do not fit one card); check (a) at a capacity "
          f"factor of n_experts / top_k, where no call drops (capacity follows the token count, "
          f"B·S in the forward and B in a decode step), on experts rescaled from the init's "
          f"1/sqrt(E) to 1/sqrt(fan_in) (at 1/sqrt(E) their outputs swamp the residual, whose "
          f"rounding then splits the two paths), and for deepseek on a wukv whose two layouts "
          f"agree (its absorbed decode and its prefill read wukv in two layouts: ROADMAP.md "
          f"§ 3)", flush=True)
    for arch in LM_ARCHS:
        lm_serve(arch, card)
    for arch in MOE_LAYERS:
        moe_serve(arch, card)
    return aqp_serve()


# --------------------------------------------------------------------------
# phase 12: the LM training path on the PS³ token data plane
# --------------------------------------------------------------------------
TRAIN_ARCH = "qwen1.5-0.5b"  # launch/train.py's default
TRAIN_STEPS, TRAIN_BATCH = 6, 8
TRAIN_RESUME = 3  # the checkpoint interval, and the step the resumed run starts from
TRAIN_FLAGS = ("--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
               "--ckpt-every", str(TRAIN_RESUME))
TRAIN_TOL = dict(rtol=2e-2, atol=2e-2)  # the reference's resume tolerance
# (b): the CPU tests' tolerances (`tests/test_torch_train.py`): the loss,
# and each gradient leaf's relative L2 error (bf16: the reference's own
# two lowerings differ by up to 4.0e-2)
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 1e-3, 5e-2
TRAIN_CUT = 2  # layers of check (b), batch 1
TRAIN_KERNELS = tuple(k for k in SOURCES if k != "predicate_eval")


@contextlib.contextmanager
def train_probe(rec: dict):
    """Times the parts of `launch/train.main` without changing them: the
    token store, the plane (kept, with its first selection), each train
    step (the device synchronised), each checkpoint save (the call: the
    host copy, and each write with its bytes), each restore's tree (a
    copy kept), the watchdog's verdicts and the model
    (`lm.init_params`)."""
    from unittest import mock

    import torch

    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train import checkpoint, tree

    def timed(fn, sink):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            sink.append(time.perf_counter() - t)
            return out
        return run

    def plane(*a, **kw):
        t = time.perf_counter()
        out = plane_cls(*a, **kw)
        rec["plane_s"].append(time.perf_counter() - t)
        rec["planes"].append((out, out.shard_ids.copy(), out.weights.copy()))
        return out

    def make_train_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(*sa):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*sa)
            torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t)
            return out
        return run

    def write(self, step, flat, extra):
        t = time.perf_counter()
        out = write_fn(self, step, flat, extra)
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        rec["writes"].append((step, time.perf_counter() - t, os.path.getsize(path)))
        return out

    def observe(self, dt):
        fired = observe_fn(self, dt)
        rec["fired"].append(fired)
        return fired

    def init_params(*a, **kw):
        model = init_fn(*a, **kw)
        rec["models"].append(model)
        return model

    def restore(self, *a, **kw):
        out = restore_fn(self, *a, **kw)
        # a copy: the launcher's steps update the restored AdamW state in place
        rec["restores"].append(tree.tree_map(lambda t: t.clone(), out))
        return out

    make_step, write_fn = train.steps_mod.make_train_step, checkpoint.Checkpointer._write
    observe_fn, init_fn = train.StepWatchdog.observe, lm.init_params
    plane_cls, restore_fn = train.PS3DataPlane, checkpoint.Checkpointer.restore
    for k in ("plane_s", "planes", "step_s", "saves", "writes", "fired", "models", "store_s",
              "restores"):
        rec.setdefault(k, [])
    with mock.patch.object(train, "PS3DataPlane", plane), \
            mock.patch.object(train, "make_token_store",
                              timed(train.make_token_store, rec["store_s"])), \
            mock.patch.object(train.steps_mod, "make_train_step", make_train_step), \
            mock.patch.object(checkpoint.Checkpointer, "save",
                              timed(checkpoint.Checkpointer.save, rec["saves"])), \
            mock.patch.object(checkpoint.Checkpointer, "_write", write), \
            mock.patch.object(train.StepWatchdog, "observe", observe), \
            mock.patch.object(lm, "init_params", init_params), \
            mock.patch.object(checkpoint.Checkpointer, "restore", restore):
        yield rec


def state_bytes(manifest: dict) -> dict:
    """Bytes of the checkpoint's ``params/`` and ``opt/`` leaves."""
    import numpy as np

    out = {"params": 0, "opt": 0}
    for path in manifest["paths"]:
        dtype = manifest["dtypes"][path]
        size = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
        out[path.split("/", 1)[0]] += int(np.prod(manifest["shapes"][path])) * size
    return out


def kmeans_calls(plane) -> tuple:
    """The plane's pick made again, with each KMeans call's assignment,
    exemplars and cluster sizes (numpy) → (selection, calls)."""
    from unittest import mock

    from repro_torch.core import clustering

    calls, body = [], clustering._exemplar_body

    def record(x, assign, center_valid):
        ex, counts, valid = body(x, assign, center_valid)
        calls.append(tuple(t.cpu().numpy() for t in (assign, ex, counts, valid)))
        return ex, counts, valid

    with mock.patch.object(clustering, "_exemplar_body", record):
        sel = plane.picker.pick(plane.query, plane.budget)
    return sel, calls


def plane_vs_host(plane, shard_ids, weights, host) -> str:
    """(c): the card's shard ids and f64 weights equal the host backend's,
    but for exemplars of 2-member clusters: the member nearest the
    cluster's median, which for two members is their midpoint, so both
    are equally near in exact arithmetic and rounding picks one
    (`ROADMAP.md` § 3, the KMeans-tie class).  Such a pick must come from
    equal KMeans assignments, with equal group sizes and budgets; any
    other difference raises."""
    import numpy as np

    card_sel, card_calls = kmeans_calls(plane)
    host_sel, host_calls = kmeans_calls(host)
    if not np.array_equal(card_sel.ids, shard_ids):
        raise AssertionError(f"train plane: a second pick on the card gave {card_sel.ids}, "
                             f"not {shard_ids}")
    same = (np.array_equal(weights, host.weights) and len(card_calls) == len(host_calls)
            and card_sel.group_sizes == host_sel.group_sizes
            and card_sel.group_budgets == host_sel.group_budgets)
    ties = 0
    for (a_c, ex_c, n_c, v_c), (a_h, ex_h, n_h, v_h) in zip(card_calls, host_calls):
        same &= (np.array_equal(a_c, a_h) and np.array_equal(n_c, n_h)
                 and np.array_equal(v_c, v_h))
        for c in np.flatnonzero(v_c & (ex_c != ex_h)):
            same &= bool(n_c[c] == 2 and a_c[ex_c[c]] == c and a_c[ex_h[c]] == c)
            ties += 1
    differ = int((shard_ids != host.shard_ids).sum())
    if not same or differ != ties:
        raise AssertionError(f"train plane: card {shard_ids} {weights}, host "
                             f"{host.shard_ids} {host.weights}")
    tie_note = "" if not ties else (
        f" but for {ties} exemplar(s) of 2-member clusters (card "
        f"{shard_ids[shard_ids != host.shard_ids].tolist()}, host "
        f"{host.shard_ids[shard_ids != host.shard_ids].tolist()}: an exact tie, the same "
        f"KMeans assignments)")
    return (f"the card's plane picks the host backend's {len(shard_ids)} shards{tie_note}, "
            f"with equal f64 weights, group sizes and budgets")


def train_card_vs_cpu(model, plane) -> str:
    """(b): the first ``TRAIN_CUT`` layers of the trained model, on the
    card and on the CPU, at batch 1: `lm.loss_fn` and every gradient."""
    import numpy as np
    import torch

    from repro_torch.launch import train
    from repro_torch.models import lm

    batch = next(plane.batches(1, 1, seed=1))
    out = {}
    for where in ("card", "cpu"):
        dev = model.embed.table.device if where == "card" else torch.device("cpu")
        cut = cut_model(model, TRAIN_CUT, dev).requires_grad_(True)
        loss, _ = lm.loss_fn(cut.cfg, cut, train.batch_tensors(batch, dev))
        names, leaves = zip(*cut.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        out[where] = (float(loss.detach()), {n: g.float().cpu().numpy().astype(np.float64)
                                    for n, g in zip(names, grads)})
        del cut, grads
    (loss_card, g_card), (loss_cpu, g_cpu) = out["card"], out["cpu"]
    rel = {n: float(np.linalg.norm(g_card[n] - g_cpu[n]) / max(np.linalg.norm(g_cpu[n]), 1e-30))
           for n in g_cpu}
    worst = max(rel, key=rel.get)
    if not abs(loss_card - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu) \
            or rel[worst] > TRAIN_GRAD_REL_L2:
        raise AssertionError(f"train card vs CPU: loss {loss_card} vs {loss_cpu}; gradient "
                             f"{worst} relative L2 error {rel[worst]}")
    return (f"loss {loss_card:.6f} vs {loss_cpu:.6f} (rtol {TRAIN_LOSS_RTOL:g}); {len(rel)} "
            f"gradient leaves, worst relative L2 error {rel[worst]:.4g} ({worst}; at most "
            f"{TRAIN_GRAD_REL_L2:g})")


def train_path(card: str) -> dict:
    """Phase 12: `launch/train.main` at full width on the card, checked
    (a) by a resumed run, (b) on the first layers against the CPU, (c) its
    plane against the host backend's on the CPU; `dist_checks`; then
    `resume_path` and `family_train` for each of ``FAMILY_TRAIN`` → the
    launches of every arch's run."""
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.data.tokens import PS3DataPlane
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import Checkpointer

    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    t_phase = time.perf_counter()
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        run_a, out = {}, io.StringIO()
        _build.LAUNCHES.reset()
        t = time.perf_counter()
        with train_probe(run_a), contextlib.redirect_stdout(out):
            losses = train.main(["--arch", TRAIN_ARCH, *TRAIN_FLAGS,
                                 "--ckpt-dir", os.path.join(root, "a")])
        wall = time.perf_counter() - t
        launches = launches_of(TRAIN_KERNELS)
        peak = torch.cuda.max_memory_allocated()
        for line in out.getvalue().splitlines():
            print(f"[train] main: {line}", flush=True)
        plane, shard_ids, weights = run_a["planes"][0]
        model = run_a["models"][0]
        b, s = TRAIN_BATCH, plane.store.tokens.shape[2] - 1
        nbytes = state_bytes(Checkpointer(os.path.join(root, "a")).manifest(TRAIN_STEPS))
        print(f"[train] {model.cfg.name} ({model.cfg.n_layers} layers, d_model "
              f"{model.cfg.d_model}, {model.cfg.n_heads} heads, vocab {model.cfg.vocab}), "
              f"batch {b} x {s} tokens: token store {run_a['store_s'][0]:.2f} s, plane "
              f"{run_a['plane_s'][0]:.2f} s ({len(shard_ids)} of {plane.store.n_shards} "
              f"shards), main() {wall:.2f} s; parameters {nbytes['params']} bytes, optimizer "
              f"state {nbytes['opt']} bytes; max_memory_allocated {peak - before} bytes above "
              f"the {before} the earlier phases hold; card {card}", flush=True)
        for i, (dt, loss) in enumerate(zip(run_a["step_s"], losses), start=1):
            print(f"[train] step {i}: {dt * 1e3:.2f} ms, {b * s / dt:.1f} tokens/s, loss "
                  f"{loss:.6f}", flush=True)
        print(f"[train] loss first {losses[0]:.6f} last {losses[-1]:.6f}", flush=True)
        for call_s, (step, write_s, size) in zip(run_a["saves"], run_a["writes"]):
            print(f"[ckpt] step {step}: save() {call_s * 1e3:.2f} ms (host copy, and the write "
                  f"when blocking), write {write_s * 1e3:.2f} ms, {size} bytes", flush=True)
        print(f"[train] launches {json.dumps(launches, sort_keys=True)}", flush=True)

        # (c) the card's plane against the host backend's on the CPU
        t = time.perf_counter()
        host = PS3DataPlane(plane.store, seed=0, backend="host", device="cpu")
        check_c = (f"(c) {plane_vs_host(plane, shard_ids, weights, host)} "
                   f"({time.perf_counter() - t:.2f} s)")

        # (a) resume from step 3 alone
        resumed = os.path.join(root, "b")
        os.makedirs(resumed)
        shutil.copytree(os.path.join(root, "a", f"step_{TRAIN_RESUME}"),
                        os.path.join(resumed, f"step_{TRAIN_RESUME}"))
        shutil.rmtree(os.path.join(root, "a"))
        run_b, out = {}, io.StringIO()
        t = time.perf_counter()
        with train_probe(run_b), contextlib.redirect_stdout(out):
            tail = train.main(["--arch", TRAIN_ARCH, *TRAIN_FLAGS, "--ckpt-dir", resumed,
                               "--resume"])
        wall_b = time.perf_counter() - t
        np.testing.assert_allclose(tail, losses[TRAIN_RESUME:], **TRAIN_TOL)
        diff = max(abs(x - y) for x, y in zip(tail, losses[TRAIN_RESUME:]))
        check_a = (f"(a) resumed at step {TRAIN_RESUME}: losses {[round(x, 6) for x in tail]} "
                   f"against {[round(x, 6) for x in losses[TRAIN_RESUME:]]}, max difference "
                   f"{diff:.3g} (rtol {TRAIN_TOL['rtol']} atol {TRAIN_TOL['atol']}); main() "
                   f"{wall_b:.2f} s; the watchdog fired {sum(run_a['fired'])} time(s) in the "
                   f"first run and {sum(run_b['fired'])} in the resumed one")

        # (b) the first layers of the trained model, card against CPU
        t = time.perf_counter()
        check_b = (f"(b) the first {TRAIN_CUT} layers of the trained model, batch 1, card "
                   f"vs CPU: {train_card_vs_cpu(model, plane)}; "
                   f"{time.perf_counter() - t:.2f} s")
        print(f"[check] train: {check_a}; {check_b}; {check_c}", flush=True)
        t = time.perf_counter()
        check_d = dist_checks(model, plane, resumed, TRAIN_RESUME, run_b["restores"][0])
        print(f"[check] dist: {check_d}; {time.perf_counter() - t:.2f} s", flush=True)
        del model, run_a, run_b, plane, host
        torch.cuda.empty_cache()
        totals = dict(launches)
        for run in [lambda: resume_path(card, root)] + [
                lambda arch=arch: family_train(arch, card) for arch in FAMILY_TRAIN]:
            for k, n in run().items():
                totals[k] = totals.get(k, 0) + n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[train] the training phase took {time.perf_counter() - t_phase:.2f} s; launches "
          f"{json.dumps(totals, sort_keys=True)}", flush=True)
    return totals


# ... and every other family on the card: mamba2-130m whole through
# `launch/train.main` (the reference's own resume arch: checkpoints every
# 2 steps, a resume from step 2; the launcher keeps the reference
# launcher's remat=False and one microbatch), then `make_train_step` on
# batches from a `PS3DataPlane` for each arch below at full width, under
# its full config's `steps.dryrun_train_options` (the reference dry run's
# state dtype, microbatches, accumulator and remat): arch → layers
# trained (None: whole).  The MoE cuts take int8 states, whose training
# diverges (ROADMAP.md § 3): they get no resume or descent check.
RESUME_ARCH = "mamba2-130m"
RESUME_STEPS, RESUME_AT = 4, 2
FAMILY_TRAIN = {
    "recurrentgemma-9b": 3,  # one pattern unit: RG-LRU, RG-LRU, local MQA
    "mixtral-8x22b": 1,  # the window and the 8 experts
    "deepseek-v2-236b": 2,  # the dense lead layer and one MoE layer (MLA)
    "whisper-small": None,  # 12 encoder and 12 decoder layers
    "internvl2-26b": 2,  # the 256-position image prefix
    RESUME_ARCH: None,  # its (b) runs on the resume run's model
}
FAMILY_STEPS = 3
# (b)'s sequence for the cuts whose CPU side would be slow at 128 tokens
FAMILY_CHECK_SEQ = {"mixtral-8x22b": 32, "deepseek-v2-236b": 32, "internvl2-26b": 32}
TRAIN_LR = 3e-3  # launch/train.py's --lr, with its 10 warm-up steps
DIST_REL_ERR = 0.02  # the reference's int8 bound on a leaf (tests/test_substrate.py)
# (b) on the model cast to f32, the bf16 gap printed, where bf16 misses
# (card against CPU, both bf16, on an H100): the recurrent families (as
# phase 11's F32_CHECK; mamba2-130m's a_log gradients 1.41 apart in
# relative L2, recurrentgemma-9b's wr 7.3e-2), and whisper-small whole,
# whose 12 bf16 encoder layers over 1,500 frames leave the last one's wk
# gradient 7.2e-2 apart; in f32 the two agree to 5e-4 or better
TRAIN_F32_CHECK = F32_CHECK + ("encdec",)
# (e): one step under the dry-run options against one under
# TrainOptions(remat=False), card against card, each gradient leaf in
# relative L2.  The reference's own gap between these two option sets on
# the smoke configs (bf16, a batch of 8 rows), under check (e)'s
# conditions, reaches 6.3e-3 (internvl-smoke's wk; mixtral-smoke 4.5e-3,
# deepseek-smoke 5.5e-3; the port's 2.5e-3 to 5.9e-3): rounding alone,
# each microbatch's gradients rounded to bf16 and summed in the
# accumulator.  Held at about three times that
# (`tests/test_torch_options_gap.py` re-derives it).  The conditions:
# equal loss weights and, for the MoE, the no-drop capacity without the
# load-balance term (`options_cfg`); otherwise the two option sets
# compute different functions in both packages (each microbatch
# normalises its own loss weights, and the capacity and the load-balance
# loss follow each call's tokens: the reference's gap on the plane's
# weighted rows is 0.35 for internvl-smoke, 0.73 for mixtral-smoke)
TRAIN_OPTIONS_REL_L2 = 2e-2
REMAT_ARCH = "internvl2-26b"  # (e) also prints remat's own gap on this arch


def train_grads(model, batch, force=None) -> tuple:
    """`lm.loss_fn` on ``batch`` and every gradient (autograd) → (loss,
    {lb_loss, z_loss}, {name: gradient}, the `moe_probe` routing records;
    ``force``: take those expert ids)."""
    import torch

    from repro_torch.models import lm

    model.requires_grad_(True)
    with moe_probe([], route=True, force=force) as calls:
        loss, aux = lm.loss_fn(model.cfg, model, batch)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return (float(loss.detach()), {k: float(aux[k].detach()) for k in ("lb_loss", "z_loss")},
            dict(zip(names, grads)), calls)


def grad_gap(got: dict, want: dict) -> tuple[str, float]:
    """The worst leaf's relative L2 error of ``got`` against ``want``,
    in f32 on ``got``'s device, leaf by leaf."""
    import torch

    rel = {}
    for name, g in got.items():
        w = want[name].to(g.device).float()
        rel[name] = float(torch.linalg.vector_norm(g.float() - w)
                          / torch.linalg.vector_norm(w).clamp_min(1e-30))
        del w
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


def family_card_vs_cpu(model, batch: dict, dev) -> str:
    """(b) for a trained model: a copy on the CPU and the model on the
    card, one batch of 1 (numpy tokens, bf16 extras): `lm.loss_fn`, its
    router terms and every gradient at ``TRAIN_LOSS_RTOL`` and
    ``TRAIN_GRAD_REL_L2``.  MoE routing is compared token by token: a
    token routed apart must see router logits within ``LM_TOL`` (a near
    tie), and the card then runs again on the CPU's routing, on which the
    loss and gradients are compared (the router terms are not: a flip
    moves the expert counts).  The recurrent families and whisper
    (``TRAIN_F32_CHECK``) are compared on the model cast to f32, as phase
    11's ``F32_CHECK`` does, with the bf16 gap printed: the card's bf16
    loss and gradients against the CPU's f32 ones."""
    import torch

    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = model.cfg
    t = time.perf_counter()
    host = cut_model(model, cfg.n_layers, "cpu")
    t_copy = time.perf_counter() - t
    data = {where: {**train.batch_tensors({k: batch[k] for k in ("tokens", "targets",
                                                                  "loss_weights")}, d),
                    **{k: v.to(d) for k, v in batch.items()
                       if k in ("enc_frames", "img_embeds")}}
            for where, d in (("cpu", "cpu"), ("card", dev))}
    n_moe = sum(blk.kind == "moe" for blk in model.blocks)
    f32 = cfg.family in TRAIN_F32_CHECK
    gap = ""
    with contextlib.ExitStack() as stack:
        card = model
        if f32:
            stack.enter_context(mock.patch.object(lm, "DTYPE", torch.float32))
            host.float()
        t0 = time.perf_counter()
        cpu = train_grads(host, data["cpu"])
        t1 = time.perf_counter()
        if f32:
            with mock.patch.object(lm, "DTYPE", torch.bfloat16):
                bf16 = train_grads(model, data["card"])
            worst, rel = grad_gap(bf16[2], cpu[2])
            gap = (f"; the bf16 gap (printed): the card's bf16 loss {bf16[0]:.6f} against the "
                   f"CPU's f32 {cpu[0]:.6f}, worst gradient relative L2 error {rel:.4g} "
                   f"({worst})")
            del bf16
            card = cut_model(model, cfg.n_layers, dev).float()
        t2 = time.perf_counter()
        got = train_grads(card, data["card"])
        first, flips = routed_apart(cpu[3], got[3], n_moe, 1, cfg.top_k)
        if flips:
            got = train_grads(card, data["card"], force=[c["idx"] for c in cpu[3]])
        t3 = time.perf_counter()
        worst, rel = grad_gap(got[2], cpu[2])
        aux_ok = flips or all(abs(got[1][k] - cpu[1][k]) <= TRAIN_LOSS_RTOL * abs(cpu[1][k])
                              + 1e-6 for k in cpu[1])
        ok = (abs(got[0] - cpu[0]) <= TRAIN_LOSS_RTOL * abs(cpu[0]) and aux_ok
              and rel <= TRAIN_GRAD_REL_L2)
        text = (f"{'f32' if f32 else 'bf16'}: loss {got[0]:.6f} vs {cpu[0]:.6f}, lb_loss "
                f"{got[1]['lb_loss']:.6g} vs {cpu[1]['lb_loss']:.6g}, z_loss "
                f"{got[1]['z_loss']:.6g} vs {cpu[1]['z_loss']:.6g}"
                f"{' (not compared: a flip)' if flips else ''}; {len(cpu[2])} gradient leaves, "
                f"worst relative L2 error {rel:.4g} ({worst})"
                + (f"; {n_moe} MoE layers routed apart at {flips or 'no token'}"
                   f"{' (gradients on the CPU routing)' if flips else ''}" if n_moe else ""))
        del cpu, got, card, host
    if not ok:
        raise AssertionError(f"{cfg.name} train card vs CPU: {text}")
    return (f"{text} (rtol {TRAIN_LOSS_RTOL:g}, at most {TRAIN_GRAD_REL_L2:g}){gap}; "
            f"{time.perf_counter() - t:.2f} s: the CPU copy {t_copy:.2f} s, the CPU's "
            f"gradients {t1 - t0:.2f} s, the card's {t3 - t2:.2f} s")


def resume_path(card: str, root: str) -> dict:
    """mamba2-130m whole through `launch/train.main`: ``RESUME_STEPS``
    steps with a checkpoint every ``RESUME_AT``, checked (a) by a run
    resumed from that checkpoint alone and (b) card against CPU → the
    first run's launches."""
    import io
    import shutil

    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import Checkpointer

    flags = ["--arch", RESUME_ARCH, "--steps", str(RESUME_STEPS), "--batch", str(TRAIN_BATCH),
             "--ckpt-every", str(RESUME_AT)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    run_a, out = {}, io.StringIO()
    _build.LAUNCHES.reset()
    t = time.perf_counter()
    with train_probe(run_a), contextlib.redirect_stdout(out):
        losses = train.main([*flags, "--ckpt-dir", os.path.join(root, "m")])
    wall = time.perf_counter() - t
    launches = launches_of(TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated()
    plane, model = run_a["planes"][0][0], run_a["models"][0]
    b, s = TRAIN_BATCH, plane.store.tokens.shape[2] - 1
    nbytes = state_bytes(Checkpointer(os.path.join(root, "m")).manifest(RESUME_STEPS))
    print(f"[train] {model.cfg.name} ({model.cfg.family}, {model.cfg.n_layers} layers whole, "
          f"d_model {model.cfg.d_model}, vocab {model.cfg.vocab}), float32 states, batch {b} x "
          f"{s} tokens through launch/train.main: plane {run_a['plane_s'][0]:.2f} s, main() "
          f"{wall:.2f} s, steps "
          f"{[round(dt * 1e3, 2) for dt in run_a['step_s']]} ms ({b * s / run_a['step_s'][-1]:.1f} "
          f"tokens/s at the last), loss first {losses[0]:.6f} last {losses[-1]:.6f}; parameters "
          f"{nbytes['params']} bytes, optimizer state {nbytes['opt']} bytes; "
          f"max_memory_allocated {peak - before} bytes above the {before} the earlier phases "
          f"hold; launches {json.dumps(launches, sort_keys=True)}; card {card}", flush=True)
    if not np.isfinite(losses).all():
        raise AssertionError(f"{RESUME_ARCH}: non-finite losses {losses}")
    resumed = os.path.join(root, "m2")
    os.makedirs(resumed)
    shutil.copytree(os.path.join(root, "m", f"step_{RESUME_AT}"),
                    os.path.join(resumed, f"step_{RESUME_AT}"))
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        tail = train.main([*flags, "--ckpt-dir", resumed, "--resume"])
    wall_b = time.perf_counter() - t
    np.testing.assert_allclose(tail, losses[RESUME_AT:], **TRAIN_TOL)
    diff = max(abs(x - y) for x, y in zip(tail, losses[RESUME_AT:]))
    check_a = (f"(a) resumed at step {RESUME_AT}: losses {[round(x, 6) for x in tail]} against "
               f"{[round(x, 6) for x in losses[RESUME_AT:]]}, max difference {diff:.3g} (rtol "
               f"{TRAIN_TOL['rtol']} atol {TRAIN_TOL['atol']}); main() {wall_b:.2f} s")
    batch = next(plane.batches(1, 1, seed=1))
    check_b = (f"(b) the whole model, batch 1, card vs CPU: "
               f"{family_card_vs_cpu(model, batch, ExecOptions().torch_device())}")
    print(f"[check] train {RESUME_ARCH}: {check_a}; {check_b}", flush=True)
    del model, run_a, plane
    torch.cuda.empty_cache()
    return launches


def options_cfg(cfg):
    """Check (e)'s config: the MoE at the no-drop capacity and without
    the load-balance term, where microbatches change no function (see
    ``TRAIN_OPTIONS_REL_L2``); any other config as it is."""
    if not cfg.is_moe:
        return cfg
    return dataclasses.replace(no_drop(cfg), router_aux_coef=0.0)


@contextlib.contextmanager
def same_routing(topts, plan: dict, logits: dict, apart: list):
    """`moe.route` made to pick, for each MoE layer (keyed by its module),
    the expert ids ``plan`` holds for the whole batch, sliced to the
    microbatch of the call (with remat each microbatch routes twice: its
    forward, and the recompute in its backward).  Each token whose own
    top k differs is appended to ``apart``, and its router logits must
    agree with ``logits`` (the plain run's) at ``LM_TOL``: a near tie."""
    import torch

    from repro_torch.models import moe

    real_route, seen = moe.route, {}

    def routed(p, xt, cfg):
        out_logits, probs, _, own = real_route(p, xt, cfg)
        c = seen[id(p)] = seen.get(id(p), -1) + 1
        rows = slice((c // (2 if topts.remat else 1)) * xt.shape[0],
                     (c // (2 if topts.remat else 1) + 1) * xt.shape[0])
        idx = plan[id(p)][rows]
        if not (topts.remat and c % 2):  # a forward, not its recompute
            with torch.no_grad():  # saves nothing for the backward: the recompute must match
                diff = (own.sort(dim=-1).values != idx.sort(dim=-1).values).any(dim=-1)
                a, b = out_logits.detach()[diff], logits[id(p)][rows][diff]
                if not bool(((a - b).abs() <= LM_TOL["atol"] + LM_TOL["rtol"] * b.abs()).all()):
                    raise AssertionError(f"(e): tokens routed apart from router logits beyond "
                                         f"LM_TOL: {a.tolist()} against {b.tolist()}")
                apart.append(int(diff.sum()))
        gates = torch.gather(probs, 1, idx)
        return out_logits, probs, gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), idx

    with mock.patch.object(moe, "route", routed):
        yield


def options_gap(model, batch: dict, topts, remat_gap: bool) -> str:
    """(e): `steps.make_grad_fn` under ``topts`` (the dry-run options)
    against it under ``TrainOptions(remat=False)`` on the same weights
    and ``batch`` (equal loss weights), card against card: the loss and
    every gradient leaf at ``TRAIN_OPTIONS_REL_L2``; with ``remat_gap``,
    ``topts`` with remat against ``topts`` without, printed on its own
    (remat changes no arithmetic: bit-equal on the CPU).  An MoE cut's
    microbatched runs take the plain run's routing (`same_routing`): a
    batch of 8 rows and one of 1 round the router's inputs apart, and
    near ties then route tokens to other experts (``ROADMAP.md`` § 3);
    the tokens routed apart are counted."""
    import torch

    from repro_torch.models import lm, moe
    from repro_torch.train import steps, tree

    cfg = options_cfg(model.cfg)
    paths = list(tree.flatten(lm.param_tree(model)))
    plan, logits, apart = {}, {}, []
    real_route = moe.route

    def record(p, xt, cfg_):
        out = real_route(p, xt, cfg_)
        logits[id(p)], plan[id(p)] = out[0].detach(), out[3]
        return out

    def grads(o, recording=False):
        with contextlib.ExitStack() as stack:
            if recording:
                stack.enter_context(mock.patch.object(moe, "route", record))
            elif cfg.is_moe:
                stack.enter_context(same_routing(o, plan, logits, apart))
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss, _, g = steps.make_grad_fn(cfg, o)(model, batch)
            torch.cuda.synchronize()
        return float(loss), dict(zip(paths, g)), time.perf_counter() - t

    loss_p, plain, t_p = grads(steps.TrainOptions(remat=False), recording=True)
    loss_d, dry, t_d = grads(topts)
    worst, rel = grad_gap(dry, plain)
    del plain
    routing = ""
    if cfg.is_moe:
        tokens = sum(x.shape[0] for x in plan.values())
        routing = (f"; the microbatches on the plain run's routing, {sum(apart)} of {tokens} "
                   f"token-layers apart at near ties")
    text = (f"(e) options: {topts.num_microbatches} microbatch(es), remat, a {topts.accum_dtype} "
            f"accumulator ({t_d * 1e3:.2f} ms) against one batch without remat ({t_p * 1e3:.2f} "
            f"ms), equal loss weights"
            f"{', no-drop capacity, no load-balance term' if cfg.is_moe else ''}{routing}: "
            f"loss {loss_d:.6f} vs {loss_p:.6f}; {len(paths)} gradient leaves, worst relative L2 "
            f"{rel:.4g} ({worst}; at most {TRAIN_OPTIONS_REL_L2:g})")
    ok = rel <= TRAIN_OPTIONS_REL_L2 and abs(loss_d - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)
    if remat_gap:
        _, norem, t_r = grads(dataclasses.replace(topts, remat=False))
        worst_r, rel_r = grad_gap(dry, norem)
        same = sum(torch.equal(dry[k], norem[k]) for k in paths)
        text += (f"; remat alone ({t_r * 1e3:.2f} ms without): worst relative L2 {rel_r:.4g} "
                 f"({worst_r}), {same} of {len(paths)} leaves bit-equal")
        ok &= rel_r <= TRAIN_OPTIONS_REL_L2
        del norem
    del dry, plan, logits
    if not ok:
        raise AssertionError(f"{model.cfg.name} train options: {text}")
    return text


def family_train(arch: str, card: str) -> dict:
    """``[train]`` for ``arch`` at full width on its cut (`FAMILY_TRAIN`)
    under its full config's `steps.dryrun_train_options`: a
    `PS3DataPlane` on the card over a token store of the arch's vocab,
    seeded random weights drawn on the card (MoE experts at
    1/sqrt(fan_in), `fan_in_experts`), (e) on the plane's first batch,
    then ``FAMILY_STEPS`` `make_train_step` steps on the plane's batches
    (with frames or image embeddings drawn as `serve.draw_extras` draws
    them), every loss finite; then (b) → the launches of the plane and
    the steps."""
    import numpy as np
    import torch

    from repro_torch.backends import ExecOptions
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import PS3DataPlane, make_token_store
    from repro_torch.kernels import _build
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps, tree

    layers = FAMILY_TRAIN[arch]
    full = get_config(arch)
    state_dtype, topts = steps.dryrun_train_options(full)
    cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
    dev = ExecOptions().torch_device()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.LAUNCHES.reset()
    t = time.perf_counter()
    store = make_token_store(seq_len=129, vocab=cfg.vocab, seed=0)
    t_store = time.perf_counter() - t
    t = time.perf_counter()
    plane = PS3DataPlane(store, seed=0)
    t_plane = time.perf_counter() - t
    t = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(0))
    if cfg.is_moe:
        fan_in_experts(model)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t

    batches = [{**train.batch_tensors(batch, dev),
                **serve.draw_extras(cfg, np.random.default_rng((0, i)), TRAIN_BATCH, dev)}
               for i, batch in enumerate(plane.batches(TRAIN_BATCH, FAMILY_STEPS, seed=0))]
    check_e = options_gap(model, {k: v for k, v in batches[0].items() if k != "loss_weights"},
                          topts, remat_gap=arch == REMAT_ARCH)
    peak_e = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    params = lm.param_tree(model)
    ocfg = opt.AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=10, total_steps=FAMILY_STEPS,
                           state_dtype=state_dtype)
    state = opt.init_state(ocfg, params)
    state_b = sum(x.numel() * x.element_size() for x in tree.leaves(state))
    step = steps.make_train_step(cfg, ocfg, topts)
    losses, step_s = [], []
    for data in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, state, metrics = step(model, state, data)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
    launches = launches_of(TRAIN_KERNELS)
    MEASURED_MS[f"{cfg.name} train"] = float(np.mean(step_s[1:])) * 1e3
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cfg.name}: non-finite losses {losses}")
    b, s = TRAIN_BATCH, store.tokens.shape[2] - 1
    n_moe = sum(blk.kind == "moe" for blk in model.blocks)
    extras = "".join(f", {k} {tuple(v.shape)}" for k, v in batches[0].items()
                     if k in ("enc_frames", "img_embeds"))
    print(f"[train] {cfg.name} ({cfg.family}, {cfg.n_layers} of {full.n_layers} layers"
          f"{f' ({cfg.first_dense_layers} dense lead, {n_moe} MoE)' if cfg.is_moe else ''}"
          f"{f', {cfg.n_enc_layers} encoder layers' if cfg.family == 'encdec' else ''}, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}), the dry-run options of the full config: "
          f"{state_dtype} states, {topts.num_microbatches} microbatch(es), remat "
          f"{topts.remat}, a {topts.accum_dtype} accumulator; batch {b} x {s} tokens{extras}: "
          f"token store {t_store:.2f} s, plane {t_plane:.2f} s ({len(plane.shard_ids)} of "
          f"{store.n_shards} shards), weights drawn on the card {t_init:.2f} s, steps "
          f"{[round(x * 1e3, 2) for x in step_s]} ms (warm {np.mean(step_s[1:]) * 1e3:.2f} ms, "
          f"{b * s / step_s[-1]:.1f} tokens/s at the last), loss first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}; parameters {lm.param_bytes(model)} bytes, optimizer state "
          f"{state_b} bytes (updated in place); max_memory_allocated {peak - before} bytes "
          f"above the {before} the earlier phases hold ((e): {peak_e - before}); launches "
          f"{json.dumps(launches, sort_keys=True)}; card {card}", flush=True)
    del state, params, step, batches, data
    if arch == RESUME_ARCH:
        check_b = "(b) on the resume run's model above"
    else:
        seq = FAMILY_CHECK_SEQ.get(arch, s)
        batch = {k: v[:, :seq] if k in ("tokens", "targets") else v
                 for k, v in next(plane.batches(1, 1, seed=1)).items()}
        batch.update(serve.draw_extras(cfg, np.random.default_rng(1), 1, "cpu"))
        check_b = (f"(b) the trained {cfg.n_layers} layers, batch 1 x {seq} tokens, card vs "
                   f"CPU: {family_card_vs_cpu(model, batch, dev)}")
    print(f"[check] train {cfg.name}: losses {[round(x, 6) for x in losses]} finite; "
          f"{check_b}; {check_e}", flush=True)
    del model, plane
    torch.cuda.empty_cache()
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_checks(model, plane, ckpt: str, step: int, plain: dict) -> str:
    """``[check] dist``: the multi-device layer on a one-rank NCCL group
    (the machine has one card): `compressed_pod_mean` on the trained
    model's gradients of one plane batch, bit-equal to the plain form
    with one pod and within the int8 bound of each leaf; the ``step``
    checkpoint restored onto a (1, 1) ``("data", "model")`` CUDA
    `DeviceMesh` through `param_shardings`, bit-equal to ``plain``, the
    plain restore of the same checkpoint that the resumed
    `launch/train.main` made; a train step with ``compress_pod_grads``
    bit-equal to one without.  The group is destroyed before it
    returns."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.backends import ExecOptions
    from repro_torch.distributed import compress, sharding
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps, tree
    from repro_torch.train.checkpoint import Checkpointer

    dev = ExecOptions().torch_device()
    t = time.perf_counter()
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    # NCCL on the card (gloo where the phase is rehearsed on the CPU)
    dist.init_process_group({"cuda": "nccl", "cpu": "gloo"}[dev.type],
                            init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    try:
        mesh = DeviceMesh(dev.type, torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        t_init = time.perf_counter() - t
        cfg = model.cfg
        data = train.batch_tensors(next(plane.batches(TRAIN_BATCH, 1, seed=2)), dev)
        params = lm.param_tree(model.requires_grad_(True))
        loss, _ = lm.loss_fn(cfg, model, data)
        grads = tree.unflatten(params, torch.autograd.grad(loss, tree.leaves(params)))
        del loss
        torch.cuda.synchronize()
        t = time.perf_counter()
        means, errs = compress.compressed_pod_mean(grads, dist.group.WORLD)
        torch.cuda.synchronize()
        t_mean = time.perf_counter() - t
        plain_m, plain_e = compress.compressed_pod_mean_plain(
            tree.tree_map(lambda g: g[None], grads))
        n_el = n_groups = 0
        worst = ("", 0.0)
        for path, g in tree.flatten(grads).items():
            m, e = tree.flatten(means)[path], tree.flatten(errs)[path]
            if not (torch.equal(m, tree.flatten(plain_m)[path])
                    and torch.equal(e, tree.flatten(plain_e)[path][0])):
                raise AssertionError(f"dist: the NCCL pod mean of {path} is not the plain form's")
            rel = float((m - g.float()).abs().max() / g.float().abs().max().clamp_min(1e-30))
            worst = max(worst, (path, rel), key=lambda x: x[1])
            groups = -(-g.numel() // compress.GROUP)
            n_groups, n_el = n_groups + groups, n_el + groups * compress.GROUP
        if worst[1] >= DIST_REL_ERR:
            raise AssertionError(f"dist: {worst[0]} relative max error {worst[1]}")
        del means, errs, plain_m, plain_e, grads
        text = (f"{dist.get_backend()} group of 1 rank ({t_init:.2f} s with the (1, 1) mesh): "
                f"compressed_pod_mean of {len(tree.flatten(params))} gradient leaves "
                f"({n_el} values in {n_groups} groups of {compress.GROUP}) in {t_mean * 1e3:.2f} "
                f"ms, two all_reduces of {4 * n_groups} scale bytes (max) and {4 * n_el} int32 "
                f"code bytes (sum; an int8 wire format would carry {n_el}), bit-equal to the "
                f"plain form with one pod, worst relative max error {worst[1]:.4g} ({worst[0]}; "
                f"< {DIST_REL_ERR})")

        t = time.perf_counter()
        placed = tree.flatten(Checkpointer(ckpt).restore(
            step, plain, shardings=sharding.param_shardings(plain, mesh)))
        t_placed = time.perf_counter() - t
        want_flat = tree.flatten(plain)
        for path, want in want_flat.items():
            got = placed[path]
            if not (got.device_mesh == mesh and got.dtype == want.dtype
                    and torch.equal(got.full_tensor(), want)):
                raise AssertionError(f"dist: the elastic restore of {path} differs")
        nbytes = sum(x.numel() * x.element_size() for x in want_flat.values())
        del placed, want_flat
        text += (f"; step_{step} restored onto the (1, 1) mesh through param_shardings "
                 f"({nbytes} bytes, {t_placed:.2f} s), every leaf a DTensor bit-equal to the "
                 f"resumed run's plain restore")

        ocfg = opt.AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=10, total_steps=TRAIN_STEPS)
        runs = []
        for on in (False, True):
            copy = cut_model(model, cfg.n_layers, dev)
            step_fn = steps.make_train_step(cfg, ocfg, steps.TrainOptions(
                remat=False, compress_pod_grads=on))
            st = opt.init_state(ocfg, lm.param_tree(copy))
            copy, st, metrics = step_fn(copy, st, data)
            runs.append((tree.flatten({"p": lm.param_tree(copy), "s": st}), metrics))
            del copy, st
        (a, ma), (b, mb) = runs
        if not (a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
                and all(torch.equal(ma[k], mb[k]) for k in ma)):
            raise AssertionError("dist: a compress_pod_grads step differs from the plain step")
        text += (f"; a train step with compress_pod_grads bit-equal to one without "
                 f"({len(a)} parameter and state leaves, loss {float(ma['loss']):.6f})")
        del runs, a, b
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return text


# --------------------------------------------------------------------------
# phase 13: the examples' twins on the card
# --------------------------------------------------------------------------
EXAMPLES = ("quickstart_torch", "aqp_service_torch", "serve_lm_torch", "train_lm_torch")
PS3_EXAMPLES = ("quickstart_torch", "aqp_service_torch")  # each must launch kernels


def load_example(name: str):
    """``examples/<name>.py`` as a module (the folder is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_outputs(name: str, out) -> str:
    """The key outputs of one twin's ``main`` return value."""
    import numpy as np

    if name == "quickstart_torch":
        return (f"read {out['read']} partitions at a budget of {out['budget']}, avg rel err "
                f"{out['errors']['avg_rel_err']:.4f}, missed groups "
                f"{out['errors']['missed_groups']:.4f} (uniform sampling "
                f"{out['uniform']['avg_rel_err']:.4f})")
    if name == "aqp_service_torch":
        modes = {m: out["modes"].count(m) for m in sorted(set(out["modes"]))}
        return (f"{len(out['reads'])} answers, mean reads {np.mean(out['reads']):.2f}, mean err "
                f"{np.mean(out['errors']):.4f}, modes {modes}")
    if name == "serve_lm_torch":
        b, g = out.served.tokens.shape[0], out.served.tokens.shape[1] - 1
        return (f"{out.cfg.name}, prefill {out.served.prefill_s * 1e3:.2f} ms, decode "
                f"{out.served.decode_s * 1e3:.2f} ms ({b * g / out.served.decode_s:.1f} "
                f"tokens/s)")
    return f"{len(out)} steps, loss first {out[0]:.6f} last {out[-1]:.6f}"


def examples_path(card: str) -> dict:
    """Phase 13: each twin of `examples/` through its ``main()`` with its
    reference's own arguments, on the card (their default device), its
    output and an ``[example]`` line (wall, key outputs, launches) →
    every twin's launches summed."""
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels import _build

    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    totals = {}
    try:
        for name in EXAMPLES:
            module = load_example(name)
            argv = ["--ckpt-dir", os.path.join(root, "ckpt")] if name == "train_lm_torch" else []
            out = io.StringIO()
            torch.cuda.synchronize()
            _build.LAUNCHES.reset()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                result = module.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = launches_of(())  # which kernels a twin runs depends on its data
            for line in out.getvalue().splitlines():
                print(f"[example] {name}: {line}", flush=True)
            if name in PS3_EXAMPLES and not sum(launches.values()):
                raise AssertionError(f"{name}: no kernel launched")
            if name == "train_lm_torch" and not np.isfinite(result).all():
                raise AssertionError(f"{name}: non-finite losses {result}")
            print(f"[example] {name} main({' '.join(argv)}): {wall:.2f} s; "
                  f"{example_outputs(name, result)}; launches "
                  f"{json.dumps(launches, sort_keys=True)}; card {card}", flush=True)
            for k, n in launches.items():
                totals[k] = totals.get(k, 0) + n
            del result, module
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return totals


class LMPhases:
    """Phases 11 to 13 in a second process on the same card, started after
    phase 3 (whose kernel times it would disturb) and run beside phases 4
    to 10: both sides are host-bound (the card idles most of the time), so
    the run takes about the longer side instead of their sum.  Each
    process counts its own launches; the second writes its phases' counts
    to a file, and its output is printed when it is joined."""

    def __init__(self, card: str):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_lm_")
        self.result = os.path.join(self.dir, "launches.json")
        self.log = os.path.join(self.dir, "stdout.txt")
        self.t0 = time.time()  # the wall clock both processes read
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--lm-phases", self.result,
                 "--card", card, "--parent", str(os.getpid())], stdout=out, cwd=ROOT)
        self.shown = False
        print(f"[lm] phases 11 to 13 started in process {self.proc.pid} beside phases 4 to 10",
              flush=True)

    def show(self) -> None:
        if not self.shown and os.path.exists(self.log):
            self.shown = True
            with open(self.log) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()

    def join(self) -> tuple[dict, dict, dict, dict]:
        """Wait for the second process → (the --aqp launches, the training
        launches, the examples' launches, the step times phase 14 sets its
        bounds against); raises if it failed."""
        import torch

        t = time.time()
        rc = self.proc.wait()
        self.show()
        if rc != 0:
            raise RuntimeError(f"phases 11 to 13 failed in their process (exit code {rc})")
        with open(self.result) as f:
            res = json.load(f)
        print(f"[lm] phases 11 to 13 ended {res['ended'] - self.t0:.2f} s after their process "
              f"started, {max(0.0, res['ended'] - t):.2f} s after phase 10 ended; phases 1 to "
              f"10 peaked at max_memory_allocated {torch.cuda.max_memory_allocated()}, "
              f"max_memory_reserved {torch.cuda.max_memory_reserved()} bytes", flush=True)
        return res["aqp"], res["train"], res["examples"], res["measured"]

    def stop(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.show()
        shutil.rmtree(self.dir, ignore_errors=True)


# phase 14: the dry run (`repro_torch.launch.dryrun`) on the card's machine
MEASURED_MS: dict = {}  # "<arch> decode" / "<arch> train" → phase 11's or 12's warm step
DRYRUN_DECODE = "qwen1.5-0.5b"  # (a) phase 11's decode step, at its serving shape
DRYRUN_TRAIN = RESUME_ARCH  # (a) phase 12's warm train step, mamba2-130m whole
DRYRUN_CELL = ("qwen1_5_0_5b", "decode_32k")  # (b) on the fake 16 x 16 group
# (c) on the same group: the cells torch 2.11's own strategies failed (the
# attention's pad, the embedding's index_put; mamba2's cumsum backward flips)
DRYRUN_TRAIN_CELLS = (("qwen1_5_0_5b", "train_4k"), ("mamba2_130m", "train_4k"))
ONE_RANK = {"data": 1, "model": 1}
# The bounds a sharded row of the dry run is held to, its count a device
# over the reference's own row (`results/dryrun_reference.json`): FLOPs at
# most 1.5 times in a train or prefill step of a family with attention in
# every block (not "ssm" or "hybrid") and 2 times elsewhere; at least 0.9
# times where the reference splits the step's work over its devices (its
# FLOPs a device times the devices within `REF_SPLIT` of the port's step
# FLOPs, `cost["step_flops"]`), as on the reduced meshes
# (`tests/launch_cells.FLOPS_RATIO`); and a dense family's train step's
# memory a device at most 2 times.
REF_FLOPS_MOST = {"attention": 1.5, "other": 2.0}
REF_FLOPS_LEAST = 0.9
REF_SPLIT = 1.1
REF_MEMORY_MOST = 2.0


def reference_bounds(row: dict, ref: dict) -> dict:
    """{metric: (least, most)} that ``row``, a dry-run row of the port,
    is held to over ``ref``, the reference's row of the same cell."""
    from repro_torch.configs import get_config

    family = get_config(row["arch"]).family
    attention = family not in ("ssm", "hybrid") and row["kind"] in ("train", "prefill")
    step = row["cost"].get("step_flops")
    split = step is not None and ref["cost"]["flops"] * ref["devices"] <= REF_SPLIT * step
    bounds = {"flops": (REF_FLOPS_LEAST if split else 0.0,
                        REF_FLOPS_MOST["attention" if attention else "other"])}
    if family == "dense" and row["kind"] == "train":
        bounds["memory"] = (0.0, REF_MEMORY_MOST)
    return bounds


def reference_breaks(row: dict, ref: dict) -> list[str]:
    """The bounds (`reference_bounds`) that ``row`` breaks, each as text."""
    from repro_torch.launch import dryrun

    key = "/".join((row["arch"], row["shape"], row["mesh"]))
    ratios = dryrun.against_reference(row, ref)
    return [f"{key}: {metric} {ratios[metric]:.4f} of the reference's, outside "
            f"[{least}, {most}]"
            for metric, (least, most) in reference_bounds(row, ref).items()
            if not least <= ratios[metric] <= most]


def real_flops(step, *args) -> int:
    """`FlopCounterMode`'s count of one ``step(*args)`` on the card, after a
    warm-up call."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    step(*args)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    return fc.get_total_flops()


def tensor_bytes(*trees) -> int:
    from repro_torch.train import tree

    return sum(t.numel() * t.element_size() for x in trees for t in tree.leaves(x))


def dryrun_steps(dev) -> list:
    """(a)'s two steps on the card, with seeded random weights and inputs:
    [(label, arch, ShapeSpec, real FLOPs, live bytes of the model, the
    state and the inputs)]."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    out = []
    g = torch.Generator(dev).manual_seed(0)
    cfg = get_config(DRYRUN_DECODE)
    max_len = LM_PROMPT + LM_GEN + 8  # launch/serve.py's cache for phase 11's flags
    model = lm.init_params(cfg, g)
    cache = lm.init_cache(cfg, LM_BATCH, max_len, dev)
    tok = torch.randint(0, cfg.vocab, (LM_BATCH, 1), generator=g, device=dev)
    with torch.no_grad():
        flops = real_flops(steps.make_serve_step(cfg), model, cache, tok, max_len - 1)
    out.append((f"{cfg.name} decode", DRYRUN_DECODE,
                ShapeSpec("serve_decode", "decode", max_len, LM_BATCH), flops,
                tensor_bytes(lm.param_tree(model), cache, tok)))
    del model, cache

    cfg = get_config(DRYRUN_TRAIN)
    state_dtype, topts = steps.dryrun_train_options(cfg)
    seq = 128  # phase 12's token store: 129-token rows
    model = lm.init_params(cfg, g)
    ocfg = opt.AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=10, total_steps=FAMILY_STEPS,
                           state_dtype=state_dtype)
    state = opt.init_state(ocfg, lm.param_tree(model))
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, seq), generator=g, device=dev)
             for k in ("tokens", "targets")}
    batch["loss_weights"] = torch.rand((TRAIN_BATCH,), generator=g, device=dev)
    flops = real_flops(steps.make_train_step(cfg, ocfg, topts), model, state, batch)
    out.append((f"{cfg.name} train", DRYRUN_TRAIN,
                ShapeSpec("family_train", "train", seq, TRAIN_BATCH), flops,
                tensor_bytes(lm.param_tree(model), state, batch)))
    del model, state
    torch.cuda.empty_cache()
    return out


def dryrun_path(card: str) -> dict:
    """Phase 14: (a) each of `dryrun_steps` as a `lower_cell` row on a
    (1, 1) mesh of fake CUDA tensors, its FLOPs equal to the real step's
    `FlopCounterMode` count and its ``argument_bytes`` to the live bytes;
    (b) `DRYRUN_CELL` on the fake 16 x 16 group; (c) each of
    `DRYRUN_TRAIN_CELLS` there, its FLOPs equal to its audit →
    {"steps": [(label, row)], "cell": row, "train_cells": [row]}."""
    import torch

    from repro_torch.launch import dryrun, roofline

    t = time.perf_counter()
    real = dryrun_steps(torch.device("cuda"))
    t_real = time.perf_counter() - t
    rows = []
    for label, arch, spec, flops, live in real:
        row = dryrun.lower_cell(arch.replace("-", "_").replace(".", "_"), spec.name,
                                mesh=ONE_RANK, device="cuda", spec=spec, verbose=False)
        got = row["cost"]["flops"]
        if got != flops:
            raise AssertionError(f"[dryrun] {label}: the (1, 1) row counts {got} FLOPs, "
                                 f"FlopCounterMode {flops} on the card")
        if row["memory"]["argument_bytes"] != live:
            raise AssertionError(f"[dryrun] {label}: argument_bytes "
                                 f"{row['memory']['argument_bytes']} against {live} live")
        terms = roofline.bound_terms(row)
        print(f"[dryrun] {label} on a (1, 1) mesh of fake CUDA tensors, batch "
              f"{spec.global_batch} x {spec.seq_len}, torch {row['torch']}: trace "
              f"{row['lower_s']} s; FLOPs {got:.0f} = FlopCounterMode on the card; "
              f"argument_bytes {row['memory']['argument_bytes']} = the live model, state "
              f"and inputs; bytes floor {roofline.floor_bytes(row):.0f} (arguments read "
              f"once, outputs written once); the eager step's op-by-op bytes "
              f"{row['cost']['bytes_accessed']:.0f} ({roofline.terms(row)['memory'] * 1e3:.4f}"
              f" ms); bound terms "
              f"{', '.join(f'{k} {v * 1e3:.4f} ms' for k, v in terms.items())}; step_bound "
              f"{roofline.step_bound(row) * 1e3:.4f} ms; card {card}", flush=True)
        rows.append((label, row))
    reference = dryrun.reference_rows()
    arch, shape = DRYRUN_CELL
    cell = dryrun.lower_cell(arch, shape, device="cuda", verbose=False)
    beside_reference(cell, reference)
    r = roofline.analyze_row(cell)
    print(f"[dryrun] {arch} x {shape} on the fake 16 x 16 group (256 ranks), torch "
          f"{cell['torch']}'s DTensor partitioning: trace {cell['lower_s']} s; terms "
          f"compute {r['t_compute_s'] * 1e3:.4f} ms, memory (eager op-by-op bytes) "
          f"{r['t_memory_s'] * 1e3:.4f} ms, collective {r['t_collective_s'] * 1e3:.4f} ms "
          f"({r['dominant']}); bytes floor {r['t_memory_floor_s'] * 1e3:.4f} ms; step_bound "
          f"{r['step_bound_s'] * 1e3:.4f} ms ({r['bound_by']}), roofline_frac "
          f"{r['roofline_frac']:.4f}; row {json.dumps(cell)}", flush=True)
    train_cells = []
    for arch, shape in DRYRUN_TRAIN_CELLS:
        row = dryrun.lower_cell(arch, shape, device="cuda", verbose=False, audit=True)
        flops, audit = row["cost"]["flops"], row["audit"]["expected_flops"]
        if flops != audit:
            raise AssertionError(f"[dryrun] {arch} x {shape}: {flops} FLOPs a device counted, "
                                 f"{audit} from the placements")
        print(f"[dryrun] {arch} x {shape} on the fake 16 x 16 group (256 ranks), torch "
              f"{row['torch']}: trace {row['lower_s']} s; FLOPs a device {flops:.6g} = the "
              f"audit from the placements ({audit:.6g}); link bytes "
              f"{row['collectives']['link_bytes_total']:.6g} in "
              f"{row['collectives']['num_collectives']} collectives; memory a device "
              f"{row['memory']['per_device_total'] / 2**30:.2f} GiB; microbatches "
              f"{row['microbatches']}", flush=True)
        beside_reference(row, reference)
        train_cells.append(row)
    print(f"[dryrun] the real steps took {t_real:.2f} s", flush=True)
    return {"steps": rows, "cell": cell, "train_cells": train_cells}


def beside_reference(row: dict, reference: dict) -> None:
    """The reference's row of the same cell (`results/dryrun_reference.json`,
    XLA's partitioning of the JAX package on 256 fake devices, read as
    data) beside ``row``: FLOPs, link bytes and memory a device and the
    port's over the reference's; raises where a ratio breaks
    `reference_bounds`."""
    from repro_torch.launch import dryrun

    key = (row["arch"], row["shape"], row["mesh"])
    ref = reference[key]
    ratios = dryrun.against_reference(row, ref)
    print(f"[dryrun] {' x '.join(key)} beside the reference's row (jax {ref['jax']}): FLOPs "
          f"a device {row['cost']['flops']:.6g} / {ref['cost']['flops']:.6g} = "
          f"{ratios['flops']:.4f}; link bytes {row['collectives']['link_bytes_total']:.6g} / "
          f"{ref['collectives']['link_bytes_total']:.6g} = {ratios['link_bytes']:.4f}; memory "
          f"{row['memory']['per_device_total']} / {ref['memory']['per_device_total']} = "
          f"{ratios['memory']:.4f}; bounds {reference_bounds(row, ref)}", flush=True)
    breaks = reference_breaks(row, ref)
    if breaks:
        raise AssertionError(f"[dryrun] beyond the reference's bounds: {breaks}")


def dryrun_report(res: dict, measured: dict, card: str) -> None:
    """Each (a) row's terms and bound beside the step phase 11 or 12
    measured, and their ratio."""
    from repro_torch.launch import roofline

    for label, row in res["steps"]:
        if label not in measured:
            raise AssertionError(f"[dryrun] no measured step for {label}: {sorted(measured)}")
        bound_ms = roofline.step_bound(row) * 1e3
        terms = roofline.bound_terms(row)
        eager_ms = roofline.terms(row)["memory"] * 1e3
        print(f"[dryrun] {label}: measured {measured[label]:.4f} ms a step (phase "
              f"{11 if label.endswith('decode') else 12}, warm) against step_bound "
              f"{bound_ms:.4f} ms ({max(terms, key=terms.get)}; its memory term the bytes "
              f"floor): measured / bound {measured[label] / bound_ms:.2f}; the eager step's "
              f"own op-by-op bytes would take {eager_ms:.4f} ms (measured / that "
              f"{measured[label] / eager_ms:.2f}); card {card}", flush=True)


class DryRunPhase:
    """Phase 14 in a third process: its fake process group must never meet
    phase 12's NCCL group, which lives in the second.  It starts its work
    when the second process has written its result, so that at most two
    of the three share the host at once, and ends long before phase 10.
    Its output is printed when it is joined."""

    def __init__(self, card: str, after: str):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.result = os.path.join(self.dir, "rows.json")
        self.log = os.path.join(self.dir, "stdout.txt")
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dryrun-phase", self.result,
                 "--after", after, "--card", card, "--parent", str(os.getpid())],
                stdout=out, cwd=ROOT)
        self.shown = False
        print(f"[dryrun] phase 14 started in process {self.proc.pid}, to run after phases "
              f"11 to 13", flush=True)

    def show(self) -> None:
        if not self.shown and os.path.exists(self.log):
            self.shown = True
            with open(self.log) as f:
                sys.stdout.write(f.read())
            sys.stdout.flush()

    def join(self) -> dict:
        rc = self.proc.wait()
        self.show()
        if rc != 0:
            raise RuntimeError(f"phase 14 failed in its process (exit code {rc})")
        with open(self.result) as f:
            return json.load(f)

    def stop(self) -> None:
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.show()
        shutil.rmtree(self.dir, ignore_errors=True)


def dryrun_phase_main(args) -> int:
    """Phase 14 alone (the third process of `DryRunPhase`)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    def orphaned():
        while os.getppid() == args.parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    while not os.path.exists(args.after):
        time.sleep(1.0)
    clock = PhaseClock()
    res = dryrun_path(args.card)
    clock.done(14, "dryrun")
    with open(args.dryrun_phase, "w") as f:
        json.dump(res, f)
    return 0


def lm_phases_main(args) -> int:
    """Phases 11 to 13 alone (the second process of `LMPhases`)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: IEEE f32
    def orphaned():  # the first process died without stopping this one
        while os.getppid() == args.parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    clock = PhaseClock()
    aqp = lm_path(args.card)
    clock.done(11, "lm")
    trained = train_path(args.card)
    clock.done(12, "train")
    examples = examples_path(args.card)
    clock.done(13, "examples")
    with open(args.lm_phases, "w") as f:
        json.dump({"aqp": aqp, "train": trained, "examples": examples, "measured": MEASURED_MS,
                   "ended": time.time()}, f)
    return 0


class PhaseClock:
    """Prints ``[time] phase N <name> <s>`` after each phase."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def done(self, n: int | str, name: str) -> None:
        if "torch" in sys.modules:  # the other process may use the cached blocks
            sys.modules["torch"].cuda.empty_cache()
        now = time.perf_counter()
        print(f"[time] phase {n} {name} {now - self.t:.2f}", flush=True)
        self.t = now


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.lm_phases:
        return lm_phases_main(args)
    if args.dryrun_phase:
        return dryrun_phase_main(args)
    import torch

    from repro_torch.data.datasets import make_dataset
    from repro_torch.core.features import build_feature_schema
    from repro_torch.kernels import _build
    from repro_torch.queries.generator import WorkloadSpec

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    clock = PhaseClock()
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
          f"partitions; the Session, plane and streaming paths drive their kernels at full "
          f"size", flush=True)
    for cut in CUTS:
        print(f"[reduced] {cut}", flush=True)
    clock.done(1, "card")

    # the nvcc processes build while the table is drawn
    t = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(lambda: (_build.build_all(), time.perf_counter() - t))
        table = make_dataset("tpch", num_partitions=args.partitions,
                             rows_per_partition=args.rows, seed=args.seed)
        queries = WorkloadSpec(table, seed=args.seed).sample_workload(args.queries)
        n_feat = build_feature_schema(table).dim
        t_data = time.perf_counter() - t
        logs, t_build = build.result()
    print(f"[build] {sorted(logs)} in {t_build:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)}), beside the table", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
    print(f"[data] tpch {table.num_partitions}x{table.rows_per_partition} "
          f"({len(table.schema)} columns), {len(queries)} queries, feature dim {n_feat}, "
          f"in {t_data:.2f} s", flush=True)
    clock.done(2, "build")

    held_out = WorkloadSpec(table, seed=args.seed + 1).sample_workload(args.held_out)
    records = run_kernel_phase(
        kernel_cases(table, queries, held_out, dev)
        + picker_cases(args.queries * table.num_partitions, n_feat, table.num_partitions,
                       dev, args.seed))
    clock.done(3, "kernels")

    # a SIGTERM (a time limit) unwinds through the `finally` that stops
    # the second process
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    lm = LMPhases(card)
    dry = DryRunPhase(card, lm.result)
    try:
        offline_path(table, queries, args)
        clock.done(4, "offline")

        sess, launches, walls, planned, held_out = session_path(table, args)
        report_answers(sess, table, planned, walls, held_out, args)
        clock.done(5, "session")

        fit = check_forest(sess, table, args)
        clock.done(6, "forest")

        plane = plane_path(sess, queries, held_out, planned, args)
        clock.done(7, "plane")

        stream, stream_keys = stream_path(sess, queries, held_out, args)
        clock.done(8, "stream")
        serve = serve_path(sess, held_out, fit, args)
        clock.done(9, "serve")
        life = lifecycle_path(sess, held_out, stream_keys, args)
        clock.done(10, "lifecycle")
        aqp, trained, examples, measured = lm.join()
        clock.done("11-13", "wait")
        dryrun_report(dry.join(), measured, card)
        clock.done(14, "dryrun wait")
    finally:
        lm.stop()
        dry.stop()
    for name, rec in records.items():
        rec["session_launches"] = launches.get(name, 0)
        rec["plane_launches"] = plane.get(name, 0)
        rec["stream_launches"] = stream.get(name, 0)
        rec["serve_launches"] = serve.get(name, 0)
        rec["lifecycle_launches"] = life.get(name, 0)
        rec["aqp_launches"] = aqp.get(name, 0)
        rec["train_launches"] = trained.get(name, 0)
        rec["example_launches"] = examples.get(name, 0)
        rec["launches"] = (rec["session_launches"] + rec["plane_launches"]
                           + rec["stream_launches"] + rec["serve_launches"]
                           + rec["lifecycle_launches"] + rec["aqp_launches"]
                           + rec["train_launches"] + rec["example_launches"])

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(f"[time] total {time.perf_counter() - clock.t0:.2f}", flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
