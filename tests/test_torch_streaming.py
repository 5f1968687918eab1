"""The port's streaming append path against its own cold rebuild and the reference.

Appending partitions through `append_partitions` updates every derived
structure of the port incrementally — sketch rows for only the new
partitions (`update_sketches` / `SketchStore`), an in-place write into
the device stack's slack (`EvalCache`), a delta-only answer merge
(`AnswerStore`) — and each is bit-identical to a cold rebuild of the grown
table, on the host backend and on the device backend (here the kernels'
plain versions on the CPU).  The host backend's incremental sketches are
bit-identical to the reference's, and the mergeable-statistic primitives
give the reference's results.  These are the single-device cases of the
reference's `tests/test_streaming_ingest.py`.  Inputs are made with numpy
from a seed (the datasets are byte-identical in the two packages) and
carried across with `repro_torch.carry`.
"""
import numpy as np
import pytest
import torch

from repro.backends import ExecOptions as RefExecOptions
from repro.core import ingest as ref_ingest
from repro.core import sketches as ref_sketches
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.data.table import append_partitions as ref_append_partitions
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.core import ingest
from repro_torch.core.sketches import (
    AKMV_BLOCK,
    AKMV_K,
    SketchStore,
    _akmv,
    _akmv_block,
    _partition_bincount,
    akmv_finalize,
    akmv_state,
    build_sketches,
    lossy_counting,
    merge_akmv_states,
    update_sketches,
)
from repro_torch.data.datasets import make_dataset
from repro_torch.data.table import CATEGORICAL, NUMERIC, ColumnSpec, Table, append_partitions
from repro_torch.kernels import ops
from repro_torch.queries import device
from repro_torch.queries.engine import (
    AnswerStore,
    EvalCache,
    per_partition_answers_batch,
    stack_partitions,
)
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.queries.ir import Aggregate, Clause, Predicate, Query

CPU = ExecOptions(device="cpu")
OPTIONS = {"host": CPU.replace(backend="host"), "device": CPU}
SKETCH_FIELDS = ("measures", "hist_edges", "cat_counts", "ndv", "dv_freq", "hh_stats",
                 "global_hh", "bitmap", "part_spans")


def _delta(parts, rows=64, seed=7):
    t = make_dataset("kdd", num_partitions=max(parts, 1), rows_per_partition=rows,
                     layout="random", seed=seed)
    if parts == 0:  # empty append: a 0-partition column mapping
        return {k: v[:0] for k, v in t.columns.items()}
    return t


def assert_sketches_equal(a, b):
    assert a.num_partitions == b.num_partitions
    for name, ca in a.columns.items():
        cb = b.columns[name]
        for field in SKETCH_FIELDS:
            x, y = getattr(ca, field), getattr(cb, field)
            assert (x is None) == (y is None), (name, field)
            if x is not None:
                assert np.array_equal(np.asarray(x), np.asarray(y)), (name, field)
        assert ca.hh_items == cb.hh_items, name
        assert ca.discrete_span == cb.discrete_span, name


def assert_answers_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.group_keys, w.group_keys)
        assert np.array_equal(g.raw, w.raw)


# --------------------------------------------------------------------------
# k successive appends ≡ cold rebuild
# --------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["host", "device"])
def test_append_equivalence_sweep(backend):
    """Base P=5 (bucket 8), then an in-bucket append (+3 → 8), an empty
    append and a bucket-overflow append (+9 → 17, bucket 32).  After every
    step the incrementally maintained sketches and answers equal a cold
    rebuild bitwise; on the host backend the sketches also equal the
    reference's incrementally maintained ones."""
    opts = OPTIONS[backend]
    ref_table = ref_make_dataset("kdd", num_partitions=5, rows_per_partition=64)
    table = carry.table(ref_table)
    queries = WorkloadSpec(table, seed=3).sample_workload(8)
    sketch_store = SketchStore(table, options=opts)
    ref_store = ref_sketches.SketchStore(ref_table, options=RefExecOptions(backend="host"))
    answer_store = AnswerStore(table, options=opts)
    answer_store.get_batch(queries)  # warm the LRU before the appends

    for parts, seed in ((3, 11), (0, 12), (9, 13)):
        delta = _delta(parts, seed=seed)
        cols = delta.columns if isinstance(delta, Table) else delta
        append_partitions(table, cols)
        ref_append_partitions(ref_table, cols)
        sk = sketch_store.sketches()
        assert_sketches_equal(sk, build_sketches(table, options=opts))
        if backend == "host":
            assert_sketches_equal(sk, carry.sketches(ref_store.sketches()))
        got = answer_store.get_batch(queries)
        cold = per_partition_answers_batch(table, queries, options=opts,
                                           cache=EvalCache(table, options=opts))
        assert_answers_equal(got, cold)
        assert all(a.raw.shape[0] == table.num_partitions for a in got)
    assert sketch_store.incremental_updates == 3 and sketch_store.full_rebuilds == 0
    # every entry held before the appends survived all three (none dropped)
    assert answer_store.carried >= len(queries) and answer_store.misses == len(queries)


@pytest.mark.parametrize("mesh", [2, 8], ids=["mesh2", "mesh8"])
def test_append_equivalence_sweep_on_a_plane(mesh):
    """The reference sweep's plane lanes on ``mesh`` logical CPU shards:
    after every append the folded sketches and answers equal a cold
    rebuild on the plane and the single-device port's, bit for bit (the
    overflow to 17 re-pads the 8-slot stack at 32)."""
    opts = CPU.replace(mesh=mesh)
    table = carry.table(ref_make_dataset("kdd", num_partitions=5, rows_per_partition=64))
    queries = WorkloadSpec(table, seed=3).sample_workload(8)
    sketch_store = SketchStore(table, options=opts)
    answer_store = AnswerStore(table, options=opts)
    assert answer_store.plane.num_devices == mesh
    answer_store.get_batch(queries)
    for parts, seed in ((3, 11), (0, 12), (9, 13)):
        delta = _delta(parts, seed=seed)
        append_partitions(table, delta.columns if isinstance(delta, Table) else delta)
        sk = sketch_store.sketches()
        assert_sketches_equal(sk, build_sketches(table, options=opts))
        assert_sketches_equal(sk, build_sketches(table, options=CPU))
        got = answer_store.get_batch(queries)
        for options in (opts, CPU):
            assert_answers_equal(got, per_partition_answers_batch(
                table, queries, options=options, cache=EvalCache(table, options=options)))
    assert sketch_store.incremental_updates == 3 and sketch_store.full_rebuilds == 0
    assert answer_store.carried >= len(queries)
    assert answer_store._eval_cache.device_stack().shape[1] == 32


@pytest.mark.parametrize("backend", ["host", "device"])
def test_single_row_partitions(backend):
    """rows_per_partition=1 — the degenerate partition geometry."""
    schema = (
        ColumnSpec("v", NUMERIC),
        ColumnSpec("c", CATEGORICAL, cardinality=3, groupable=True),
    )

    def mk(parts, seed):
        r = np.random.default_rng(seed)
        return Table(schema, {
            "v": r.normal(size=(parts, 1)).astype(np.float32),
            "c": r.integers(0, 3, size=(parts, 1)).astype(np.int32),
        }, name="tiny")

    opts = OPTIONS[backend]
    table = mk(4, 1)
    store = SketchStore(table, options=opts)
    append_partitions(table, mk(3, 2))
    assert_sketches_equal(store.sketches(), build_sketches(table, options=opts))


def test_update_sketches_matches_reference_host_backend():
    """One host-backend `update_sketches` call of the port against the
    reference's on the same snapshot and delta: bit-identical."""
    ref_table = ref_make_dataset("tpch", num_partitions=6, rows_per_partition=128)
    table = carry.table(ref_table)
    ref_opts = RefExecOptions(backend="host")
    ref_sk = ref_sketches.build_sketches(ref_table, options=ref_opts)
    sk = carry.sketches(ref_sk)
    delta = ref_make_dataset("tpch", num_partitions=3, rows_per_partition=128, seed=5)
    ref_append_partitions(ref_table, delta)
    append_partitions(table, carry.table(delta))
    want = ref_sketches.update_sketches(ref_sk, ref_table, 6, options=ref_opts)
    got = update_sketches(sk, table, 6, options=OPTIONS["host"])
    assert_sketches_equal(got, carry.sketches(want))


# --------------------------------------------------------------------------
# delta statistics, merges and the launch keys
# --------------------------------------------------------------------------
def test_delta_statistics_equal_the_cold_rows():
    """A delta pass over partitions [6, 10) gives, row for row, what the
    cold pass over the whole table gives for them — padded to a bucket of
    4 partitions and a power-of-two bin count — and reports the delta's
    raw integer span."""
    table = make_dataset("kdd", num_partitions=10, rows_per_partition=64)
    cold = ingest.build_statistics(table, discrete_counts=True, options=CPU)
    delta = ingest.delta_statistics(table, 6, discrete_counts=True, options=CPU)
    for col, want in cold.items():
        got = delta[col]
        for key in ("measures", "hist_edges", "hist_counts", "counts"):
            if key in want:
                assert np.array_equal(got[key], want[key][6:]), (col, key)
        if table.spec(col).kind == NUMERIC:
            assert got["discrete_range_span"] == ingest.int_span(table.columns[col][6:])
        if "discrete_counts" in got:
            # the delta's own span: realigned into the cold span it is equal
            lo, width = want["discrete_lo"], want["discrete_counts"].shape[1]
            moved = ingest._embed_counts(got["discrete_counts"], got["discrete_lo"], lo, width)
            assert np.array_equal(moved, want["discrete_counts"][6:]), col


@pytest.mark.parametrize("reference", ["port-cold", "reference"])
def test_merge_statistics_matches_cold_build(reference):
    """Pre-append statistics merged with a delta equal a cold pass over the
    grown table: the port's own bit for bit; the reference's with its
    statistics-tensor rule (measures rtol 2e-4, everything else exact)."""
    ref_table = ref_make_dataset("kdd", num_partitions=6, rows_per_partition=64)
    table = carry.table(ref_table)
    old = ingest.build_statistics(table, discrete_counts=True, options=CPU)
    append_partitions(table, _delta(4, seed=31))
    merged = ingest.merge_statistics(
        old, ingest.delta_statistics(table, 6, discrete_counts=True, options=CPU)
    )
    if reference == "port-cold":
        want = ingest.build_statistics(table, discrete_counts=True, options=CPU)
    else:
        ref_old = ref_ingest.build_statistics(ref_table, use_ref=True, discrete_counts=True)
        ref_append_partitions(ref_table, _delta(4, seed=31).columns)
        want = ref_ingest.merge_statistics(ref_old, ref_ingest.delta_statistics(
            ref_table, 6, use_ref=True, discrete_counts=True))
    for col in want:
        assert set(want[col]) == set(merged[col]), col
        for key, w in want[col].items():
            if key == "measures" and reference == "reference":
                np.testing.assert_allclose(merged[col][key], w, rtol=2e-4, atol=2e-4)
            else:
                assert np.array_equal(np.asarray(merged[col][key]), np.asarray(w)), (col, key)


def test_census_flat_for_in_bucket_appends():
    """An in-bucket append changes no stack shape: re-evaluating the
    workload launches the same keys (within `workload_census`), and two
    deltas of one partition bucket run the ingest kernels on the same
    padded shapes."""
    table = make_dataset("kdd", num_partitions=6, rows_per_partition=64)
    queries = WorkloadSpec(table, seed=5).sample_workload(8)
    cache = EvalCache(table, options=CPU)
    assert stack_partitions(6) == 8
    device.TRACES.reset()
    device.eval_workload(table, queries, cache=cache)
    before = set(device.TRACES.counts())
    device.TRACES.reset()
    append_partitions(table, _delta(2, seed=21))  # 6 → 8: still in bucket 8
    device.eval_workload(table, queries, cache=cache)
    assert set(device.TRACES.counts()) == before
    assert cache.stack_appends == 1 and cache.device_stack().shape[1] == 8
    assert before <= device.workload_census(table, queries, cache)

    keys = []
    for parts, seed in ((3, 22), (4, 23)):  # both pad to a bucket of 4 partitions
        start = table.num_partitions
        append_partitions(table, _delta(parts, seed=seed))
        ingest.TRACES.reset()
        ingest.delta_statistics(table, start, discrete_counts=True, options=CPU)
        keys.append(set(ingest.TRACES.counts()))
    assert keys[0] == keys[1] and all(k[1] == 4 for k in keys[0])


def test_bucket_overflow_rebuilds_and_stays_exact():
    table = make_dataset("kdd", num_partitions=6, rows_per_partition=64)
    queries = WorkloadSpec(table, seed=5).sample_workload(6)
    cache = EvalCache(table, options=CPU)
    device.eval_workload(table, queries, cache=cache)
    rebuilds0 = cache.stack_rebuilds
    append_partitions(table, _delta(4, seed=22))  # 6 → 10: overflows bucket 8
    got = device.eval_workload(table, queries, cache=cache)
    assert cache.device_stack().shape[1] == 16
    assert cache.stack_rebuilds == rebuilds0 + 1 and cache.stack_appends == 0
    cold = device.eval_workload(table, queries, cache=EvalCache(table, options=CPU))
    assert_answers_equal(got, cold)


# --------------------------------------------------------------------------
# mergeable-statistic primitives
# --------------------------------------------------------------------------
def test_merge_moments_row_chunks():
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(size=(5, 200))).astype(np.float32) + 0.1

    def moments(a):
        return ops.moments_op(torch.from_numpy(np.ascontiguousarray(a))).numpy()

    full = moments(x)
    merged = ingest.merge_moments(moments(x[:, :80]), moments(x[:, 80:]))
    want = ref_ingest.merge_moments(moments(x[:, :80]), moments(x[:, 80:]))
    assert np.array_equal(merged, want)
    # extrema are exact; sums are re-associated → f32-close, not bitwise
    for i, how in enumerate(ingest._MOMENT_MERGE):
        if how in ("min", "max"):
            np.testing.assert_array_equal(merged[:, i], full[:, i])
    np.testing.assert_allclose(
        ingest.measures_from_moments(merged, 200, positive=True),
        ingest.measures_from_moments(full, 200, positive=True),
        rtol=1e-4, atol=1e-4,
    )


def test_merge_bincounts_realigns_spans_exactly():
    rng = np.random.default_rng(2)
    a_vals = rng.integers(3, 10, size=(4, 100))
    b_vals = rng.integers(-5, 4, size=(4, 60))
    a = _partition_bincount(a_vals - 3, 7)
    b = _partition_bincount(b_vals + 5, 9)
    merged, lo = ingest.merge_bincounts(a, b, lo_a=3, lo_b=-5)
    assert lo == -5
    want = _partition_bincount(np.concatenate([a_vals, b_vals], axis=1) + 5, merged.shape[1])
    np.testing.assert_array_equal(merged, want)
    ref_merged, ref_lo = ref_ingest.merge_bincounts(a, b, lo_a=3, lo_b=-5)
    assert ref_lo == lo and np.array_equal(ref_merged, merged)


def _akmv_cases():
    rng = np.random.default_rng(3)
    return {
        "wide": rng.normal(size=(5, 300)).astype(np.float32),  # d > k on each side
        "few-distinct": rng.integers(0, 9, size=(4, 257)).astype(np.int32),
        "constant": np.full((3, 130), 7.25, np.float32),
        "short": rng.integers(0, 2, size=(2, 64)).astype(np.int32),  # r < k
        # duplicate-heavy: every hash retained on both sides, large counts
        "duplicates": np.random.default_rng(17).integers(0, 6, size=(4, 300)).astype(np.float64),
    }


@pytest.mark.parametrize("n", [AKMV_BLOCK + 1, 3 * AKMV_BLOCK + 5])
def test_akmv_blocks_bit_identical(n):
    """Past ``AKMV_BLOCK`` partitions `_akmv` runs its blocks on a thread
    pool; the result is bit-identical to one pass over every partition
    and to the reference's `_akmv`."""
    rng = np.random.default_rng(n)
    col = np.concatenate([rng.integers(0, 50, size=(n // 2, 200)),
                          rng.integers(0, 10**6, size=(n - n // 2, 200))]).astype(np.int64)
    ndv, freq = _akmv(col)
    one_ndv, one_freq = _akmv_block(col, AKMV_K)
    ref_ndv, ref_freq = ref_sketches._akmv(col)
    for got, want in ((ndv, one_ndv), (freq, one_freq), (ndv, ref_ndv), (freq, ref_freq)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("case", sorted(_akmv_cases()))
def test_akmv_merge_bit_identical(case):
    """Two-way merges at several cuts and a three-way merge give, after
    `akmv_finalize`, the one-pass `_akmv` bits, and the reference's state."""
    col = _akmv_cases()[case]
    ndv0, freq0 = _akmv(col)
    r = col.shape[1]
    for cut in (1, r // 3, r - 1):
        state = merge_akmv_states(akmv_state(col[:, :cut]), akmv_state(col[:, cut:]))
        ndv, freq = akmv_finalize(state)
        np.testing.assert_array_equal(ndv, ndv0)
        np.testing.assert_array_equal(freq, freq0)
        want = ref_sketches.merge_akmv_states(ref_sketches.akmv_state(col[:, :cut]),
                                              ref_sketches.akmv_state(col[:, cut:]))
        for a, b in zip(state, want):
            np.testing.assert_array_equal(a, b)
    thirds = np.array_split(np.arange(r), 3)
    left = merge_akmv_states(
        merge_akmv_states(akmv_state(col[:, thirds[0]]), akmv_state(col[:, thirds[1]])),
        akmv_state(col[:, thirds[2]]),
    )
    ndv, freq = akmv_finalize(left)
    np.testing.assert_array_equal(ndv, ndv0)
    np.testing.assert_array_equal(freq, freq0)


def test_append_disqualifies_discrete_heavy_hitters():
    """A delta with a non-integral value breaks the discrete-numeric
    heavy-hitter qualification of the whole column: the incremental update
    zeroes the old partitions' rows exactly as a cold rebuild decides."""
    schema = (ColumnSpec("d", NUMERIC),)

    def mk(parts, fill):
        return Table(schema, {"d": np.full((parts, 32), fill, np.float32)}, name="disq")

    for backend, opts in OPTIONS.items():
        table = mk(4, 3.0)
        sk0 = build_sketches(table, options=opts)
        assert sk0.columns["d"].discrete_span == (3, 3), backend
        assert sk0.columns["d"].hh_stats[:, 0].min() == 1.0
        append_partitions(table, mk(2, 0.5))  # non-integral value arrives
        got = update_sketches(sk0, table, 4, options=opts)
        assert_sketches_equal(got, build_sketches(table, options=opts))
        assert got.columns["d"].discrete_span is None
        assert np.all(got.columns["d"].hh_stats == 0)


def test_lossy_counting_matches_reference():
    rng = np.random.default_rng(0)
    stream = rng.choice(50, size=4000, p=np.random.default_rng(1).dirichlet(np.ones(50) * 0.3))
    assert lossy_counting(stream, support=0.01) == ref_sketches.lossy_counting(stream, 0.01)


# --------------------------------------------------------------------------
# invalidation
# --------------------------------------------------------------------------
def test_old_nonfinite_routing_matches_cold_rebuild():
    """A column with inf in an OLD partition takes the host path on the
    device backend; the delta evaluation inherits that full-table routing
    (instead of re-deciding from the finite delta rows), or merged sums
    would mix device and host f32 folds."""
    table = make_dataset("kdd", num_partitions=6, rows_per_partition=64)
    col = table.numeric_columns[0]
    table.columns[col][0, 0] = np.inf  # pre-existing non-finite value
    q = Query(
        (Aggregate("sum", ((1.0, col),)),),
        Predicate.conjunction([Clause(table.numeric_columns[1], ">", 0.0)]),
    )
    store = AnswerStore(table, options=CPU)
    store.get_batch([q])
    append_partitions(table, _delta(2, seed=44))  # finite delta rows
    got = store.get_batch([q])
    assert store.carried == 1  # the entry survived and merged
    cold = per_partition_answers_batch(table, [q], options=CPU,
                                       cache=EvalCache(table, options=CPU))
    assert_answers_equal(got, cold)


def test_nonfinite_delta_drops_device_answer_cache():
    """On the device backend a delta bringing inf flips host-fallback
    routing, so the store drops everything — and still answers what a
    cold evaluation answers."""
    table = make_dataset("kdd", num_partitions=4, rows_per_partition=64)
    queries = WorkloadSpec(table, seed=2).sample_workload(4)
    store = AnswerStore(table, options=CPU)
    store.get_batch(queries)
    delta = _delta(2, seed=43)
    delta.columns[delta.numeric_columns[0]][0, 0] = np.inf
    append_partitions(table, delta)
    got = store.get_batch(queries)
    assert store.carried == 0 and store.delta_evals == 0  # nothing merged
    cold = per_partition_answers_batch(table, queries, options=CPU,
                                       cache=EvalCache(table, options=CPU))
    assert_answers_equal(got, cold)


def test_non_append_mutation_still_rebuilds_everything():
    """A wholesale replacement (version bump without a log entry) takes the
    full-rebuild path in the sketch store and drops the answer store."""
    table = make_dataset("kdd", num_partitions=4, rows_per_partition=64)
    queries = WorkloadSpec(table, seed=2).sample_workload(3)
    store = SketchStore(table, options=OPTIONS["host"])
    answers = AnswerStore(table, options=OPTIONS["host"])
    answers.get_batch(queries)
    table.columns = table.shuffled(seed=5).columns
    table.version += 1  # declared non-append mutation
    sk = store.sketches()
    assert store.full_rebuilds == 1 and store.incremental_updates == 0
    assert_sketches_equal(sk, build_sketches(table, options=OPTIONS["host"]))
    got = answers.get_batch(queries)
    assert answers.carried == 0 and answers.misses == 2 * len(queries)
    assert_answers_equal(got, per_partition_answers_batch(table, queries,
                                                          options=OPTIONS["host"]))


# --------------------------------------------------------------------------
# merge primitives under compaction-shaped inputs
# --------------------------------------------------------------------------
def test_merge_discrete_span_cap_disqualification():
    """The span union disqualifies exactly at the width cap, and a
    disqualified side poisons the union — as the reference decides."""
    cap = ingest.MAX_DISCRETE_WIDTH
    cases = [((0, 10), (5, 20)), ((0, cap - 1), (0, 0)), ((0, cap), (0, 0)),
             ((-4, 0), (cap - 4, cap - 4)), (None, (0, 1)), ((0, 1), None)]
    got = [ingest.merge_discrete_span(a, b) for a, b in cases]
    assert got == [(0, 20), (0, cap - 1), None, None, None, None]
    assert got == [ref_ingest.merge_discrete_span(a, b) for a, b in cases]


def test_fold_partition_spans_requalifies_survivors():
    """Per-partition spans re-fold after a gather: dropping the wide
    partition re-qualifies the survivors; a non-integral partition stays
    disqualified."""
    wide = np.array([[0.0] * 31 + [float(ingest.MAX_DISCRETE_WIDTH)]])
    narrow = np.tile(np.arange(32, dtype=np.float64)[None, :], (3, 1))
    spans = ingest.partition_int_spans(np.concatenate([narrow, wide], axis=0))
    assert ingest.fold_partition_spans(spans) is None  # cap exceeded
    survivors = spans[:3]
    assert ingest.fold_partition_spans(survivors) == (0, 32)
    frac = ingest.partition_int_spans(np.array([[0.5] * 4]))
    assert frac[0, 2] == 0
    both = np.concatenate([survivors, frac], axis=0)
    assert ingest.fold_partition_spans(both) is None
    for s in (spans, survivors, both):
        assert ingest.fold_partition_spans(s) == ref_ingest.fold_partition_spans(s)


def test_merge_primitives_accept_empty_partition_batches():
    """Zero-partition inputs flow through every merge primitive and give
    shape-correct empty results."""
    empty = np.empty((0, 64))
    assert ingest.merge_moments(np.empty((0, 8)), np.empty((0, 8))).shape == (0, 8)
    merged, lo = ingest.merge_bincounts(np.zeros((0, 5)), np.zeros((0, 3)), lo_a=2, lo_b=0)
    assert merged.shape == (0, 7) and lo == 0
    h, c, d = merge_akmv_states(akmv_state(empty), akmv_state(empty))
    assert h.shape[0] == 0 and c.shape[0] == 0 and d.shape == (0,)
    ndv, freq = akmv_finalize((h, c, d))
    assert ndv.shape == (0,) and freq.shape == (0, 4)
    assert ingest.partition_int_spans(empty).shape == (0, 3)
    assert ingest.fold_partition_spans(np.zeros((0, 3), np.int64)) is None
