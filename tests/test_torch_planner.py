"""The port's error-bounded planner and `Session` vs the JAX reference.

One tpch table (32 partitions x 256 rows) and one reference picker,
trained once on 8 queries; the port's `Session` gets that picker grafted
in (`carry.picker`, the graft of `benchmarks/bench_serving_load.py`), so
both packages plan from the same forests, taus and sketches.  On the
same held-out queries, at 2/5/10% error bounds and a fixed ``budget=``,
the port must read the same partitions in the same rounds and return
the same group keys.  Its estimates and CI halfwidths are bit-equal on
the host backend.  On the device backend the estimates agree within
rtol 1e-5 (the reference's f32-sum tolerance, `tests/test_fused_eval.py`):
the device backend sums rows in f32, the reference here in f64.  A
halfwidth is the spread of those per-partition sums, where f32 rounding
relative to the sums themselves shows, so it is held within 1e-5 of the
halfwidth plus the estimate's magnitude.

Around it: `Session` contract tests ported from `tests/test_planner.py`
(`QuerySpec` validation, prepare-before-execute, execute contracts, view
mode), `Session.prepare` on the port itself, and the `AnswerStore`
(subset keys, LRU, TTL, invalidation on mutation).
"""
import numpy as np
import pytest

import repro.api as ref_api
from repro.backends import ExecOptions as RefExecOptions
from repro.core.picker import PickerConfig as RefPickerConfig
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro_torch import api, carry
from repro_torch.backends import ExecOptions
from repro_torch.core.features import FeatureBuilder
from repro_torch.core.picker import PickerConfig
from repro_torch.data.datasets import make_dataset
from repro_torch.data.table import append_partitions
from repro_torch.planner import QueryPlanner
from repro_torch.planner.planner import _merge_raw
from repro_torch.queries.engine import AnswerStore, per_partition_answers
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.queries.ir import Aggregate, Predicate, Query
import torch_threads

torch_threads.cap_under_xdist()

HOST = ExecOptions(backend="host")
DEVICE = ExecOptions(device="cpu")
BOUNDS = (0.02, 0.05, 0.10)


@pytest.fixture(scope="module")
def reference():
    """The reference session (host backend) with its trained picker, and
    six held-out queries."""
    ref_table = ref_make_dataset("tpch", num_partitions=32, rows_per_partition=256, seed=0)
    sess = ref_api.Session(ref_table, options=RefExecOptions(backend="host"))
    sess.prepare(RefWorkloadSpec(ref_table, seed=1), num_train_queries=8,
                 picker_config=RefPickerConfig(num_trees=8, tree_depth=3,
                                               feature_selection=False))
    queries = RefWorkloadSpec(ref_table, seed=7).sample_workload(6)
    return sess, queries


def _grafted(ref_sess, options):
    table = carry.table(ref_sess.table)
    sess = api.Session(table, options=options)
    fb = FeatureBuilder(table, carry.sketches(ref_sess.picker.fb.sk))
    sess.picker = carry.picker(ref_sess.picker, table, fb, options=options)
    sess.planner = QueryPlanner(sess.picker, sess.answers, views=sess.views,
                                config=sess.planner_config)
    sess._fb_version = table.version
    return sess


def _specs(ref_query, query):
    for b in BOUNDS:
        yield ref_api.QuerySpec(ref_query, error_bound=b), api.QuerySpec(query, error_bound=b)
    yield ref_api.QuerySpec(ref_query, budget=12), api.QuerySpec(query, budget=12)


@pytest.mark.parametrize("options", [HOST, DEVICE], ids=["host", "device"])
def test_execute_with_grafted_picker_matches_reference(reference, options):
    ref_sess, ref_queries = reference
    sess = _grafted(ref_sess, options)
    n_read = 0
    for rq, q in zip(ref_queries, carry.queries(ref_queries)):
        for ref_spec, spec in _specs(rq, q):
            want = ref_sess.execute(ref_spec)
            got = sess.execute(spec)
            assert got.partitions_read == want.partitions_read
            np.testing.assert_array_equal(got.group_keys, want.group_keys)
            assert (got.plan.mode, got.plan.rounds, got.plan.schedule, got.plan.candidates,
                    got.plan.outliers, got.plan.strata_sizes) == (
                want.plan.mode, want.plan.rounds, want.plan.schedule, want.plan.candidates,
                want.plan.outliers, want.plan.strata_sizes)
            if options.backend == "host":
                np.testing.assert_array_equal(got.estimate, want.estimate)
                np.testing.assert_array_equal(got.ci_halfwidth, want.ci_halfwidth)
                assert got.plan.predicted_error == want.plan.predicted_error
            else:
                np.testing.assert_allclose(got.estimate, want.estimate, rtol=1e-5)
                # a halfwidth is a spread of per-partition sums, so their
                # f32 rounding counts against the estimate's magnitude
                scale = np.abs(np.nan_to_num(want.estimate))
                err = np.abs(got.ci_halfwidth - want.ci_halfwidth)
                assert np.all(err <= 1e-5 * (np.abs(want.ci_halfwidth) + scale))
            n_read += got.partitions_read
    assert 0 < n_read < 4 * len(ref_queries) * 32  # the planner did sample
    assert sess.stats()["executed"] == 4 * len(ref_queries)


def _rel_err(keys_e, est, keys_t, truth) -> float:
    """The reference's calibration metric (`tests/test_planner.py`): mean over
    truth groups × aggregates of the capped relative error; a missed group
    scores 1.0."""
    lut = {int(k): i for i, k in enumerate(keys_e)}
    errs = []
    for gi, k in enumerate(keys_t):
        i = lut.get(int(k))
        for j in range(truth.shape[1]):
            t = truth[gi, j]
            if np.isnan(t):
                continue
            if i is None or np.isnan(est[i, j]):
                errs.append(1.0)
            else:
                errs.append(min(abs(est[i, j] - t) / max(abs(t), 1e-12), 1.0))
    return float(np.mean(errs)) if errs else 0.0


@pytest.mark.parametrize("mesh", [2, 8], ids=["mesh2", "mesh8"])
def test_calibration_on_a_plane(reference, mesh):
    """The plane lanes of the reference's calibration sweep (device
    backend, its 6 queries) on ``mesh`` logical CPU shards: every planned
    answer equals the single-device port's byte for byte (estimates, CI
    halfwidths, group keys, partitions read), and the error is within the
    5% bound on at least 90% of the queries, as the reference demands."""
    ref_sess, ref_queries = reference
    plane = _grafted(ref_sess, DEVICE.replace(mesh=mesh))
    single = _grafted(ref_sess, DEVICE)
    assert plane.answers.plane.num_devices == mesh and single.answers.plane is None
    hits = 0
    for q in carry.queries(ref_queries):
        got = plane.execute(api.QuerySpec(q, error_bound=0.05))
        want = single.execute(api.QuerySpec(q, error_bound=0.05))
        for field in ("group_keys", "estimate", "ci_halfwidth"):
            assert getattr(got, field).tobytes() == getattr(want, field).tobytes(), field
        assert got.partitions_read == want.partitions_read
        truth = per_partition_answers(plane.table, q, options=HOST)
        hits += _rel_err(got.group_keys, got.estimate, truth.group_keys, truth.truth()) <= 0.05
    assert hits / len(ref_queries) >= 0.9, f"{hits}/{len(ref_queries)} within 0.05"


def test_execute_batch_matches_reference(reference):
    ref_sess, ref_queries = reference
    sess = _grafted(ref_sess, HOST)
    want = ref_sess.execute_batch([ref_api.QuerySpec(q, error_bound=0.05) for q in ref_queries])
    got = sess.execute_batch([api.QuerySpec(q, error_bound=0.05)
                              for q in carry.queries(ref_queries)])
    assert len(got) == len(want) == len(ref_queries)
    for g, w in zip(got, want):
        assert g.partitions_read == w.partitions_read
        np.testing.assert_array_equal(g.group_keys, w.group_keys)
        np.testing.assert_array_equal(g.estimate, w.estimate)
    assert sess.stats()["executed"] == len(ref_queries)


def test_merge_raw_keeps_rows_of_zero_group_chunks():
    keys, raw = _merge_raw(np.array([1, 3]), np.ones((2, 2, 1)), np.empty(0, np.int64),
                           np.zeros((3, 0, 1)))
    assert raw.shape == (5, 2, 1)
    np.testing.assert_array_equal(keys, [1, 3])


# --------------------------------------------------------------------------
# Session contracts (ported from tests/test_planner.py)
# --------------------------------------------------------------------------
def _mk_query(table):
    gcol = table.groupable_columns[0]
    return Query((Aggregate("count"),), Predicate(), (gcol,))


def test_queryspec_exactly_one_contract():
    q = _mk_query(make_dataset("kdd", num_partitions=4, rows_per_partition=64))
    with pytest.raises(ValueError, match="exactly one"):
        api.QuerySpec(q)
    with pytest.raises(ValueError, match="exactly one"):
        api.QuerySpec(q, error_bound=0.05, budget=4)
    with pytest.raises(ValueError, match="error_bound"):
        api.QuerySpec(q, error_bound=1.5)
    with pytest.raises(ValueError, match="latency_bound"):
        api.QuerySpec(q, latency_bound=0.0)
    with pytest.raises(ValueError, match="budget"):
        api.QuerySpec(q, budget=0)
    assert api.QuerySpec(q, error_bound=0.05).error_bound == 0.05


@pytest.fixture(scope="module")
def session():
    """A port Session prepared by the port itself (device backend, CPU)."""
    table = make_dataset("kdd", num_partitions=16, rows_per_partition=64)
    sess = api.Session(table, options=DEVICE)
    sess.prepare(WorkloadSpec(table, seed=1), num_train_queries=10,
                 picker_config=PickerConfig(num_trees=8, tree_depth=3))
    return sess


def test_session_requires_prepare():
    table = make_dataset("kdd", num_partitions=4, rows_per_partition=64)
    sess = api.Session(table, options=HOST)
    with pytest.raises(RuntimeError, match="prepare"):
        sess.execute(_mk_query(table))


def test_session_prepare_trains_a_picker(session):
    picker = session.picker
    assert picker.funnel.num_models == 4
    assert all(f.num_trees == 8 and f.depth == 3 for f in picker.funnel.forests)
    assert picker.cluster_mask.shape == (picker.fb.schema.dim,)
    assert 0 < picker.cluster_mask.sum() <= picker.fb.schema.dim  # Algorithm 3 ran


def test_session_execute_contracts(session):
    q = _mk_query(session.table)
    # a bare Query defaults to the 5% error-bound contract
    ans = session.execute(q)
    assert ans.plan.error_bound == 0.05
    ans = session.execute(api.QuerySpec(q, budget=6))
    assert ans.plan.budget == 6 and ans.plan.rounds == 1
    # latency bound converts through the read-rate EMA (one chunk before
    # any observation exists, rate-derived afterwards)
    ans = session.execute(api.QuerySpec(q, latency_bound=0.5))
    assert ans.plan.budget >= 1
    stats = session.stats()
    assert stats["executed"] == 3 and stats["read_rate_ema"] is not None
    assert stats["num_partitions"] == session.table.num_partitions


def test_session_view_mode(session):
    q = _mk_query(session.table)
    session.register_view(q.groupby, q.aggregates)
    ans = session.execute(api.QuerySpec(q, error_bound=0.05))
    assert ans.plan.mode == "view" and ans.partitions_read == 0
    assert np.all(ans.ci_halfwidth == 0)
    truth = per_partition_answers(session.table, q, options=HOST)
    np.testing.assert_array_equal(ans.group_keys, truth.group_keys)
    np.testing.assert_allclose(ans.estimate, truth.truth(), rtol=1e-12)


def test_session_refreshes_after_append():
    table = make_dataset("kdd", num_partitions=12, rows_per_partition=64)
    sess = api.Session(table, options=HOST)
    sess.prepare(WorkloadSpec(table, seed=1), num_train_queries=8,
                 picker_config=PickerConfig(num_trees=4, tree_depth=2,
                                            feature_selection=False))
    q = _mk_query(table)
    sess.execute(api.QuerySpec(q, error_bound=0.10))
    append_partitions(table, make_dataset("kdd", num_partitions=3, rows_per_partition=64,
                                          layout="random", seed=21))
    ans = sess.execute(api.QuerySpec(q, budget=15))
    assert sess.picker.fb.sk.num_partitions == 15
    stats = sess.stats()
    assert stats["sketch_incremental_updates"] == 1 and stats["sketch_full_rebuilds"] == 0
    truth = per_partition_answers(table, q, options=HOST)
    assert ans.plan.mode == "exact"
    np.testing.assert_array_equal(ans.group_keys, truth.group_keys)
    np.testing.assert_allclose(ans.estimate, truth.truth(), rtol=1e-12)


# --------------------------------------------------------------------------
# AnswerStore
# --------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_answer_store_subsets_lru_ttl_and_invalidation():
    table = make_dataset("tpch", num_partitions=8, rows_per_partition=64)
    clock = _Clock()
    store = AnswerStore(table, capacity=2, options=HOST, ttl=10.0, clock=clock)
    qs = WorkloadSpec(table, seed=2).sample_workload(3)
    full = per_partition_answers(table, qs[0], options=HOST)
    # a subset is its own entry, never the full answer
    sub = store.get_subset(qs[0], np.array([5, 1, 1]))
    np.testing.assert_array_equal(sub.raw, full.raw[[5, 1, 1]][:, np.isin(full.group_keys,
                                                                          sub.group_keys)])
    assert store.get(qs[0]).raw.shape[0] == 8 and store.misses == 2
    assert store.get_subset(qs[0], np.array([5, 1, 1])) is sub and store.hits == 1
    # with the full answer held, a new subset is sliced from it
    store.get_subset(qs[0], np.array([2]))
    assert store.misses == 2 and store.hits == 2
    # LRU of capacity 2 over the full answers; a batch evaluates misses once
    out = store.get_batch([qs[1], qs[2], qs[1]])
    assert out[0] is out[2] and len(store) == 2
    # TTL: an entry older than ttl is evaluated again
    clock.t = 11.0
    store.get(qs[2])
    assert store.ttl_expired == 1
    # an append keeps every entry and folds the new partition into it
    append_partitions(table, make_dataset("tpch", num_partitions=1, rows_per_partition=64,
                                          seed=3))
    assert store.get(qs[2]).raw.shape[0] == 9
    assert len(store) == 2 and store.carried == 1
    # any other table mutation drops every entry
    table.version += 1
    assert store.get(qs[2]).raw.shape[0] == 9
    assert len(store) == 1
