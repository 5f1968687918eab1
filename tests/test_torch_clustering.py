"""The port's picker front half (features, outliers, KMeans, feature
selection) vs the JAX reference, on the CPU.

* pdist_sq's plain version against the reference oracle at the
  reference's own tolerance (rtol 1e-4, atol 1e-3; `tests/test_kernels.py`);
* KMeans selections on tie-free blobs: ids and weights equal.  The
  distances differ from the reference's in the last bits (another
  summation order), so where exact arithmetic ties — the two members of
  a 2-member cluster are equidistant from its median — either package
  may pick either member; the tests avoid such ties, as the reference's
  own contract does;
* `FeatureBuilder` over sketches carried from the reference: features,
  batches and selectivities byte-equal;
* `find_outliers` and `select_features` (on tie-free blob features):
  equal selections; `PS3Picker.pick` with a carried picker: equal
  selections without clustering, equal groups, budgets and cluster
  weights with it.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clustering as ref_clustering
from repro.core import featsel as ref_featsel
from repro.core import outliers as ref_outliers
from repro.core.features import FeatureBuilder as RefFeatureBuilder
from repro.core.picker import PickerConfig as RefPickerConfig
from repro.core.picker import train_picker as ref_train_picker
from repro.core.sketches import build_sketches as ref_build_sketches
from repro.backends import ExecOptions as RefExecOptions
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.kernels import ref as ref_kernels
from repro.queries.engine import per_partition_answers_batch as ref_answers_batch
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.core import clustering, featsel, outliers
from repro_torch.core.features import FeatureBuilder
from repro_torch.kernels import ops
from repro_torch.queries.engine import per_partition_answers_batch
import torch_threads

torch_threads.cap_under_xdist()

CPU = "cpu"


def _blobs(n, f, k, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, f)) * spread
    lab = rng.integers(0, k, size=n)
    return (centers[lab] + rng.normal(size=(n, f))).astype(np.float32)


@pytest.mark.parametrize("n,k,f", [(16, 4, 8), (100, 13, 37), (256, 128, 130), (33, 5, 300)])
def test_pdist_plain_matches_ref(n, k, f):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, f)).astype(np.float32)
    c = rng.normal(size=(k, f)).astype(np.float32)
    got = ops.pdist_sq_op(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want = np.asarray(ref_kernels.pdist_sq_ref(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert (got >= 0).all()


def test_pdist_plain_argmin_matches_ref():
    x = _blobs(200, 12, 6, seed=1)
    c = _blobs(6, 12, 6, seed=1)
    got = ops.pdist_sq_op(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want = np.asarray(ref_kernels.pdist_sq_ref(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_array_equal(got.argmin(axis=1), want.argmin(axis=1))


@pytest.mark.parametrize("n,f,k,budget", [(90, 6, 5, 5), (200, 8, 12, 12), (300, 16, 9, 20),
                                          (64, 4, 3, 1)])
def test_kmeans_select_matches_reference(n, f, k, budget):
    x = _blobs(n, f, k, seed=n)
    ids, wts = clustering.kmeans_select(x, budget, device=CPU)
    rids, rwts = ref_clustering.kmeans_select(x, budget)
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(wts, rwts)
    assert wts.sum() == n


def test_kmeans_select_unbiased_matches_reference():
    x = _blobs(150, 6, 7, seed=4)
    for seed in (0, 3):
        got = clustering.kmeans_select_unbiased(x, 7, seed=seed, device=CPU)
        want = ref_clustering.kmeans_select_unbiased(x, 7, seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_kmeans_fit_and_medians_match_reference():
    x = _blobs(120, 5, 4, seed=9)
    centers, assign = clustering.kmeans_fit(x, 4, device=CPU)
    rcenters, rassign = ref_clustering.kmeans_fit(x, 4)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(rassign))
    np.testing.assert_allclose(centers.numpy(), np.asarray(rcenters), rtol=1e-5, atol=1e-5)
    med = clustering.cluster_medians(x, assign.numpy(), 4, device=CPU).numpy()
    np.testing.assert_array_equal(med, np.asarray(ref_clustering.cluster_medians(x, rassign, 4)))


def test_select_exemplars_matches_reference_with_empty_clusters():
    x = _blobs(50, 4, 3, seed=2)
    assign = np.random.default_rng(0).integers(0, 5, size=50)
    assign[assign == 2] = 1  # cluster 2 empty
    got = clustering.select_exemplars(x, assign, 6, device=CPU)
    want = ref_clustering.select_exemplars(x, jnp.asarray(assign), 6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert not got[2][2] and not got[2][5]


def test_kmeans_padding_invariance():
    """Rows and clusters padded to power-of-two buckets select what the
    unpadded problem does: 60 rows pad to 64, 61 rows to 64, 65 to 128."""
    base = _blobs(65, 5, 6, seed=12)
    for n in (60, 61, 65):
        ids, wts = clustering.kmeans_select(base[:n], 6, device=CPU)
        rids, rwts = ref_clustering.kmeans_select(base[:n], 6)
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(wts, rwts)
    clustering.reset_trace_counts()
    clustering.kmeans_select(base[:60], 6, device=CPU)
    assert clustering.trace_counts() == {("kmeans_select", 64, 8): 1}


def test_hac_select_matches_reference():
    x = _blobs(40, 3, 4, seed=6).astype(np.float64)
    for linkage in ("ward", "single"):
        got = clustering.hac_select(x, 4, linkage, device=CPU)
        want = ref_clustering.hac_select(x, 4, linkage)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        clustering.kmeans_select(_blobs(20, 3, 2, seed=0), 2)


# --------------------------------------------------------------------------
# features, outliers, feature selection, pick
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tpch():
    """tpch 32 x 256 with the reference's host sketches, carried over."""
    ref_table = ref_make_dataset("tpch", num_partitions=32, rows_per_partition=256, seed=0)
    ref_sk = ref_build_sketches(ref_table, options=RefExecOptions(backend="host"))
    table = carry.table(ref_table)
    ref_fb = RefFeatureBuilder(ref_table, ref_sk)
    fb = FeatureBuilder(table, carry.sketches(ref_sk))
    ref_queries = RefWorkloadSpec(ref_table, seed=1).sample_workload(10)
    return ref_table, table, ref_fb, fb, ref_queries, carry.queries(ref_queries)


def test_feature_builder_from_carried_sketches_is_byte_equal(tpch):
    ref_table, table, ref_fb, fb, ref_queries, queries = tpch
    np.testing.assert_array_equal(fb.raw, ref_fb.raw)
    np.testing.assert_array_equal(fb.normalizer, ref_fb.normalizer)
    for rq, q in zip(ref_queries, queries):
        np.testing.assert_array_equal(fb.features(q), ref_fb.features(rq))
        np.testing.assert_array_equal(fb.selectivity(q), ref_fb.selectivity(rq))
        np.testing.assert_array_equal(fb.column_mask(q), ref_fb.column_mask(rq))
    for a, b in zip(fb.features_batch(queries), ref_fb.features_batch(ref_queries)):
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(fb.schema) == dataclasses.asdict(ref_fb.schema)


def test_find_outliers_matches_reference():
    rng = np.random.default_rng(8)
    bits = (rng.random((60, 7)) < 0.1).astype(np.float64)
    bits[:40] = bits[0]  # one big bitmap group, a tail of rare ones
    cands = np.arange(100, 160)
    for cap in (0, 3, 50):
        np.testing.assert_array_equal(outliers.find_outliers(cands, bits, cap),
                                      ref_outliers.find_outliers(cands, bits, cap))


def test_select_features_matches_reference():
    """Algorithm 3 over real answers and tie-free clustering inputs: blob
    features of odd cluster sizes (one KMeans cluster per blob)."""
    ref_table = ref_make_dataset("tpch", num_partitions=95, rows_per_partition=64, seed=2)
    ref_sk = ref_build_sketches(ref_table, options=RefExecOptions(backend="host"))
    table = carry.table(ref_table)
    ref_fb = RefFeatureBuilder(ref_table, ref_sk)
    fb = FeatureBuilder(table, carry.sketches(ref_sk))
    ref_queries = RefWorkloadSpec(ref_table, seed=3).sample_workload(4)
    ref_ans = ref_answers_batch(ref_table, ref_queries, options=RefExecOptions(backend="host"))
    ans = per_partition_answers_batch(table, carry.queries(ref_queries),
                                      options=ExecOptions(backend="host"))
    rng = np.random.default_rng(0)
    sizes = (15, 17, 19, 21, 23)  # 95 partitions: 5 blobs of odd sizes
    lab = np.repeat(np.arange(5), sizes)
    feats = []
    for _ in ref_queries:
        centers = rng.normal(size=(5, fb.schema.dim)) * 5.0
        feats.append(centers[lab] + rng.normal(size=(95, fb.schema.dim)))
    kw = dict(num_eval_queries=3, num_restarts=2, budget_fracs=(0.05,), seed=0)
    want = ref_featsel.select_features(ref_fb, feats, ref_ans, **kw)
    got = featsel.select_features(fb, feats, ans, device=CPU, **kw)
    np.testing.assert_array_equal(got, want)
    assert featsel.kind_groups() == ref_featsel.kind_groups()


def test_pick_with_carried_picker_matches_reference(tpch):
    ref_table, table, ref_fb, fb, ref_queries, queries = tpch
    cfg = RefPickerConfig(num_trees=6, tree_depth=3, feature_selection=False)
    art = ref_train_picker(ref_table, RefWorkloadSpec(ref_table, seed=1), queries=ref_queries,
                           config=cfg, fb=ref_fb, options=RefExecOptions(backend="host"))
    picker = carry.picker(art.picker, table, fb, options=ExecOptions(device=CPU))
    for rq, q in zip(ref_queries, queries):
        for budget in (4, 9):
            got = picker.pick(q, budget, use_clustering=False, seed=5)
            want = art.picker.pick(rq, budget, use_clustering=False, seed=5)
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.weights, want.weights)
            # with clustering: 2-member clusters tie exactly at their
            # median, so only the groups, budgets and weights must agree
            got = picker.pick(q, budget)
            want = art.picker.pick(rq, budget)
            assert (got.num_outliers, got.group_sizes, got.group_budgets) == (
                want.num_outliers, want.group_sizes, want.group_budgets)
            np.testing.assert_array_equal(np.sort(got.weights), np.sort(want.weights))
