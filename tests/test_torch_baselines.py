"""The port's sampling baselines (`core/baselines.py`) vs the JAX reference.

Random, Random+Filter and LSS draw every sample from the caller's numpy
rng (or seed) in the reference's order, so on the same inputs the port
must pick the reference's partition ids and weights exactly.  LSS runs
over one tpch table (32 partitions x 256 rows) with the reference's
features carried over (`carry.sketches`) and the reference's trained
sampler carried in (`carry.lss`); the port's own `train_lss` on the host
backend must fit the reference's forest bit for bit and pick the same
strata count.
"""
import numpy as np
import pytest

from repro.core import baselines as ref_baselines
from repro.core.features import FeatureBuilder as RefFeatureBuilder
from repro.core.sketches import build_sketches as ref_build_sketches
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.queries.engine import per_partition_answers_batch as ref_answers_batch
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro.backends import ExecOptions as RefExecOptions
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.core import baselines
from repro_torch.core.features import FeatureBuilder
from repro_torch.queries.engine import per_partition_answers_batch

HOST = ExecOptions(backend="host")


@pytest.mark.parametrize("n,budget,seed", [(32, 5, 0), (100, 100, 1), (7, 20, 2), (1000, 37, 3)])
def test_uniform_select_matches_reference(n, budget, seed):
    got = baselines.uniform_select(n, budget, np.random.default_rng(seed))
    want = ref_baselines.uniform_select(n, budget, np.random.default_rng(seed))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("m,budget,seed", [(20, 6, 0), (5, 9, 1), (0, 4, 2), (300, 1, 3)])
def test_uniform_filter_select_matches_reference(m, budget, seed):
    cands = np.sort(np.random.default_rng(99).choice(1000, size=m, replace=False))
    got = baselines.uniform_filter_select(cands, budget, np.random.default_rng(seed))
    want = ref_baselines.uniform_filter_select(cands, budget, np.random.default_rng(seed))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def lss():
    """The reference's LSS trained on 8 queries (host backend) and the
    port's inputs carried from it."""
    ref_table = ref_make_dataset("tpch", num_partitions=32, rows_per_partition=256, seed=0)
    ref_fb = RefFeatureBuilder(ref_table, ref_build_sketches(ref_table, options=RefExecOptions(backend="host")))
    ref_queries = RefWorkloadSpec(ref_table, seed=1).sample_workload(8)
    ref_ans = ref_answers_batch(ref_table, ref_queries, options=RefExecOptions(backend="host"))
    feats = [ref_fb.features(q) for q in ref_queries]
    contribs = [a.contribution() for a in ref_ans]
    kw = dict(strata_grid=(2, 4, 8), num_trees=6, depth=3, seed=0)
    ref_sampler = ref_baselines.train_lss(ref_fb, feats, contribs, ref_ans, ref_queries, **kw)
    table = carry.table(ref_table)
    fb = FeatureBuilder(table, carry.sketches(ref_fb.sk))
    queries = carry.queries(ref_queries)
    answers = per_partition_answers_batch(table, queries, options=HOST)
    return dict(ref_sampler=ref_sampler, ref_queries=ref_queries, fb=fb, queries=queries,
                feats=feats, contribs=contribs, answers=answers, kw=kw)


def test_lss_pick_matches_reference(lss):
    sampler = carry.lss(lss["ref_sampler"], lss["fb"])
    held_out = RefWorkloadSpec(lss["ref_sampler"].fb.table, seed=7).sample_workload(6)
    picked = 0
    for rq, q in zip(lss["ref_queries"] + held_out, lss["queries"] + carry.queries(held_out)):
        for budget, seed in ((3, 0), (8, 4), (40, 1)):
            got = sampler.pick(q, budget, seed)
            want = lss["ref_sampler"].pick(rq, budget, seed)
            for g, w in zip(got, want, strict=True):
                np.testing.assert_array_equal(g, w)
            picked += got[0].size
    assert picked > 0


def test_train_lss_host_matches_reference(lss):
    got = baselines.train_lss(lss["fb"], lss["feats"], lss["contribs"], lss["answers"],
                              lss["queries"], options=HOST, **lss["kw"])
    want = lss["ref_sampler"]
    assert got.num_strata == want.num_strata
    np.testing.assert_array_equal(got.model.feat, want.model.feat)
    np.testing.assert_array_equal(got.model.thr, want.model.thr)
    np.testing.assert_array_equal(got.model.leaf.view(np.uint32),
                                  want.model.leaf.view(np.uint32))
    assert got.model.base == want.model.base
