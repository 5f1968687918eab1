"""The port's query-eval driver (CPU device) vs the JAX reference.

`repro_torch.queries.device.eval_workload` on a CPU torch device runs the
same driver as on a GPU, with the plain versions of fused_eval and
group_aggregate.  Inputs are made with numpy from a seed (the reference's
`edge_table`/`edge_queries` and a 48-query `WorkloadSpec` workload) and
carried across with `repro_torch.carry`.  Group keys and counts must be
bit-equal to the reference's host path and its jitted ``use_ref=True``
path; sums agree at the reference's own tolerance (rtol 1e-5, atol
1e-4).  The launch-key census must equal the reference's compile census.
"""
import numpy as np
import pytest
import torch

from repro.data.datasets import make_dataset as ref_make_dataset
from repro.data.table import concat_tables
from repro.queries import device as ref_device
from repro.queries import engine as ref_engine
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.data.table import append_partitions
from repro_torch.errors import StaleStateError
from repro_torch.queries import device, engine
from repro_torch.queries.ir import Aggregate, Clause, Predicate, Query

from test_query_device import edge_queries, edge_table
import torch_threads

torch_threads.cap_under_xdist()

CPU = ExecOptions(device="cpu")


def assert_answers_match(ref, port, exact=False):
    np.testing.assert_array_equal(ref.group_keys, port.group_keys)
    np.testing.assert_array_equal(ref.raw[:, :, 0], port.raw[:, :, 0])  # counts
    if exact:
        np.testing.assert_array_equal(ref.raw, port.raw)
    else:
        np.testing.assert_allclose(port.raw, ref.raw, rtol=1e-5, atol=1e-4)


def _reference(lowering, table, queries):
    cache = ref_engine.EvalCache(table)
    if lowering == "host":
        return ref_engine.per_partition_answers_batch(
            table, queries, cache=cache, options=ref_engine.ExecOptions(backend="host")
        )
    return ref_device.eval_workload(table, queries, cache=cache, use_ref=True)


def _port(table, queries):
    t = carry.table(table)
    cache = engine.EvalCache(t, options=CPU)
    return device.eval_workload(t, carry.queries(queries), cache=cache), t, cache


@pytest.mark.parametrize("lowering", ["host", "xla-ref"])
def test_edge_cases_match_reference(lowering):
    table = edge_table()
    queries = edge_queries()
    want = _reference(lowering, table, queries)
    got, _, _ = _port(table, queries)
    for w, g in zip(want, got):
        assert_answers_match(w, g)


@pytest.fixture(scope="module")
def tpch_workload():
    table = ref_make_dataset("tpch", num_partitions=16, rows_per_partition=1000, seed=0)
    return table, RefWorkloadSpec(table, seed=0).sample_workload(48)


@pytest.mark.parametrize("lowering", ["host", "xla-ref"])
def test_workload_matches_reference(tpch_workload, lowering):
    table, queries = tpch_workload
    want = _reference(lowering, table, queries)
    got, _, _ = _port(table, queries)
    for w, g in zip(want, got):
        assert_answers_match(w, g)


def test_workload_census_matches_reference(tpch_workload):
    table, queries = tpch_workload
    want = ref_device.workload_census(table, queries, ref_engine.EvalCache(table))
    device.TRACES.reset()
    _, t, cache = _port(table, queries)
    census = device.workload_census(t, carry.queries(queries), cache)
    assert census == want
    assert set(device.TRACES.counts()) == census  # every launch key is a census key
    assert device.TRACES.total() < len(queries) / 2  # stacking batches queries


def test_host_backend_is_bit_identical(tpch_workload):
    table, queries = tpch_workload
    want = _reference("host", table, queries[:12])
    t = carry.table(table)
    got = engine.per_partition_answers_batch(
        t, carry.queries(queries[:12]), options=CPU.replace(backend="host")
    )
    for w, g in zip(want, got):
        assert_answers_match(w, g, exact=True)


def test_kernel_operands_are_what_the_kernels_take(tpch_workload):
    """The driver hands each kernel dense f32/int32 operands of the shapes
    its CUDA launcher checks — on the CPU too, where nothing checks them."""
    table, queries = tpch_workload
    t = carry.table(table)
    cache = engine.EvalCache(t, options=CPU)
    chunks, _ = device.plan_launches(t, carry.queries(queries), cache)
    kinds = set()
    for chunk in chunks:
        name, args = device.kernel_call([p for _, p in chunk], cache)
        kinds.add(name)
        tensors = args[:-1]
        assert all(a.is_contiguous() for a in tensors)
        assert [a.dtype for a in tensors][-1] == torch.int32  # codes
        assert all(a.dtype == torch.float32 for a in tensors[:-1])
        assert isinstance(args[-1], int)
    assert kinds == {"fused_eval", "group_aggregate"}


@pytest.mark.parametrize("seed", [3, 8, 9])
def test_fallbacks_route_like_reference(seed):
    """Inexpressible predicates and non-finite columns take the host path
    on both, with exact answers."""
    table = edge_table(seed=seed)
    table.columns["x"][1, 3] = np.nan
    table.columns["x"][0, :5] = np.inf
    queries = edge_queries() + [
        Query((Aggregate("count"),), Predicate.conjunction([Clause("x", "!=", 0.5)])),
        Query((Aggregate("count"),), Predicate.conjunction([Clause("g", "in", (0, 1.5))])),
        Query((Aggregate("count"),), Predicate.conjunction([Clause("pos", "<=", 0.0)])),
        Query((Aggregate("sum", ((1.0, "x"),)),), Predicate.conjunction(
            [Clause("pos", ">", 1.0)]), ("g",)),
    ]
    ref_cache = ref_engine.EvalCache(table)
    _, ref_fb = ref_device._plan_workload(table, queries, ref_cache)
    got, t, cache = _port(table, queries)
    _, fb = device._plan_workload(t, carry.queries(queries), cache)
    assert [i for i, _ in fb] == [i for i, _ in ref_fb]
    want = _reference("host", table, queries)
    for i, (w, g) in enumerate(zip(want, got)):
        assert_answers_match(w, g, exact=i in {j for j, _ in fb})


def test_single_query_entry_point():
    table = edge_table(seed=4)
    q = Query((Aggregate("count"),), Predicate.conjunction([Clause("x", "<", 0.0)]), ("g",))
    t = carry.table(table)
    host = engine.per_partition_answers(t, carry.query(q), options=CPU.replace(backend="host"))
    dev = engine.per_partition_answers(t, carry.query(q), options=CPU)
    assert_answers_match(host, dev)


def test_cache_on_another_device_is_refused():
    t = carry.table(edge_table())
    cache = engine.EvalCache(t, options=ExecOptions(device="meta"))
    with pytest.raises(ValueError):
        engine.per_partition_answers_batch(t, carry.queries(edge_queries()), cache=cache,
                                           options=CPU)


def test_error_metrics_match_reference():
    rng = np.random.default_rng(7)
    truth = rng.normal(size=(9, 3))
    est = truth * (1 + 0.1 * rng.normal(size=(9, 3)))
    est[2] = np.nan
    truth[4, 1] = 0.0
    assert engine.error_metrics(truth, est) == ref_engine.error_metrics(truth, est)


def test_append_grows_the_device_stack_in_place():
    """A pure partition append writes the new partitions into the stack's
    bucket slack; answers equal the reference's on the grown table."""
    table = ref_make_dataset("tpch", num_partitions=6, rows_per_partition=300, seed=1)
    delta = ref_make_dataset("tpch", num_partitions=2, rows_per_partition=300, seed=2)
    queries = RefWorkloadSpec(table, seed=4).sample_workload(12)
    t = carry.table(table)
    cache = engine.EvalCache(t, options=CPU)
    device.eval_workload(t, carry.queries(queries), cache=cache)
    stack = cache.device_stack()
    append_partitions(t, carry.table(delta))
    got = device.eval_workload(t, carry.queries(queries), cache=cache)
    assert cache.device_stack() is stack  # 8 partitions fit the bucket of 6
    assert (cache.stack_appends, cache.stack_rebuilds) == (1, 1)
    want = _reference("host", concat_tables([table, delta]), queries)
    for w, g in zip(want, got):
        assert_answers_match(w, g)


def test_out_of_band_mutation_raises():
    t = carry.table(edge_table())
    cache = engine.EvalCache(t, options=CPU)
    cache.device_stack()
    t.columns["x"][0, 0] += 1.0  # no version bump
    with pytest.raises(StaleStateError):
        cache.device_stack()
