"""The port's predicate_eval and predicate_mask_device against the reference.

The plain `predicate_eval` (what a CPU operand runs) is held bit-equal,
mask and count, to the reference's `ops.predicate_eval_op` run as
`tests/test_kernels.py` runs it on the CPU (the Pallas kernel in
interpret mode): shared and per-partition group maps and bounds, NaN
rows, row counts off the reference's block and 64 clauses.  The port's
`predicate_mask_device` is held bit-equal to the reference's and to the
host `predicate_mask` on an edge-case table.  Inputs are made with numpy
from a seed and carried across with `repro_torch.carry`.
"""
import numpy as np
import pytest
import torch

from repro.data.table import CATEGORICAL as REF_CATEGORICAL
from repro.data.table import NUMERIC as REF_NUMERIC
from repro.data.table import ColumnSpec as RefColumnSpec
from repro.data.table import Table as RefTable
from repro.kernels import ops as ref_ops
from repro.queries import device as ref_device
from repro.queries.engine import EvalCache as RefEvalCache
from repro.queries.ir import Aggregate as RefAggregate
from repro.queries.ir import Clause as RefClause
from repro.queries.ir import OrGroup as RefOrGroup
from repro.queries.ir import Predicate as RefPredicate
from repro.queries.ir import Query as RefQuery
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.kernels import ops, predicate
from repro_torch.queries import device, engine

CPU = ExecOptions(device="cpu")


def _case(p, c, r, g, seed, nan_every=0, per_partition_bounds=False, per_partition_map=False):
    rng = np.random.default_rng(seed)
    cols = (rng.normal(size=(p, c, r)) * 2).astype(np.float32)
    if nan_every:
        cols[:, :, ::nan_every] = np.nan
    bshape = (p, c) if per_partition_bounds else (c,)
    lo = (rng.normal(size=bshape) - 0.5).astype(np.float32)
    hi = (lo + np.abs(rng.normal(size=bshape)) + 0.7).astype(np.float32)
    if per_partition_map:
        gid = rng.integers(0, g, size=(p, c))
        gid[:, :g] = np.arange(g)  # every group non-empty
        gmap = np.eye(g, dtype=np.float32)[gid]  # (P, C, G)
    else:
        gid = rng.integers(0, g, size=c)
        gid[:g] = np.arange(g)
        gmap = np.eye(g, dtype=np.float32)[gid]  # (C, G)
    return cols, lo, hi, gmap


@pytest.mark.parametrize(
    "p,c,r,g,nan_every,pp_bounds,pp_map",
    [
        (2, 1, 300, 1, 0, False, False),
        (3, 5, 1024, 2, 0, True, False),
        (1, 8, 513, 4, 7, False, True),  # R off the reference's block, NaN rows
        (3, 6, 1300, 3, 5, True, True),
        (2, 64, 300, 9, 11, True, True),  # every clause bit of the kernel's word
        (4, 12, 129, 12, 0, False, True),  # one clause per group
    ],
)
def test_plain_predicate_eval_matches_reference(p, c, r, g, nan_every, pp_bounds, pp_map):
    arrs = _case(p, c, r, g, seed=p * 100 + c + r, nan_every=nan_every,
                 per_partition_bounds=pp_bounds, per_partition_map=pp_map)
    ref_mask, ref_cnt = ref_ops.predicate_eval_op(*arrs, g)
    mask, cnt = ops.predicate_eval_op(*(torch.from_numpy(a) for a in arrs), g)
    assert mask.dtype == torch.float32 and cnt.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy().view(np.uint32),
                                  np.asarray(ref_mask).view(np.uint32))
    np.testing.assert_array_equal(cnt.numpy().view(np.uint32),
                                  np.asarray(ref_cnt).view(np.uint32))


def test_predicate_eval_edge_forms():
    """An OR-group with no member passes no row; no OR-group passes every
    row; a map whose group count disagrees with ``num_groups`` is refused."""
    cols = torch.zeros((2, 3, 10))
    lo, hi = torch.full((3,), -1.0), torch.full((3,), 1.0)
    empty_group = torch.zeros((3, 2))
    empty_group[:, 0] = 1.0
    mask, cnt = predicate.predicate_eval(cols, lo, hi, empty_group, 2)
    assert not mask.any() and cnt.tolist() == [0.0, 0.0]
    mask, cnt = predicate.predicate_eval(cols, lo, hi, torch.zeros((3, 0)), 0)
    assert mask.all() and cnt.tolist() == [10.0, 10.0]
    with pytest.raises(ValueError):
        predicate.predicate_eval(cols, lo, hi, empty_group, 3)


# --------------------------------------------------------------------------
# predicate_mask_device on an edge-case table
# --------------------------------------------------------------------------
def _edge_columns(parts, rows, seed):
    """Rows % 128 != 0, constant / negative columns, cardinality-1 cat."""
    rng = np.random.default_rng(seed)
    return {
        "x": (rng.normal(size=(parts, rows)) * 3).astype(np.float32),
        "pos": (rng.gamma(2.0, 1.0, size=(parts, rows)) + 0.1).astype(np.float32),
        "const": np.full((parts, rows), 2.5, np.float32),
        "neg": (-np.abs(rng.normal(size=(parts, rows))) - 0.5).astype(np.float32),
        "one": np.zeros((parts, rows), np.int32),
        "g": rng.integers(0, 5, size=(parts, rows)).astype(np.int32),
    }


def ref_edge_table(parts=3, rows=200, seed=1):
    schema = (
        RefColumnSpec("x", REF_NUMERIC),
        RefColumnSpec("pos", REF_NUMERIC, positive=True),
        RefColumnSpec("const", REF_NUMERIC),
        RefColumnSpec("neg", REF_NUMERIC),
        RefColumnSpec("one", REF_CATEGORICAL, cardinality=1, groupable=True),
        RefColumnSpec("g", REF_CATEGORICAL, cardinality=5, groupable=True),
    )
    return RefTable(schema, _edge_columns(parts, rows, seed), name="edge")


def ref_edge_predicates():
    c = RefClause
    conj = RefPredicate.conjunction
    return [
        RefPredicate(),  # no clause: every row
        conj([c("x", ">", 0.0)]),
        conj([c("x", ">", 1e9)]),  # no row
        conj([c("neg", "<=", -1.0)]),
        conj([c("pos", "<", 1.7)]),
        RefPredicate((RefOrGroup((c("x", "<", -1.0), c("g", "==", 2))),)),
        conj([c("const", "<=", 2.5)]),  # every row
        conj([c("const", "<", 2.5)]),  # no row
        conj([c("x", "==", 0.1)]),  # v not a float32
        conj([c("one", "==", 0), c("x", ">=", -0.5)]),
        conj([c("g", "in", (0, 3)), c("x", "!=", 0.5)]),  # expanded clauses
        conj([c("g", "in", (1.5,))]),  # non-integer code: host path
        RefPredicate((RefOrGroup((c("x", "<", 0.0), c("pos", ">", 2.0))),
                      RefOrGroup((c("g", "==", 1), c("g", "==", 4), c("neg", ">", -0.7))))),
    ]


@pytest.mark.parametrize("use_ref", [True, False], ids=["xla-ref", "pallas"])
def test_predicate_mask_device_matches_reference(use_ref):
    ref_table = ref_edge_table()
    table = carry.table(ref_table)
    ref_cache = RefEvalCache(ref_table)
    cache = engine.EvalCache(table, options=CPU)
    checked = 0
    for ref_pred in ref_edge_predicates():
        pred = carry.query(RefQuery((RefAggregate("count"),), ref_pred)).predicate
        want = ref_device.predicate_mask_device(ref_table, ref_pred, ref_cache, use_ref=use_ref)
        got = device.predicate_mask_device(table, pred, cache)
        assert (got is None) == (want is None), ref_pred
        if got is None:
            continue
        assert got.dtype == bool and got.shape == (table.num_partitions, table.rows_per_partition)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, engine.predicate_mask(table, pred))
        checked += 1
    assert checked >= 8


def test_predicate_mask_device_follows_appends():
    """After an append the mask covers the grown table and stays bit-equal
    to the host mask (the cache's float32 columns are re-read)."""
    from repro_torch.data.table import append_partitions

    table = carry.table(ref_edge_table(parts=4, rows=96, seed=2))
    cache = engine.EvalCache(table, options=CPU)
    pred = carry.query(RefQuery((RefAggregate("count"),), ref_edge_predicates()[-1])).predicate
    device.predicate_mask_device(table, pred, cache)
    append_partitions(table, _edge_columns(3, 96, seed=5))
    got = device.predicate_mask_device(table, pred, cache)
    assert got.shape == (7, 96)
    np.testing.assert_array_equal(got, engine.predicate_mask(table, pred))
