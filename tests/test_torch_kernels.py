"""The port's kernels (plain PyTorch versions, CPU) vs the JAX reference.

Each ported kernel's entry point, given CPU tensors, runs its plain
version; it must match the reference's two lowerings on the same numpy
inputs — the jnp oracle (``use_ref=True``) and the Pallas kernel (interpret
mode off-TPU) — on the cases of ``tests/test_kernels.py`` and
``tests/test_fused_eval.py``: rows % 128 != 0, NaN rows, zero-row
predicates, card-1 groups and all-dropped codes.  Counts, histograms and
bincounts are bit-equal; f32 sums agree to the reference's own tolerance
(rtol 1e-5, atol 1e-4; moments rtol 2e-5, atol 2e-4), since the summation
order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops
import torch_threads

torch_threads.cap_under_xdist()

LOWERINGS = ("xla-ref", "pallas")
SHAPES_PR = [(3, 100), (7, 2050)]  # rows % 128 != 0, one and several tiles


def _ref(lowering, op, *args, **kw):
    arrs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    return np.asarray(getattr(ref_ops, op)(*arrs, use_ref=lowering == "xla-ref", **kw))


def _port(op, *args):
    t = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    return getattr(ops, op)(*t).numpy()


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("shape", SHAPES_PR)
@pytest.mark.parametrize("sign", ["positive", "mixed", "nonfinite"])
def test_moments(lowering, shape, sign):
    rng = np.random.default_rng(shape[1])
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    if sign == "positive":
        x = np.abs(x) + np.float32(0.1)  # log statistics live
    if sign == "nonfinite":  # NaN in every statistic of its row; ±inf, and both
        x[0, 5] = np.nan
        x[1, 3] = np.inf
        x[2, 4] = -np.inf
        x[-1, 1], x[-1, 2] = np.inf, -np.inf
    got = _port("moments_op", x)
    want = _ref(lowering, "moments_op", x)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])  # min/max exact
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_moments_rejects_zero_rows():
    with pytest.raises(ValueError):
        ops.moments_op(torch.zeros((2, 0)))


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("shape", SHAPES_PR)
@pytest.mark.parametrize("nb,edges", [
    pytest.param(4, "quantile", id="4"),
    pytest.param(33, "quantile", id="33"),
    # the reference tests each bucket on its own, whatever the edges
    pytest.param(10, "duplicate", id="10-duplicate-edges"),
    pytest.param(10, "unsorted", id="10-unsorted-edges"),
    pytest.param(10, "nan", id="10-nan-edges"),
    pytest.param(10, "inf", id="10-inf-values"),
])
def test_histogram_range(lowering, shape, nb, edges):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    if edges == "duplicate":  # few distinct values: quantiles repeat
        x = np.round(x).astype(np.float32)
    if edges == "nan":
        x[0] = np.nan  # an all-NaN partition has NaN quantiles
    if edges == "inf":
        x[:, 3::17] = np.inf
        x[:, 4::17] = -np.inf
    with np.errstate(invalid="ignore"):  # inf - inf between infinite quantiles
        q = np.quantile(x.astype(np.float64), np.linspace(0, 1, nb + 1), axis=1).T
    q = np.ascontiguousarray(q, np.float32)
    if edges == "unsorted":
        q = np.ascontiguousarray(q[:, rng.permutation(nb + 1)])
    if edges == "nan":
        q[1, nb // 2] = np.nan
    if edges == "inf":  # open ends: ±inf values count in the end buckets
        q[0, 0], q[0, -1] = -np.inf, np.inf
    x[:, ::13] = np.nan  # NaN counts nowhere
    x[:, 1] = q[:, -1]  # the last bucket is closed
    x[:, 2] = q[:, -1] + 1  # above the top edge: nowhere
    got = _port("histogram_range_op", x, q)
    np.testing.assert_array_equal(got, _ref(lowering, "histogram_range_op", x, q))


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("shape", SHAPES_PR)
@pytest.mark.parametrize("card", [1, 130])
def test_bincount(lowering, shape, card):
    rng = np.random.default_rng(2)
    codes = rng.integers(-1, card, size=shape).astype(np.int32)  # -1 = padding
    got = _port("bincount_op", codes, card)
    np.testing.assert_array_equal(got, _ref(lowering, "bincount_op", codes, card))


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("p,v,r,g", [(2, 1, 256, 4), (3, 4, 1000, 37), (1, 3, 2048, 600),
                                     (2, 4, 1000, 2048), (3, 4, 777, 4)])
def test_group_aggregate(lowering, p, v, r, g):
    rng = np.random.default_rng(4)
    values = rng.normal(size=(p, v, r)).astype(np.float32)
    values[:, 0] = 1.0  # component 0 counts rows
    mask = (rng.random((p, r)) < 0.6).astype(np.float32)
    codes = rng.integers(0, g, size=(p, r)).astype(np.int32)
    got = _port("group_aggregate_op", values, mask, codes, g)
    want = _ref(lowering, "group_aggregate_op", values, mask, codes, g)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_group_aggregate_all_dropped_codes():
    values = torch.ones((2, 1, 100))
    mask = torch.ones((2, 100))
    codes = torch.full((2, 100), -1, dtype=torch.int32)
    assert torch.count_nonzero(ops.group_aggregate_op(values, mask, codes, 4)) == 0


def _fused_case(b=2, c=3, g=2, v=2, r=200, num_groups=5, seed=0):
    """`tests/test_fused_eval.py`'s case generator, component 0 = counts."""
    rng = np.random.default_rng(seed)
    cols = (rng.normal(size=(b, c, r)) * 2).astype(np.float32)
    lo = rng.normal(size=(b, c)).astype(np.float32) - 1.0
    hi = lo + np.abs(rng.normal(size=(b, c))).astype(np.float32) + 0.5
    gmap = np.zeros((b, c, g), np.float32)
    gmap[:, np.arange(c), np.arange(c) % g] = 1.0
    values = rng.normal(size=(b, v, r)).astype(np.float32)
    values[:, 0] = 1.0
    codes = rng.integers(0, num_groups, size=(b, r)).astype(np.int32)
    return cols, lo, hi, gmap, values, codes, num_groups


def _fused_pair(lowering, case):
    *arrs, ng = case
    got = _port("fused_eval_op", *arrs, ng)
    return got, _ref(lowering, "fused_eval_op", *arrs, ng)


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize(
    "shape",
    [
        dict(r=97),
        dict(r=130, v=1),
        dict(r=513, b=3, c=4, g=3, num_groups=11, seed=3),
        dict(num_groups=1),
        dict(g=1, c=1, r=64),
    ],
    ids=["r97", "r130", "r513-wide", "card1-groups", "single-clause"],
)
def test_fused_eval(lowering, shape):
    got, want = _fused_pair(lowering, _fused_case(**shape))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lowering", LOWERINGS)
def test_fused_eval_nan_rows(lowering):
    case = _fused_case(r=140, seed=4)
    case[0][:, :, ::7] = np.nan  # NaN fails every interval test
    got, want = _fused_pair(lowering, case)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("edge", ["zero-row", "unmatchable-group", "dropped-codes"])
def test_fused_eval_empty(lowering, edge):
    cols, lo, hi, gmap, values, codes, ng = _fused_case(c=2, g=2, r=150, seed=1)
    if edge == "zero-row":
        hi = lo - 1.0
    elif edge == "unmatchable-group":
        lo[:, 0], hi[:, 0] = -1e9, 1e9  # group 0 passes every row
        lo[:, 1], hi[:, 1] = 1e9, 1e9  # group 1 passes none
    else:
        codes[:] = -1
    got, want = _fused_pair(lowering, (cols, lo, hi, gmap, values, codes, ng))
    np.testing.assert_array_equal(want, 0.0)
    np.testing.assert_array_equal(got, 0.0)
