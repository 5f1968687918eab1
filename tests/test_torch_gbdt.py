"""The port's GBDT (binning, host fit, device fit, funnel) vs the JAX reference.

The reference promises that its device fit exports the forest its host
fit does, bit for bit (`src/repro/core/gbdt.py` docstring).  The port
holds itself to the same contract across the two packages: on the same
inputs, the port's host fit and its device fit (here the CPU, i.e. the
plain tree_hist / cumsum_seq versions) export forests byte-equal to the
reference's host fit, and so does `train_funnel` (forests, taus,
thresholds).  The plain tree_hist must equal the reference's `segment_sum`
oracle bit for bit, which rests on CPU ``index_add_`` folding in order —
proven here against ``np.add.at``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import funnel as ref_funnel
from repro.core import gbdt as ref_gbdt
from repro.kernels import ref as ref_kernels
from repro_torch.backends import ExecOptions
from repro_torch.core import funnel, gbdt
from repro_torch.kernels import tree_hist

HOST = ExecOptions(backend="host")
DEVICE = ExecOptions(device="cpu")


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _assert_forest_equal(port, ref):
    np.testing.assert_array_equal(port.feat, ref.feat)
    np.testing.assert_array_equal(port.thr, ref.thr)
    np.testing.assert_array_equal(_bits(port.leaf), _bits(ref.leaf))  # -0.0 and 1 ulp count
    assert port.base == ref.base
    np.testing.assert_array_equal(port.binner.edges, ref.binner.edges)


def _data(n=777, f=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = x @ rng.normal(size=f) + np.sin(x[:, 0] * 3)
    return x, y


# --------------------------------------------------------------------------
# tree_hist and cumsum_seq plain versions
# --------------------------------------------------------------------------
def test_cpu_index_add_folds_in_order():
    """The plain tree_hist's premise: CPU ``index_add_`` is np.add.at's
    left fold (many collisions, magnitudes over 9 decades)."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 97, 200_000)
    v = (rng.normal(size=idx.size) * 10.0 ** rng.integers(-4, 5, idx.size)).astype(np.float32)
    want = np.zeros(97, np.float32)
    np.add.at(want, idx, v)
    got = torch.zeros(97).index_add_(0, torch.from_numpy(idx), torch.from_numpy(v))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("r,c,nn,f", [(300, 4, 8, 9), (1024, 3, 16, 5), (513, 1, 1, 2)])
def test_tree_hist_plain_matches_ref_bitwise(r, c, nn, f):
    rng = np.random.default_rng(r)
    codes = rng.integers(0, 256, size=(r, c)).astype(np.int32)
    fids = np.sort(rng.choice(f, size=c, replace=False)).astype(np.int32)
    node = rng.integers(-1, nn, size=r).astype(np.int32)  # -1 = dropped
    g = (rng.normal(size=r) * 10.0 ** rng.integers(-3, 4, size=r)).astype(np.float32)
    h = np.abs(rng.normal(size=r)).astype(np.float32)
    want = np.asarray(ref_kernels.tree_hist_ref(
        jnp.asarray(codes), jnp.asarray(fids), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), nn, f))
    got = tree_hist.tree_hist(*map(torch.from_numpy, (codes, fids, node, g, h)), nn, f).numpy()
    assert got.shape == (2, nn, f, 256)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    unsampled = np.setdiff1d(np.arange(f), fids)
    np.testing.assert_array_equal(_bits(got[:, :, unsampled]), 0)  # exactly +0.0


@pytest.mark.parametrize("kind", ["constant-column", "one-node", "leaf-sum"])
def test_tree_hist_plain_matches_ref_at_skewed_shapes(kind):
    """The shapes that stress the CUDA kernel's design, where one segment
    holds most rows: a constant column, every row in node 0 (level 0),
    and the device fit's leaf sums (1 column, 2^depth nodes, 1 bin)."""
    rng = np.random.default_rng(7)
    r = 2000
    if kind == "leaf-sum":
        codes, fids, nn, f, nbins = np.zeros((r, 1), np.int32), np.zeros(1, np.int32), 32, 1, 1
        node = rng.integers(-1, nn, size=r).astype(np.int32)
    else:
        codes = rng.integers(0, 256, size=(r, 3)).astype(np.int32)
        fids, nn, f, nbins = np.array([0, 2, 4], np.int32), 16, 5, 256
        node = rng.integers(-1, nn, size=r).astype(np.int32)
        if kind == "constant-column":
            codes[:, 1] = 9
        else:
            node = np.where(node >= 0, 0, -1).astype(np.int32)
    g = (rng.normal(size=r) * 10.0 ** rng.integers(-3, 4, size=r)).astype(np.float32)
    h = np.abs(rng.normal(size=r)).astype(np.float32)
    want = np.asarray(ref_kernels.tree_hist_ref(
        jnp.asarray(codes), jnp.asarray(fids), jnp.asarray(node), jnp.asarray(g),
        jnp.asarray(h), nn, f, nbins))
    got = tree_hist.tree_hist(*map(torch.from_numpy, (codes, fids, node, g, h)), nn, f,
                              nbins).numpy()
    assert got.shape == (2, nn, f, nbins)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_tree_hist_plain_drops_out_of_range_codes():
    codes = torch.tensor([[0], [3], [-1], [4]], dtype=torch.int32)
    ones = torch.ones(4)
    out = tree_hist.tree_hist(codes, torch.tensor([0], dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32), ones, ones, 1, 1, 4)
    np.testing.assert_array_equal(out[0, 0, 0].numpy(), [1, 0, 0, 1])


def test_cumsum_seq_plain_is_np_cumsum():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 3, 5, 256)) * 1e3).astype(np.float32)
    x[0, 0, 0, 0] = -0.0  # out[0] == x[0], sign included
    got = tree_hist.cumsum_seq(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.cumsum(x, axis=-1)))


# --------------------------------------------------------------------------
# binning and fits
# --------------------------------------------------------------------------
def test_binner_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 5))
    x[::7, 1] = np.nan
    x[::11, 2] = np.inf
    ref = ref_gbdt.Binner.fit(x)
    port = gbdt.Binner.fit(x)
    np.testing.assert_array_equal(port.edges, ref.edges)
    probe = np.concatenate([x, ref.edges.T[:50]], axis=0)  # exact-edge values
    np.testing.assert_array_equal(port.transform(probe), ref.transform(probe))


FIT_CASES = {
    "plain": dict(num_trees=8, depth=5),
    "subsampled": dict(num_trees=8, depth=4, rowsample=0.5, colsample=0.6, seed=3),
    "weighted": dict(num_trees=6, depth=4),
}


@pytest.mark.parametrize("options", [HOST, DEVICE], ids=["host", "device"])
@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_matches_reference_host_fit(options, case):
    x, y = _data()
    kw = dict(FIT_CASES[case])
    if case == "weighted":
        kw["sample_weight"] = np.abs(np.random.default_rng(4).normal(size=x.shape[0])) + 0.1
    want = ref_gbdt.fit_gbdt(x, y, backend="host", **kw)
    got = gbdt.fit_gbdt(x, y, options=options, **kw)
    _assert_forest_equal(got, want)
    np.testing.assert_array_equal(got.predict(x), want.predict(x))


@pytest.mark.parametrize(
    "case", ["constant_feature", "tiny_n", "odd_n", "identical_labels", "deep"]
)
def test_device_fit_edge_cases_match_reference(case):
    x, y = _data(n=500, f=6, seed=7)
    kw = dict(num_trees=5, depth=4)
    if case == "constant_feature":
        x[:, 2] = 1.25
    elif case == "tiny_n":
        x, y = x[:100], y[:100]
    elif case == "odd_n":
        x, y = x[:333], y[:333]
    elif case == "identical_labels":
        y = np.full(x.shape[0], 2.5)
    elif case == "deep":
        x, y = x[:80], y[:80]
        kw = dict(num_trees=3, depth=6)  # 63 internal nodes, 80 rows
    _assert_forest_equal(gbdt.fit_gbdt(x, y, options=DEVICE, **kw),
                         ref_gbdt.fit_gbdt(x, y, backend="host", **kw))


def test_device_fit_census():
    x, y = _data(n=300, f=5)
    gbdt.TRACES.reset()
    gbdt.fit_gbdt(x, y, num_trees=4, depth=3, rowsample=0.5, colsample=0.6, options=DEVICE)
    census = gbdt.fit_census(300, 5, 3, 0.5, 0.6)
    assert set(gbdt.TRACES.counts()) == census
    assert gbdt.TRACES.total() == 4  # one tree fit each, one shape key
    assert census == ref_gbdt.fit_census(300, 5, 3, 0.5, 0.6)


def test_importance_gain_matches_reference():
    x, y = _data(n=400, f=6, seed=1)
    forest = ref_gbdt.fit_gbdt(x, y, num_trees=5, depth=3, backend="host")
    np.testing.assert_array_equal(
        gbdt.importance_gain(gbdt.fit_gbdt(x, y, num_trees=5, depth=3, options=HOST), x, y),
        ref_gbdt.importance_gain(forest, x, y),
    )


# --------------------------------------------------------------------------
# funnel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("options", [HOST, DEVICE], ids=["host", "device"])
def test_train_funnel_matches_reference(options):
    rng = np.random.default_rng(5)
    feats = [rng.normal(size=(64, 7)) for _ in range(6)]
    contribs = [np.abs(rng.normal(size=64)) * (rng.random(64) < 0.4) for _ in range(6)]
    kw = dict(num_models=2, num_trees=6, depth=3)
    want = ref_funnel.train_funnel(feats, contribs, backend="host", **kw)
    got = funnel.train_funnel(feats, contribs, options=options, **kw)
    for a, b in zip(got.forests, want.forests):
        _assert_forest_equal(a, b)
    np.testing.assert_array_equal(got.taus, want.taus)
    np.testing.assert_array_equal(got.thresholds, want.thresholds)
    groups = got.classify(feats[0], np.arange(64))
    for a, b in zip(groups, want.classify(feats[0], np.arange(64))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sizes,budget", [([10, 5, 3, 1], 7), ([0, 40, 0, 2], 30), ([4, 4], 100)])
def test_allocate_matches_reference(sizes, budget):
    assert funnel.allocate(sizes, budget) == ref_funnel.allocate(sizes, budget)


# --------------------------------------------------------------------------
# parity_relaxation: device-resident boosting (allclose, not bitwise)
# --------------------------------------------------------------------------
RELAXED_KW = dict(num_trees=8, depth=4, rowsample=0.7, colsample=0.8, seed=2)


def _assert_relaxed_close(got, want):
    """The reference's own tolerances (`tests/test_gbdt_device.py`)."""
    assert got.base == want.base
    np.testing.assert_array_equal(got.feat, want.feat)
    np.testing.assert_array_equal(got.thr, want.thr)
    np.testing.assert_allclose(got.leaf, want.leaf, rtol=1e-4, atol=1e-5)


def test_relaxed_fit_allclose_to_host_and_reference():
    """The relaxed device fit (boosting update on the device, blocked
    one-hot matmul histograms on the CPU) is allclose to the port's host
    fit and to the reference's relaxed fit; the default device fit stays
    bit-identical (the tests above)."""
    x, y = _data(n=600, f=7, seed=21)
    host = gbdt.fit_gbdt(x, y, options=HOST, **RELAXED_KW)
    relaxed = gbdt.fit_gbdt(x, y, options=DEVICE, parity_relaxation=True, **RELAXED_KW)
    ref_relaxed = ref_gbdt.fit_gbdt(x, y, backend="device", parity_relaxation=True, **RELAXED_KW)
    for want in (host, ref_relaxed):
        _assert_relaxed_close(relaxed, want)
        np.testing.assert_allclose(relaxed.predict(x), want.predict(x), rtol=1e-4, atol=1e-4)


def test_relaxed_fit_census():
    x, y = _data(n=300, f=5)
    gbdt.TRACES.reset()
    gbdt.fit_gbdt(x, y, num_trees=4, depth=3, options=DEVICE, parity_relaxation=True)
    census = gbdt.fit_census(300, 5, 3, 1.0, 1.0, parity_relaxation=True)
    assert set(gbdt.TRACES.counts()) == census
    assert gbdt.TRACES.total() == 4
    assert census == ref_gbdt.fit_census(300, 5, 3, 1.0, 1.0, parity_relaxation=True)


def test_relaxed_funnel_allclose_to_reference():
    """`train_funnel(parity_relaxation=)` threads the flag to every fit."""
    rng = np.random.default_rng(5)
    feats = [rng.normal(size=(64, 7)) for _ in range(6)]
    contribs = [np.abs(rng.normal(size=64)) * (rng.random(64) < 0.4) for _ in range(6)]
    kw = dict(num_models=2, num_trees=6, depth=3)
    want = ref_funnel.train_funnel(feats, contribs, backend="device", parity_relaxation=True,
                                   **kw)
    gbdt.TRACES.reset()
    got = funnel.train_funnel(feats, contribs, options=DEVICE, parity_relaxation=True, **kw)
    assert {k[0] for k in gbdt.TRACES.counts()} == {"fit_tree_res"}
    for a, b in zip(got.forests, want.forests):
        _assert_relaxed_close(a, b)


@pytest.mark.parametrize("r,c,nn,f", [(700, 3, 8, 6), (256, 1, 1, 2), (513, 4, 16, 9)])
def test_tree_hist_matmul_allclose_to_reference(r, c, nn, f):
    """The relaxed plain version against the reference's scatter-free
    lowering and the bitwise oracle, at the reference's tolerance."""
    rng = np.random.default_rng(17 + r)
    codes = rng.integers(0, 256, size=(r, c)).astype(np.int32)
    fids = np.sort(rng.choice(f, size=c, replace=False)).astype(np.int32)
    node = rng.integers(-1, nn, size=r).astype(np.int32)
    g = rng.normal(size=r).astype(np.float32)
    h = np.abs(rng.normal(size=r)).astype(np.float32)
    args = tuple(map(jnp.asarray, (codes, fids, node, g, h))) + (nn, f)
    got = tree_hist.tree_hist(*map(torch.from_numpy, (codes, fids, node, g, h)), nn, f,
                              relaxed=True).numpy()
    assert got.shape == (2, nn, f, 256)
    for want in (ref_kernels.tree_hist_matmul_ref(*args), ref_kernels.tree_hist_ref(*args)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-4)
    unsampled = np.setdiff1d(np.arange(f), fids)
    assert not got[:, :, unsampled].any()
