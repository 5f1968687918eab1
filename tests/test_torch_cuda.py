"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device and
skips where there is none (this file imports only ``repro_torch``, so it
runs on a GPU host without JAX).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Counts, histograms, bincounts, GBDT histograms and their prefix sums
must be bit-equal to the plain versions; f32 sums agree to the
reference's own tolerance (rtol 1e-5, atol 1e-4 — the summation order
differs), pairwise distances at rtol 1e-4, atol 1e-3 with the same
nearest centers, and every kernel must give the same bits on a second
run (no float atomics).  The device GBDT fit on the card exports the
host fit's forest bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.backends import ExecOptions
from repro_torch.core.sketches import build_sketches
from repro_torch.data.datasets import make_dataset
from repro_torch.core import clustering, gbdt
from repro_torch.kernels import _build, fused, groupagg, histogram, moments, pdist, tree_hist
from repro_torch.queries import device
from repro_torch.queries.engine import EvalCache, per_partition_answers_batch
from repro_torch.queries.generator import WorkloadSpec

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: IEEE f32
    return torch.device("cuda")


def _fused_case(b, c, g, v, r, radix, seed, nan_every=0):
    rng = np.random.default_rng(seed)
    cols = (rng.normal(size=(b, c, r)) * 2).astype(np.float32)
    if nan_every:
        cols[:, :, ::nan_every] = np.nan
    lo = rng.normal(size=(b, c)).astype(np.float32) - 1.0
    hi = lo + np.abs(rng.normal(size=(b, c))).astype(np.float32) + 0.5
    gmap = np.zeros((b, c, g), np.float32)
    gmap[:, np.arange(c), np.arange(c) % g] = 1.0
    values = rng.normal(size=(b, v, r)).astype(np.float32)
    values[:, 0] = 1.0  # component 0 counts rows
    codes = rng.integers(-1, radix + 3, size=(b, r)).astype(np.int32)  # -1, out of range
    return cols, lo, hi, gmap, values, codes


def _check_sums(got, want):
    np.testing.assert_array_equal(got[:, 0], want[:, 0])  # counts bit-equal
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize(
    "b,c,g,v,r,radix,nan_every",
    [
        (2, 3, 2, 2, 97, 5, 0),
        (3, 4, 3, 4, 513, 11, 7),
        (2, 1, 1, 4, 64, 1, 0),
        (4, 8, 2, 4, 4096, 512, 0),
        (2, 32, 5, 4, 3000, 4096, 5),  # radix over one group tile
        (1, 40, 33, 3, 300, 130, 0),  # clause bits past 32
    ],
)
def test_fused_eval_matches_plain(cuda, b, c, g, v, r, radix, nan_every):
    arrs = _fused_case(b, c, g, v, r, radix, seed=r + c, nan_every=nan_every)
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    got = fused.fused_eval(*args, radix)
    again = fused.fused_eval(*args, radix)
    torch.cuda.synchronize()
    want = fused.fused_eval_plain(*args, radix)
    assert torch.equal(got, again)
    _check_sums(got.cpu().numpy(), want.cpu().numpy())


def test_fused_eval_empty_predicate_is_zero(cuda):
    cols, lo, hi, gmap, values, codes = _fused_case(2, 3, 2, 4, 150, 9, seed=1)
    hi = lo - 1.0
    args = [torch.from_numpy(a).to(cuda) for a in (cols, lo, hi, gmap, values, codes)]
    assert torch.count_nonzero(fused.fused_eval(*args, 9)) == 0


@pytest.mark.parametrize("p,v,r,g", [(2, 1, 256, 4), (3, 4, 1000, 37), (1, 3, 2048, 600),
                                     (2, 4, 5000, 4096)])
def test_group_aggregate_matches_plain(cuda, p, v, r, g):
    rng = np.random.default_rng(4)
    values = rng.normal(size=(p, v, r)).astype(np.float32)
    values[:, 0] = 1.0
    mask = (rng.random((p, r)) < 0.6).astype(np.float32)
    codes = rng.integers(-1, g + 2, size=(p, r)).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda) for a in (values, mask, codes)]
    got = groupagg.group_aggregate(*args, g)
    again = groupagg.group_aggregate(*args, g)
    want = groupagg.group_aggregate_plain(*args, g)
    assert torch.equal(got, again)
    _check_sums(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("shape", [(1, 128), (3, 100), (4, 1024), (7, 2050), (2, 16384)])
def test_moments_matches_plain(cuda, shape):
    rng = np.random.default_rng(shape[1])
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    if shape[0] > 1:
        x[0, 5] = np.nan  # NaN propagates into every statistic of its row
    t = torch.from_numpy(x).to(cuda)
    got = moments.moments(t)
    again = moments.moments(t)
    want = moments.moments_plain(t)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g, again.cpu().numpy())  # NaN-aware bit equality
    exact = [0, 1, 4, 5]  # min/max of x and of log x
    np.testing.assert_array_equal(g[:, [0, 1]], w[:, [0, 1]])
    np.testing.assert_allclose(g[:, exact], w[:, exact], rtol=1e-6)  # logf vs torch.log: ulps
    np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-4)


def test_moments_rejects_zero_rows(cuda):
    with pytest.raises(ValueError):
        moments.moments(torch.zeros((3, 0), device=cuda))


@pytest.mark.parametrize("shape", [(1, 128), (3, 100), (7, 2050), (4, 16384)])
@pytest.mark.parametrize("nb", [4, 10, 33])
def test_histogram_range_matches_plain(cuda, shape, nb):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    edges = np.quantile(x.astype(np.float64), np.linspace(0, 1, nb + 1), axis=1).T
    x[:, ::11] = np.nan
    xt = torch.from_numpy(x).to(cuda)
    et = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).to(cuda)
    got = histogram.histogram_range(xt, et)
    assert torch.equal(got, histogram.histogram_range_plain(xt, et))


@pytest.mark.parametrize("shape", [(1, 128), (3, 100), (7, 2050), (4, 16384)])
@pytest.mark.parametrize("card", [1, 17, 200, 4096, 5000])
def test_bincount_matches_plain(cuda, shape, card):
    rng = np.random.default_rng(2)
    codes = rng.integers(-1, card + 5, size=shape).astype(np.int32)
    ct = torch.from_numpy(codes).to(cuda)
    got = histogram.bincount(ct, card)
    assert torch.equal(got, histogram.bincount_plain(ct, card))


def test_launch_counts_only_on_cuda(cuda):
    x = torch.ones((2, 64))
    _build.LAUNCHES.reset()
    moments.moments(x)  # CPU tensor: the plain version, not counted
    moments.moments(x.to(cuda))
    assert _build.LAUNCHES.counts() == {("moments",): 1}


def test_driver_on_cuda_matches_host(cuda):
    table = make_dataset("tpch", num_partitions=16, rows_per_partition=1000, seed=0)
    queries = WorkloadSpec(table, seed=0).sample_workload(48)
    opts = ExecOptions(device=str(cuda))
    host = per_partition_answers_batch(table, queries, options=opts.replace(backend="host"))
    dev = device.eval_workload(table, queries, cache=EvalCache(table, options=opts))
    for h, d in zip(host, dev):
        np.testing.assert_array_equal(h.group_keys, d.group_keys)
        np.testing.assert_array_equal(h.raw[:, :, 0], d.raw[:, :, 0])
        np.testing.assert_allclose(d.raw, h.raw, rtol=1e-5, atol=1e-4)
    hs = build_sketches(table, options=opts.replace(backend="host"))
    ds = build_sketches(table, options=opts)
    for name, cs in hs.columns.items():
        d = ds.columns[name]
        np.testing.assert_allclose(d.measures, cs.measures, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(d.hh_stats, cs.hh_stats)
        if cs.cat_counts is not None:
            np.testing.assert_array_equal(d.cat_counts, cs.cat_counts)


# --------------------------------------------------------------------------
# the picker's kernels: tree_hist, cumsum_seq (bit-equal), pdist_sq
# --------------------------------------------------------------------------
def _bits(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("r,c,nn,f,nbins", [(300, 4, 8, 9, 256), (1024, 3, 16, 5, 256),
                                            (513, 1, 1, 2, 256), (5000, 7, 32, 11, 256),
                                            (777, 1, 32, 1, 1)])
def test_tree_hist_matches_plain_bitwise(cuda, r, c, nn, f, nbins):
    rng = np.random.default_rng(r)
    codes_t = torch.from_numpy(rng.integers(0, nbins, size=(c, r), dtype=np.int32)).to(cuda)
    fids = torch.from_numpy(np.sort(rng.choice(f, size=c, replace=False)).astype(np.int32))
    node = torch.from_numpy(rng.integers(-1, nn, size=r).astype(np.int32))
    g = torch.from_numpy((rng.normal(size=r) * 10.0 ** rng.integers(-3, 4, size=r))
                         .astype(np.float32))
    h = torch.from_numpy(np.abs(rng.normal(size=r)).astype(np.float32))
    args = (codes_t.T, fids.to(cuda), node.to(cuda), g.to(cuda), h.to(cuda), nn, f, nbins)
    got = tree_hist.tree_hist(*args)
    again = tree_hist.tree_hist(*args)
    want = tree_hist.tree_hist_plain(*args)
    np.testing.assert_array_equal(_bits(got), _bits(again))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    unsampled = np.setdiff1d(np.arange(f), fids.numpy())
    assert not got[:, :, torch.from_numpy(unsampled).to(cuda)].any()


@pytest.mark.parametrize("shape", [(3, 256), (2, 16, 476, 256), (70, 1000)])
def test_cumsum_seq_matches_plain_bitwise(cuda, shape):
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy((rng.normal(size=shape) * 1e3).astype(np.float32)).to(cuda)
    got = tree_hist.cumsum_seq(x)
    want = tree_hist.cumsum_seq_plain(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), np.cumsum(x.cpu().numpy(), axis=-1).view(np.uint32))


@pytest.mark.parametrize("n,k,f", [(16, 4, 8), (100, 13, 37), (256, 128, 130), (33, 5, 300),
                                   (1024, 256, 476)])
def test_pdist_sq_matches_plain(cuda, n, k, f):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(k, f)).astype(np.float32)).to(cuda)
    got = pdist.pdist_sq(x, c)
    assert torch.equal(got, pdist.pdist_sq(x, c))
    want = pdist.pdist_sq_plain(x, c)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-3)
    assert torch.equal(got.argmin(dim=1), want.argmin(dim=1))


def test_device_fit_on_cuda_matches_host_fit(cuda):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 12))
    y = x @ rng.normal(size=12) + np.sin(x[:, 0] * 3)
    kw = dict(num_trees=6, depth=5, rowsample=0.5, colsample=0.7, seed=2)
    dev = gbdt.fit_gbdt(x, y, options=ExecOptions(device=str(cuda)), **kw)
    host = gbdt.fit_gbdt(x, y, options=ExecOptions(backend="host"), **kw)
    np.testing.assert_array_equal(dev.feat, host.feat)
    np.testing.assert_array_equal(dev.thr, host.thr)
    np.testing.assert_array_equal(dev.leaf.view(np.uint32), host.leaf.view(np.uint32))


def test_kmeans_on_cuda_selects_like_cpu(cuda):
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(9, 16)) * 10
    x = (centers[rng.integers(0, 9, size=300)] + rng.normal(size=(300, 16))).astype(np.float32)
    got = clustering.kmeans_select(x, 20, device=str(cuda))
    want = clustering.kmeans_select(x, 20, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
