"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device and
skips where there is none (this file imports only ``repro_torch``, so it
runs on a GPU host without JAX).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Counts, histograms, bincounts, predicate masks and counts, GBDT
histograms and their prefix sums must be bit-equal to the plain versions; f32 sums agree to the
reference's own tolerance (rtol 1e-5, atol 1e-4 — the summation order
differs), pairwise distances at rtol 1e-4, atol 1e-3 with the same
nearest centers, and every kernel must give the same bits on a second
run (no float atomics); a group_aggregate or fused_eval launch over the
first stack rows gives the bits a full launch gives them, and fused_eval
with a predicate every row passes gives group_aggregate's bits (one
shared aggregation).  The device GBDT fit on the card exports the
host fit's forest bit for bit.  A stream of appends folded on the card
equals a cold rebuild of the grown table bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.backends import ExecOptions
from repro_torch.core.sketches import build_sketches
from repro_torch.data.datasets import make_dataset
from repro_torch.core import clustering, gbdt
from repro_torch.core.sketches import SketchStore
from repro_torch.data.table import append_partitions
from repro_torch.kernels import (
    _build, fused, groupagg, histogram, moments, pdist, predicate, tree_hist,
)
from repro_torch.queries import device
from repro_torch.queries.engine import (
    AnswerStore, EvalCache, per_partition_answers_batch, predicate_mask,
)
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


@pytest.mark.parametrize("radix,r,c", [(2048, 3000, 8), (8, 16384, 8), (512, 16384, 5),
                                       (8, 16384, 2)])
def test_fused_eval_slices_equal_full(cuda, radix, r, c):
    """A stack row's sums depend only on that row: the first 1 and the
    first 16 rows of a 160-row launch, launched alone, give the bits the
    full launch gives them (the streaming path's delta == cold), at the
    path's R = 16384 and off the 256-row step.  The small launches take
    the kernel's prefetching instance (8, 4 + 1 or 1 prefetched clauses);
    at radix 8 and 512 the full one takes the plain instance."""
    arrs = _fused_case(160, c, min(3, c), 4, r, radix, seed=11)
    full = [torch.from_numpy(a).to(cuda) for a in arrs]
    got_full = fused.fused_eval(*full, radix)
    _check_sums(got_full.cpu().numpy(), fused.fused_eval_plain(*full, radix).cpu().numpy())
    for rows in (1, 16):
        part = [t[:rows].contiguous() for t in full]
        np.testing.assert_array_equal(_bits(fused.fused_eval(*part, radix)),
                                      _bits(got_full[:rows]))


@pytest.mark.parametrize("sparse", [False, True])
def test_fused_eval_radix_4096_clause_bits_past_32(cuda, sparse):
    """40 clauses in 3 OR-groups at radix 4096; with ``sparse`` OR-group 0
    passes only through clause 39 (x >= 3.29, the columns being 2 N(0, 1):
    about 5% of the rows)."""
    cols, lo, hi, gmap, values, codes = _fused_case(4, 40, 3, 4, 5000, 4096, seed=12)
    if sparse:
        group0 = np.arange(40) % 3 == 0
        lo[:, group0], hi[:, group0] = 1.0, -1.0  # always false
        lo[:, 39], hi[:, 39] = 3.29, np.inf
    args = [torch.from_numpy(a).to(cuda) for a in (cols, lo, hi, gmap, values, codes)]
    got = fused.fused_eval(*args, 4096)
    assert torch.equal(got, fused.fused_eval(*args, 4096))
    want = fused.fused_eval_plain(*args, 4096)
    if sparse:
        passing = float(want[:, 0].sum()) / (4 * 5000)
        assert 0.01 < passing < 0.1
    _check_sums(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("v,radix,r", [(4, 4, 4000), (4, 2048, 4000), (3, 4096, 4000),
                                       (7, 130, 4000), (4, 8, 16384), (4, 512, 16384)])
def test_fused_eval_all_pass_equals_group_aggregate(cuda, v, radix, r):
    """Both kernels fold rows with one routine (csrc/groupagg.cuh): with a
    predicate that every row passes, fused_eval gives group_aggregate's
    bits for a mask of ones."""
    cols, lo, hi, gmap, values, codes = _fused_case(6, 2, 1, v, r, radix, seed=radix)
    lo[:], hi[:] = -np.inf, np.inf  # no NaN in cols: every clause holds
    args = [torch.from_numpy(a).to(cuda) for a in (cols, lo, hi, gmap, values, codes)]
    got = fused.fused_eval(*args, radix)
    ones = torch.ones(codes.shape, dtype=torch.float32, device=cuda)
    want = groupagg.group_aggregate(args[4], ones, args[5], radix)
    np.testing.assert_array_equal(_bits(got), _bits(want))


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


@pytest.mark.parametrize("radix", [8, 512])
def test_group_aggregate_long_rows_slice_equals_full(cuda, radix):
    """At the path's R = 16384 and a narrow radix (8 warps a block, 8
    steps a warp) the sums match the plain version and the first 16 rows
    alone give the full launch's bits."""
    rng = np.random.default_rng(radix + 1)
    values = rng.normal(size=(24, 4, 16384)).astype(np.float32) * 10
    values[:, 0] = 1.0
    mask = (rng.random((24, 16384)) < 0.7).astype(np.float32)
    codes = rng.integers(-1, radix + 2, size=(24, 16384)).astype(np.int32)
    full = [torch.from_numpy(a).to(cuda) for a in (values, mask, codes)]
    got = groupagg.group_aggregate(*full, radix)
    assert torch.equal(got, groupagg.group_aggregate(*full, radix))
    _check_sums(got.cpu().numpy(), groupagg.group_aggregate_plain(*full, radix).cpu().numpy())
    part = [t[:16].contiguous() for t in full]
    np.testing.assert_array_equal(_bits(groupagg.group_aggregate(*part, radix)),
                                  _bits(got[:16]))


def _agg_case(kind, seed=5):
    """(values, mask, codes, radix) of one stress case of group_aggregate."""
    rng = np.random.default_rng(seed)
    p, v, r, radix, density = {
        "sparse-mask": (6, 4, 4096, 2048, 0.03),
        "radix-4": (6, 4, 4096, 4, 1.0),
        "ragged": (5, 3, 3001, 130, 0.7),  # R off every step and tile
        "v-32": (3, 32, 1500, 512, 0.8),  # 8 component tiles
        "group-tiles": (2, 4, 700, 13000, 1.0),  # radix over one warp's accumulator
        "one-group": (4, 4, 2048, 1, 1.0),  # every set spans the warp
    }[kind]
    values = rng.normal(size=(p, v, r)).astype(np.float32)
    values[:, 0] = 1.0  # component 0 counts rows
    mask = (rng.random((p, r)) < density).astype(np.float32)
    codes = rng.integers(-1, radix + 2, size=(p, r)).astype(np.int32)
    return values, mask, codes, radix


@pytest.mark.parametrize("kind", ["sparse-mask", "radix-4", "ragged", "v-32", "group-tiles",
                                  "one-group"])
def test_group_aggregate_stress_matches_plain(cuda, kind):
    values, mask, codes, radix = _agg_case(kind)
    args = [torch.from_numpy(a).to(cuda) for a in (values, mask, codes)]
    got = groupagg.group_aggregate(*args, radix)
    again = groupagg.group_aggregate(*args, radix)
    want = groupagg.group_aggregate_plain(*args, radix)
    assert torch.equal(got, again)
    _check_sums(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("radix", [4, 2048])
def test_group_aggregate_slice_equals_full(cuda, radix):
    """A stack row's sums depend only on that row: the first 16 rows
    launched alone give the bits the full launch gives them (the
    streaming path's delta == cold contract)."""
    rng = np.random.default_rng(radix)
    values = rng.normal(size=(40, 4, 2500)).astype(np.float32) * 100
    values[:, 0] = 1.0
    mask = np.ones((40, 2500), np.float32)
    codes = rng.integers(0, radix, size=(40, 2500)).astype(np.int32)
    full = [torch.from_numpy(a).to(cuda) for a in (values, mask, codes)]
    part = [t[:16].contiguous() for t in full]
    got_full = groupagg.group_aggregate(*full, radix)
    got_part = groupagg.group_aggregate(*part, radix)
    assert torch.equal(got_part, groupagg.group_aggregate(*part, radix))
    np.testing.assert_array_equal(_bits(got_part), _bits(got_full[:16]))


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


def _tree_hist_stress(kind, seed=11):
    """(codes (R, C), feat ids, node, g, h, nodes, feats, bins) of one
    stress case of tree_hist."""
    rng = np.random.default_rng(seed)
    if kind == "leaf-sum":  # gbdt's leaf sums: 1 column, 32 nodes, 1 bin
        r, nt = 4096, 3000
        codes = np.zeros((r, 1), np.int32)
        fids = np.zeros(1, np.int32)
        node = np.full(r, -1, np.int32)
        node[:nt] = rng.integers(0, 32, size=nt)
        nodes, f, nbins = 32, 1, 1
    else:
        r, c, f = {"level-0": (4096, 5, 9), "one-segment": (2048, 2, 3),
                   "ragged": (3001, 3, 4)}[kind]
        codes = rng.integers(0, 256, size=(r, c)).astype(np.int32)
        fids = np.sort(rng.choice(f, size=c, replace=False)).astype(np.int32)
        if kind == "level-0":  # every row in node 0; column 0 near-constant
            node = np.zeros(r, np.int32)
            node[-300:] = -1
            codes[rng.random(r) < 0.97, 0] = 17
            nodes = 16
        elif kind == "one-segment":  # every 32-row step in one segment
            node = np.full(r, 3, np.int32)
            codes[:, 0] = 200
            nodes = 4
        else:
            node = rng.integers(-1, 16, size=r).astype(np.int32)
            nodes = 16
        nbins = 256
    g = (rng.normal(size=r) * 10.0 ** rng.integers(-3, 4, size=r)).astype(np.float32)
    h = np.abs(rng.normal(size=r)).astype(np.float32)
    return codes, fids, node, g, h, nodes, f, nbins


@pytest.mark.parametrize("kind", ["level-0", "leaf-sum", "one-segment", "ragged"])
def test_tree_hist_stress_matches_plain_bitwise(cuda, kind):
    codes, fids, node, g, h, nodes, f, nbins = _tree_hist_stress(kind)
    codes_t = torch.from_numpy(np.ascontiguousarray(codes.T)).to(cuda)
    args = (codes_t.T, *[torch.from_numpy(a).to(cuda) for a in (fids, node, g, h)],
            nodes, f, nbins)
    got = tree_hist.tree_hist(*args)
    again = tree_hist.tree_hist(*args)
    want = tree_hist.tree_hist_plain(*args)
    np.testing.assert_array_equal(_bits(got), _bits(again))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", [(3, 256), (2, 16, 476, 256), (70, 1000)])
def test_cumsum_seq_matches_plain_bitwise(cuda, shape):
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy((rng.normal(size=shape) * 1e3).astype(np.float32)).to(cuda)
    got = tree_hist.cumsum_seq(x)
    want = tree_hist.cumsum_seq_plain(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), np.cumsum(x.cpu().numpy(), axis=-1).view(np.uint32))


@pytest.mark.parametrize("n,k,f", [(16, 4, 8), (100, 13, 37), (256, 128, 130), (33, 5, 300),
                                   (1024, 256, 476),
                                   # feature selection's other center buckets, N and K
                                   # off every tile, a ragged F (474: 4-byte copies)
                                   (1024, 64, 476), (1024, 128, 476), (1017, 200, 476),
                                   (1000, 96, 474)])
def test_pdist_sq_matches_plain(cuda, n, k, f):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(k, f)).astype(np.float32)).to(cuda)
    got = pdist.pdist_sq(x, c)
    assert torch.equal(got, pdist.pdist_sq(x, c))
    want = pdist.pdist_sq_plain(x, c)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-3)
    assert torch.equal(got.argmin(dim=1), want.argmin(dim=1))


def test_pdist_sq_unaligned_operands(cuda):
    """Operands that start off a 16-byte boundary take the 4-byte copies
    and give the bits the aligned launch gives."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(300, 476)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(size=(70, 476)).astype(np.float32)).to(cuda)
    xs = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    cs = torch.empty(c.numel() + 1, device=cuda)[1:].view(c.shape)
    xs.copy_(x)
    cs.copy_(c)
    assert xs.data_ptr() % 16 != 0
    np.testing.assert_array_equal(_bits(pdist.pdist_sq(xs, cs)), _bits(pdist.pdist_sq(x, c)))


def test_pdist_sq_nan_propagates(cuda):
    x = torch.ones((20, 9), device=cuda)
    x[3, 4] = float("nan")
    c = torch.zeros((5, 9), device=cuda)
    got = pdist.pdist_sq(x, c)
    assert torch.isnan(got[3]).all() and not torch.isnan(got[torch.arange(20) != 3]).any()


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


# --------------------------------------------------------------------------
# predicate_eval and the streaming append path
# --------------------------------------------------------------------------
@pytest.mark.parametrize(
    "p,c,g,r,nan_every,per_partition",
    [
        (3, 4, 2, 1001, 0, False),  # R off the 256-row tile
        (2, 5, 3, 4096, 7, True),  # NaN rows, per-partition bounds and 3-D map
        (2, 64, 9, 777, 5, True),  # every clause bit of the word
        (4, 0, 0, 300, 0, False),  # zero clauses, no OR-group: every row
        (2, 0, 1, 300, 0, False),  # an OR-group without members: no row
        (1, 8, 8, 16384, 3, False),
    ],
)
def test_predicate_eval_matches_plain(cuda, p, c, g, r, nan_every, per_partition):
    rng = np.random.default_rng(p * 1000 + c + r)
    cols = (rng.normal(size=(p, c, r)) * 2).astype(np.float32)
    if nan_every:
        cols[:, :, ::nan_every] = np.nan
    bshape = (p, c) if per_partition else (c,)
    lo = (rng.normal(size=bshape) - 0.5).astype(np.float32)
    hi = (lo + np.abs(rng.normal(size=bshape)) + 0.7).astype(np.float32)
    gid = rng.integers(0, max(g, 1), size=(p, c) if per_partition else (c,))
    gmap = np.eye(max(g, 1), dtype=np.float32)[gid][..., :g]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in (cols, lo, hi, gmap)]
    mask, cnt = predicate.predicate_eval(*args, g)
    mask2, cnt2 = predicate.predicate_eval(*args, g)
    torch.cuda.synchronize()
    want_mask, want_cnt = predicate.predicate_eval_plain(*args)
    for got, again, want in ((mask, mask2, want_mask), (cnt, cnt2, want_cnt)):
        np.testing.assert_array_equal(_bits(got), _bits(again))
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_failed_launch_raises(cuda):
    """A CUDA operand the kernel refuses (more 256-row tiles than a grid
    dimension holds) raises; it never returns the plain result."""
    r = 65536 * 256 + 1
    cols = torch.zeros((1, 1, r), device=cuda)
    lo, hi = torch.zeros(1, device=cuda), torch.ones(1, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        predicate.predicate_eval(cols, lo, hi, torch.ones((1, 1), device=cuda), 1)


def test_predicate_mask_device_on_cuda_matches_host(cuda):
    table = make_dataset("tpch", num_partitions=8, rows_per_partition=3000, seed=1)
    queries = WorkloadSpec(table, seed=4).sample_workload(24)
    cache = EvalCache(table, options=ExecOptions(device=str(cuda)))
    _build.LAUNCHES.reset()
    checked = 0
    for q in queries:
        got = device.predicate_mask_device(table, q.predicate, cache)
        if got is not None:
            np.testing.assert_array_equal(got, predicate_mask(table, q.predicate))
            checked += 1
    assert checked >= 8 and _build.LAUNCHES.counts()[("predicate_eval",)] > 0


def test_append_stream_on_cuda_equals_cold_rebuild(cuda):
    """Three appends (in-bucket, in-bucket, bucket overflow) folded on the
    card: sketches and answers bit-equal to a cold rebuild on the card."""
    opts = ExecOptions(device=str(cuda))
    table = make_dataset("tpch", num_partitions=12, rows_per_partition=2048, seed=0)
    queries = WorkloadSpec(table, seed=0).sample_workload(24)
    sketches = SketchStore(table, options=opts)
    answers = AnswerStore(table, options=opts)
    answers.get_batch(queries)
    for parts, seed in ((2, 1), (2, 2), (5, 3)):
        append_partitions(table, make_dataset("tpch", num_partitions=parts,
                                              rows_per_partition=2048, layout="random",
                                              seed=seed))
        sk, cold_sk = sketches.sketches(), build_sketches(table, options=opts)
        for name, cs in cold_sk.columns.items():
            d = sk.columns[name]
            for field in ("measures", "hist_edges", "cat_counts", "ndv", "dv_freq",
                          "hh_stats", "global_hh", "bitmap", "part_spans"):
                if getattr(cs, field) is None:
                    assert getattr(d, field) is None
                else:
                    np.testing.assert_array_equal(getattr(d, field), getattr(cs, field))
            assert d.hh_items == cs.hh_items and d.discrete_span == cs.discrete_span
        got = answers.get_batch(queries)
        cold = per_partition_answers_batch(table, queries, options=opts,
                                           cache=EvalCache(table, options=opts))
        for a, b in zip(got, cold):
            np.testing.assert_array_equal(a.group_keys, b.group_keys)
            np.testing.assert_array_equal(a.raw, b.raw)
    assert sketches.incremental_updates == 3 and sketches.full_rebuilds == 0
    assert answers.carried >= len(queries)
