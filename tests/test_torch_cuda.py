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
run (no float atomics); a group_aggregate, fused_eval, moments or
histogram_range launch over the first stack rows gives the bits a full
launch gives them, and fused_eval with a predicate every row passes
gives group_aggregate's bits (one shared aggregation).  The device GBDT fit on the card exports the
host fit's forest bit for bit.  A stream of appends folded on the card
equals a cold rebuild of the grown table bit for bit.  A qwen-smoke train
step on the card agrees with the CPU (the loss, every gradient and two
steps' losses, at the CPU parity tests' tolerances), and so do the MoE,
hybrid, SSM, encoder-decoder and VLM smoke models' prefill and decode
steps, and their loss, gradients and a train step.
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
import torch_threads

torch_threads.cap_under_xdist()

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


def _offset(t):
    """``t``'s values in a tensor whose base is 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


def test_moments_slice_equals_full(cuda):
    """A partition's statistics depend only on its row and R: the first 16
    partitions alone give the bits the full launch gives them."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy((rng.normal(size=(40, 16384)) * 100 + 50).astype(np.float32)).to(cuda)
    full = moments.moments(x)
    part = moments.moments(x[:16].clone())
    np.testing.assert_array_equal(_bits(part), _bits(full[:16]))


@pytest.mark.parametrize("nb", [10, 33])
def test_histogram_range_slice_equals_full(cuda, nb):
    """300 partitions run one block each, 16 partitions a cluster of blocks
    each: the counts are the same."""
    rng = np.random.default_rng(nb)
    x = rng.normal(size=(300, 4096)).astype(np.float32)
    e = np.quantile(x.astype(np.float64), np.linspace(0, 1, nb + 1), axis=1).T
    xt = torch.from_numpy(x).to(cuda)
    et = torch.from_numpy(np.ascontiguousarray(e, np.float32)).to(cuda)
    full = histogram.histogram_range(xt, et)
    part = histogram.histogram_range(xt[:16].clone(), et[:16].clone())
    assert torch.equal(part, full[:16])
    assert torch.equal(full, histogram.histogram_range_plain(xt, et))


@pytest.mark.parametrize("shape", [(1, 128), (3, 100), (4, 1024), (7, 2050), (2, 16384)])
@pytest.mark.parametrize("kind", ["normal", "nonfinite", "offset"])
def test_moments_matches_plain(cuda, shape, kind):
    rng = np.random.default_rng(shape[1])
    x = (rng.normal(size=shape) * 3 + 1.5).astype(np.float32)
    if shape[0] > 1:
        x[0, 5] = np.nan  # NaN propagates into every statistic of its row
    if kind == "nonfinite":  # mixed sign with ±inf, both infinities, an all-NaN row
        x[-1, 3], x[-1, 4] = np.inf, -np.inf
        if shape[0] > 2:
            x[1, 2] = np.inf
            x[2] = np.nan
    t = torch.from_numpy(x).to(cuda)
    if kind == "offset":  # rows not 16-byte aligned: 4-byte loads, the same bits
        aligned = moments.moments(t)
        t = _offset(t)
    got = moments.moments(t)
    again = moments.moments(t)
    want = moments.moments_plain(t)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(g, again.cpu().numpy())  # NaN-aware bit equality
    if kind == "offset":
        np.testing.assert_array_equal(_bits(got), _bits(aligned))
    exact = [0, 1, 4, 5]  # min/max of x and of log x
    np.testing.assert_array_equal(g[:, [0, 1]], w[:, [0, 1]])
    np.testing.assert_allclose(g[:, exact], w[:, exact], rtol=1e-6)  # logf vs torch.log: ulps
    np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-4)


def test_moments_rejects_zero_rows(cuda):
    with pytest.raises(ValueError):
        moments.moments(torch.zeros((3, 0), device=cuda))


@pytest.mark.parametrize("shape", [(1, 128), (3, 100), (7, 2050), (4, 16384)])
@pytest.mark.parametrize("nb", [4, 10, 33])
@pytest.mark.parametrize("edges", ["quantile", "duplicate", "unsorted", "nan", "inf", "offset"])
def test_histogram_range_matches_plain(cuda, shape, nb, edges):
    """Bit-equal to the plain version on quantile edges (the cumulative
    path) and on edges that need the reference's test of each bucket:
    duplicate, unsorted, NaN (an all-NaN partition), infinite values and
    ends; and on a base 4 bytes past a 16-byte boundary."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    if edges == "duplicate":
        x = np.round(x).astype(np.float32)
    if edges == "nan":
        x[0] = np.nan
    if edges == "inf":
        x[:, 3::17], x[:, 4::17] = np.inf, -np.inf
    with np.errstate(invalid="ignore"):  # inf - inf between infinite quantiles
        e = np.quantile(x.astype(np.float64), np.linspace(0, 1, nb + 1), axis=1).T
    e = np.ascontiguousarray(e, np.float32)
    if edges == "unsorted":
        e = np.ascontiguousarray(e[:, rng.permutation(nb + 1)])
    if edges == "inf":
        e[0, 0], e[0, -1] = -np.inf, np.inf
    x[:, ::11] = np.nan
    x[:, 1 % shape[1]] = e[:, -1]  # the last bucket is closed
    x[:, 2 % shape[1]] = e[:, -1] + 1  # above the top edge: nowhere
    xt = torch.from_numpy(x).to(cuda)
    et = torch.from_numpy(e).to(cuda)
    if edges == "offset":
        xt = _offset(xt)
    got = histogram.histogram_range(xt, et)
    assert torch.equal(got, histogram.histogram_range(xt, et))
    assert torch.equal(got, histogram.histogram_range_plain(xt, et))


@pytest.mark.parametrize("nb", [10, 33])
def test_histogram_range_launches_at_every_nb(cuda, nb):
    """NB = 10 runs an instance of its own, NB = 33 the general kernel:
    both launch a kernel, counted once."""
    x = torch.rand((4, 1000), device=cuda)
    e = torch.sort(torch.rand((4, nb + 1), device=cuda), dim=1).values
    _build.LAUNCHES.reset()
    got = histogram.histogram_range(x, e)
    assert _build.LAUNCHES.counts() == {("histogram_range",): 1}
    assert torch.equal(got, histogram.histogram_range_plain(x, e))


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


# --------------------------------------------------------------------------
# the serving path: the relaxed fit, faulted reads and the front door
# --------------------------------------------------------------------------
def test_relaxed_fit_on_cuda_allclose_to_host(cuda):
    """``parity_relaxation`` on the card: the levels launch tree_hist and
    cumsum_seq, the boosting update stays on the device; the forest is
    within the reference's tolerances of the host fit."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3000, 12))
    y = x @ rng.normal(size=12) + np.sin(x[:, 0] * 3)
    kw = dict(num_trees=8, depth=4, rowsample=0.7, colsample=0.8, seed=2)
    _build.LAUNCHES.reset()
    got = gbdt.fit_gbdt(x, y, options=ExecOptions(device=str(cuda)), parity_relaxation=True,
                        **kw)
    launches = _build.LAUNCHES.counts()
    assert launches[("tree_hist",)] > 0 and launches[("cumsum_seq",)] > 0
    want = gbdt.fit_gbdt(x, y, options=ExecOptions(backend="host"), **kw)
    np.testing.assert_array_equal(got.feat, want.feat)
    np.testing.assert_array_equal(got.thr, want.thr)
    np.testing.assert_allclose(got.leaf, want.leaf, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.predict(x), want.predict(x), rtol=1e-4, atol=1e-4)


def _tiny_session(options):
    from repro_torch import api
    from repro_torch.core.picker import PickerConfig

    table = make_dataset("tpch", num_partitions=48, rows_per_partition=1024, seed=0)
    sess = api.Session(table, options=options)
    sess.prepare(WorkloadSpec(table, seed=0), num_train_queries=12,
                 picker_config=PickerConfig(num_trees=8, tree_depth=3, feature_selection=False))
    return sess


def test_faulted_planner_on_cuda_matches_host(cuda):
    """The same policy loses the same partitions on the card as on the
    port's host backend, and the estimates agree within rtol 1e-5."""
    from repro_torch.faults import FaultPolicy
    from repro_torch.planner import QueryPlanner

    policy = FaultPolicy(seed=20240807, dead_frac=0.05, fail_frac=0.05, timeout_frac=0.02,
                         straggler_frac=0.05)
    sess = _tiny_session(ExecOptions(device=str(cuda)))
    card = QueryPlanner(sess.picker, AnswerStore(sess.table, options=sess.options.replace(
        faults=policy)))
    host = QueryPlanner(sess.picker, AnswerStore(sess.table, options=ExecOptions(
        backend="host", faults=policy)))
    _build.LAUNCHES.reset()
    failed = 0
    for q in WorkloadSpec(sess.table, seed=7).sample_workload(8):
        for bound in (0.05, 1e-6):
            got, want = card.answer(q, error_bound=bound), host.answer(q, error_bound=bound)
            assert got.plan.failed_ids == want.plan.failed_ids
            assert (got.partitions_read, got.plan.schedule) == \
                (want.partitions_read, want.plan.schedule)
            np.testing.assert_array_equal(got.group_keys, want.group_keys)
            np.testing.assert_allclose(got.estimate, want.estimate, rtol=1e-5)
            failed += got.plan.partitions_failed
    assert failed > 0
    assert _build.LAUNCHES.counts().get(("fused_eval",), 0) > 0


def test_frontdoor_pump_on_cuda_resolves_every_ticket(cuda):
    """The real-clock pump thread launches the kernels: four requests from
    two submitter threads all resolve on a card Session."""
    import threading

    from repro_torch import api
    from repro_torch.serving import FrontDoor, FrontDoorConfig

    sess = _tiny_session(ExecOptions(device=str(cuda)))
    queries = WorkloadSpec(sess.table, seed=7).sample_workload(4)
    fd = FrontDoor(sess, config=FrontDoorConfig(tenant_rate=1e9, tenant_burst=1e9))
    results, errors = {}, []

    def client(k):
        try:
            for i in range(k, 4, 2):
                results[i] = fd.submit(api.QuerySpec(queries[i], error_bound=0.1),
                                       tenant=f"c{k}").result(timeout=120)
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    _build.LAUNCHES.reset()
    fd.start(interval=0.001)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        fd.stop()
    assert not errors, errors
    assert sorted(results) == [0, 1, 2, 3]
    assert fd.serve_stats()["completed"] == 4
    assert _build.LAUNCHES.counts().get(("fused_eval",), 0) > 0


def test_lifecycle_stack_rewrite_on_cuda(cuda):
    """A compaction and a rebalance rewrite the card's column stack in its
    shape bucket (``stack_rewrites`` counts 2, the dead tail is zero), and
    full-table answers over it are bit-equal to a cold `EvalCache`'s."""
    from repro_torch import lifecycle

    opts = ExecOptions(device=str(cuda))
    table = make_dataset("tpch", num_partitions=24, rows_per_partition=1024, seed=2)
    lifecycle.ensure_directory(table)
    queries = WorkloadSpec(table, seed=4).sample_workload(6)
    store = AnswerStore(table, options=opts)
    store.get_batch(queries)
    cache = store._eval_cache
    stack = cache.device_stack()
    lifecycle.delete_partitions(table, [1, 7, 8, 20])
    lifecycle.compact(table)
    store.get_batch(queries)  # the compaction folds before the rebalance
    lifecycle.rebalance(table, lifecycle.rebalance_plan(table, 4))
    _build.LAUNCHES.reset()
    got = store.get_batch(queries)
    assert store.misses == len(queries)  # every answer folded, none evaluated
    assert cache.stack_rewrites == 2 and cache.stack_rebuilds == 1
    assert cache.device_stack() is stack and stack.shape[1] == 32
    assert not stack[:, table.num_partitions:].any()
    cold_cache = EvalCache(table, options=opts)
    fresh = per_partition_answers_batch(table, queries, cache=cold_cache, options=opts)
    full = per_partition_answers_batch(table, queries, cache=cache, options=opts)
    for g, f, w in zip(got, full, fresh):
        np.testing.assert_array_equal(g.group_keys, w.group_keys)
        np.testing.assert_array_equal(g.raw.view(np.uint64), w.raw.view(np.uint64))
        np.testing.assert_array_equal(f.raw.view(np.uint64), w.raw.view(np.uint64))
    assert _build.LAUNCHES.counts().get(("fused_eval",), 0) > 0


def test_save_and_restore_on_cuda(cuda, tmp_path):
    """A snapshot restored on default options rebuilds the stack on the
    card and answers as the saved session."""
    from repro_torch import api

    sess = _tiny_session(api.ExecOptions())
    queries = WorkloadSpec(sess.table, seed=7).sample_workload(4)
    want = [sess.execute(api.QuerySpec(q, error_bound=0.05)) for q in queries]
    sess.save(str(tmp_path / "snap"))
    back = api.Session.restore(str(tmp_path / "snap"))
    assert back.options.device == "cuda"
    got = [back.execute(api.QuerySpec(q, budget=w.partitions_read))
           for q, w in zip(queries, want)]
    again = [sess.execute(api.QuerySpec(q, budget=w.partitions_read))
             for q, w in zip(queries, want)]
    for g, a in zip(got, again):
        assert g.partitions_read == a.partitions_read
        np.testing.assert_array_equal(g.group_keys, a.group_keys)
        assert g.estimate.tobytes() == a.estimate.tobytes()
        assert g.ci_halfwidth.tobytes() == a.ci_halfwidth.tobytes()
    assert back.answers._eval_cache.device_stack().device.type == "cuda"


# --------------------------------------------------------------------------
# the partition data plane on the card
# --------------------------------------------------------------------------
@pytest.fixture
def cuda2(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda:1")


def _plane_options(cuda):
    return ExecOptions(device=str(cuda), mesh=(f"cuda:{cuda.index or 0}",) * 3)


def test_logical_shard_plane_on_cuda_is_bit_equal(cuda):
    """A 3-logical-shard plane on one card (20 → 32 slots, 11 a shard, a
    pad partition in the last shard) gives the single-device path's bits:
    statistics, answers, and an append's fold across the shard boundary."""
    plane, single = _plane_options(cuda), ExecOptions(device=str(cuda))
    table = make_dataset("tpch", num_partitions=20, rows_per_partition=2048, seed=3)
    queries = WorkloadSpec(table, seed=5).sample_workload(12)
    from repro_torch.core import ingest

    want = ingest.build_statistics(table, discrete_counts=True, options=single)
    ingest_stats = ingest.build_statistics(table, discrete_counts=True, options=plane)
    for col, tensors in want.items():
        for key, val in tensors.items():
            assert np.asarray(val).tobytes() == np.asarray(ingest_stats[col][key]).tobytes()
    store = AnswerStore(table, options=plane)
    assert store.plane.num_devices == 3
    _build.LAUNCHES.reset()
    got = store.get_batch(queries)
    launches = {k[0]: n for k, n in _build.LAUNCHES.counts().items()}
    assert launches.get("fused_eval", 0) % 3 == 0 and launches.get("fused_eval", 0) > 0
    stack = store._eval_cache.device_stack()
    assert stack.shape[1] == 33 and [s.shape[1] for s in stack.shards] == [11] * 3

    def cold():
        return per_partition_answers_batch(table, queries, options=single,
                                           cache=EvalCache(table, options=single))

    for g, w in zip(got, cold()):
        np.testing.assert_array_equal(g.group_keys, w.group_keys)
        np.testing.assert_array_equal(g.raw.view(np.uint64), w.raw.view(np.uint64))
    delta = make_dataset("tpch", num_partitions=5, rows_per_partition=2048, layout="random",
                         seed=8)
    append_partitions(table, delta.columns)  # 20 → 25: slots 20..24 span shards 1 and 2
    got = store.get_batch(queries)
    assert store._eval_cache.stack_appends == 1
    for g, w in zip(got, cold()):
        np.testing.assert_array_equal(g.group_keys, w.group_keys)
        np.testing.assert_array_equal(g.raw.view(np.uint64), w.raw.view(np.uint64))


@pytest.mark.parametrize("radix,v", [(8, 4), (512, 2)])
def test_shard_rows_take_the_full_launch_bits(cuda, radix, v):
    """fused_eval and group_aggregate give a shard's rows the bits the full
    launch gives them where the shard's grid is below the SM count (the
    prefetching fused_eval instance) and the full launch's is not."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b = 3 * (sms - 2)  # three shards of sms - 2 rows
    arrs = _fused_case(b, 5, 2, v, 3000, radix, seed=radix)
    full = [torch.from_numpy(a).to(cuda) for a in arrs]
    got_full = fused.fused_eval(*full, radix)
    rng = np.random.default_rng(radix)
    mask = torch.from_numpy((rng.random((b, 3000)) < 0.7).astype(np.float32)).to(cuda)
    agg_full = groupagg.group_aggregate(full[4], mask, full[5], radix)
    local = b // 3
    for s in range(3):
        rows = slice(s * local, (s + 1) * local)
        part = [t[rows].contiguous() for t in full]
        np.testing.assert_array_equal(_bits(fused.fused_eval(*part, radix)),
                                      _bits(got_full[rows]))
        np.testing.assert_array_equal(
            _bits(groupagg.group_aggregate(part[4], mask[rows].contiguous(), part[5], radix)),
            _bits(agg_full[rows]))


def test_shared_memory_limit_is_raised_on_each_device(cuda, cuda2):
    """Launches whose shared memory needs the raised limit run on cuda:1
    after the same launches on cuda:0, and equal their plain versions."""
    arrs = _fused_case(6, 4, 2, 4, 3000, 2048, seed=4)
    for dev in (torch.device("cuda", 0), cuda2):
        ops = [torch.from_numpy(a).to(dev) for a in arrs]
        got = fused.fused_eval(*ops, 2048)
        assert got.device == dev
        _check_sums(got.cpu().numpy(), fused.fused_eval_plain(*ops, 2048).cpu().numpy())
        mask = torch.ones(ops[5].shape, dtype=torch.float32, device=dev)
        got = groupagg.group_aggregate(ops[4], mask, ops[5], 2048)
        _check_sums(got.cpu().numpy(),
                    groupagg.group_aggregate_plain(ops[4], mask, ops[5], 2048).cpu().numpy())
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.normal(size=(256, 130)).astype(np.float32)).to(dev)
        c = torch.from_numpy(rng.normal(size=(128, 130)).astype(np.float32)).to(dev)
        np.testing.assert_allclose(pdist.pdist_sq(x, c).cpu().numpy(),
                                   pdist.pdist_sq_plain(x, c).cpu().numpy(), rtol=1e-4,
                                   atol=1e-3)


def test_session_on_the_second_device(cuda, cuda2):
    """``ExecOptions(device="cuda:1")`` runs a Session's execute there, with
    the bits of the same Session on cuda:0."""
    from repro_torch import api

    queries = None
    results = []
    for dev in (cuda2, cuda):
        sess = _tiny_session(api.ExecOptions(device=f"cuda:{dev.index or 0}"))
        queries = queries or WorkloadSpec(sess.table, seed=7).sample_workload(3)
        results.append([sess.execute(api.QuerySpec(q, error_bound=0.05)) for q in queries])
        assert sess.answers._eval_cache.device_stack().device == torch.device(
            f"cuda:{dev.index or 0}")
    for a, b in zip(*results):
        assert a.partitions_read == b.partitions_read
        assert a.estimate.tobytes() == b.estimate.tobytes()


def test_plane_across_devices_is_bit_equal(cuda, cuda2, monkeypatch):
    """A plane over every visible card (``REPRO_MESH=all`` through
    ``mesh="auto"``): each shard on its own device, launched on it, and the
    statistics, answers and an append's fold bit-equal to one card's."""
    from repro_torch.core import ingest

    single = ExecOptions(device=str(cuda))
    monkeypatch.setenv("REPRO_MESH", "all")
    opts = ExecOptions(device=str(cuda), mesh="auto")
    plane = opts.plane()
    assert plane.num_devices == torch.cuda.device_count()
    table = make_dataset("tpch", num_partitions=30, rows_per_partition=4096, seed=6)
    queries = WorkloadSpec(table, seed=2).sample_workload(12)
    want = ingest.build_statistics(table, discrete_counts=True, options=single)
    got = ingest.build_statistics(table, discrete_counts=True, options=opts)
    for col, tensors in want.items():
        for key, val in tensors.items():
            assert np.asarray(val).tobytes() == np.asarray(got[col][key]).tobytes()
    store = AnswerStore(table, options=opts)
    assert store.plane is not None
    for step in range(2):
        got = store.get_batch(queries)
        stack = store._eval_cache.device_stack()
        assert [s.device for s in stack.shards] == list(plane.devices)
        cold = per_partition_answers_batch(table, queries, options=single,
                                           cache=EvalCache(table, options=single))
        for g, w in zip(got, cold):
            np.testing.assert_array_equal(g.group_keys, w.group_keys)
            np.testing.assert_array_equal(g.raw.view(np.uint64), w.raw.view(np.uint64))
        if step == 0:
            delta = make_dataset("tpch", num_partitions=2, rows_per_partition=4096,
                                 layout="random", seed=3)
            append_partitions(table, delta.columns)
    assert store._eval_cache.stack_appends == 1


def test_train_step_card_matches_cpu(cuda):
    """A qwen-smoke train step on the card against the CPU, from the same
    weights and batches: `lm.loss_fn` at ``rtol=1e-3`` and each gradient
    leaf within a relative L2 error of ``5e-2`` (two bf16 lowerings; the
    CPU tests' tolerances, `tests/test_torch_train.py`), then two
    `make_train_step` steps whose losses agree at ``rtol=2e-2``."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = get_smoke("qwen1_5_0_5b")
    models = {"cpu": lm.init_params(cfg, torch.Generator().manual_seed(0))}
    models["card"] = copy.deepcopy(models["cpu"]).to(cuda)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (3, 4, 17))
    batches = [{"tokens": t[:, :-1], "targets": t[:, 1:],
                "loss_weights": rng.uniform(0.2, 2.0, 4).astype(np.float32)} for t in toks]
    grads, losses = {}, {}
    ocfg = opt.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=6)
    for where, model in models.items():
        dev = cuda if where == "card" else torch.device("cpu")
        model.requires_grad_(True)
        loss, _ = lm.loss_fn(cfg, model, batch_tensors(batches[0], dev))
        names, leaves = zip(*model.named_parameters())
        grads[where] = dict(zip(names, (g.float().cpu() for g in
                                        torch.autograd.grad(loss, leaves))))
        losses[where] = [float(loss.detach())]
        step = steps.make_train_step(cfg, ocfg, steps.TrainOptions(remat=False))
        state = opt.init_state(ocfg, lm.param_tree(model))
        for batch in batches[1:]:
            model, state, metrics = step(model, state, batch_tensors(batch, dev))
            losses[where].append(float(metrics["loss"]))
    np.testing.assert_allclose(losses["card"][0], losses["cpu"][0], rtol=1e-3)
    np.testing.assert_allclose(losses["card"][1:], losses["cpu"][1:], rtol=2e-2)
    for name, want in grads["cpu"].items():
        rel = float((grads["card"][name] - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= 5e-2, (name, rel)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v2_236b"])
def test_moe_smoke_card_matches_cpu(cuda, arch, monkeypatch):
    """The MoE smoke models (experts, a window; MLA, a leading dense layer,
    shared experts) on the card against the CPU, from the same weights: a
    prefill of 2 × 12 tokens and 3 decode steps fed the CPU's greedy
    tokens, the logits at ``rtol=5e-2, atol=5e-2`` with a correlation
    above 0.999 (two lowerings, `tests/test_arch_smoke.py`), each MoE
    call's ``drop_frac`` equal (to the f32 mean's rounding).  The experts
    are scaled by fan-in, as the CPU tests' weights are (the reference's
    1/sqrt(E) init makes their outputs about 100 times the residual,
    whose bf16 rounding the two lowerings then split).  A token routed to other experts must have
    router logits that agree at the same tolerance (a near tie that the
    rounding breaks); its row is compared only before it."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.models import lm, moe

    cfg = get_smoke(arch)
    models = {"cpu": lm.init_params(cfg, torch.Generator().manual_seed(0))}
    for blk in models["cpu"].blocks:
        for name in ("wi", "wg", "wo"):
            w = getattr(blk.ffn, name)
            w.copy_((w.float() * np.sqrt(w.shape[0] / w.shape[1])).to(w.dtype))
    models["card"] = copy.deepcopy(models["cpu"]).to(cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))
    routed, drops, outs, fed = {}, {}, {}, []
    real_route, real_apply = moe.route, moe.moe_apply
    for where in ("cpu", "card"):
        dev = cuda if where == "card" else torch.device("cpu")
        routed[where], drops[where] = [], []

        def route(p, xt, c, sink=routed[where]):
            out = real_route(p, xt, c)
            sink.append((out[0].cpu(), out[3].cpu()))
            return out

        def moe_apply(p, x, c, sink=drops[where]):
            y, aux = real_apply(p, x, c)
            sink.append(float(aux["drop_frac"]))
            return y, aux

        monkeypatch.setattr(moe, "route", route)
        monkeypatch.setattr(moe, "moe_apply", moe_apply)
        with torch.inference_mode():
            logits, cache = lm.prefill(cfg, models[where], tokens.to(dev), 20)
            seen = [logits]
            for i in range(3):
                if where == "cpu":
                    fed.append(torch.argmax(seen[-1][:, -1:], dim=-1))
                step, cache = lm.decode_step(cfg, models[where], cache, fed[i].to(dev), 12 + i)
                seen.append(step)
        outs[where] = [x.float().cpu() for x in seen]
    # f32 means of equal keep masks agree to 1e-6 (a slot apart is ≥ 1e-3)
    np.testing.assert_allclose(drops["card"], drops["cpu"], rtol=0, atol=1e-6)
    # each row's first routed-apart position: prefill positions, then steps
    first = np.full(2, 15)
    n_moe = len(models["cpu"].blocks)
    for call, ((l_cpu, i_cpu), (l_card, i_card)) in enumerate(zip(routed["cpu"], routed["card"])):
        apart = (i_cpu.sort(1).values != i_card.sort(1).values).any(1)
        for tok in np.flatnonzero(apart.numpy()):
            np.testing.assert_allclose(l_card[tok].numpy(), l_cpu[tok].numpy(), rtol=5e-2,
                                       atol=5e-2)
            row, pos = divmod(int(tok), 12) if call < n_moe else (int(tok), 12 + call // n_moe - 1)
            first[row] = min(first[row], pos)
    for i, (got, want) in enumerate(zip(outs["card"], outs["cpu"])):
        pos = np.arange(12)[None, :] if i == 0 else np.full((1, 1), 11 + i)
        keep = torch.as_tensor(pos < first[:, None])
        a, b = want[keep], got[keep]
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-2, atol=5e-2)
        assert np.corrcoef(a.ravel().numpy(), b.ravel().numpy())[0, 1] > 0.999
    assert (first > 11).any()


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mamba2_130m"])
def test_recurrent_smoke_card_matches_cpu(cuda, arch):
    """rg-smoke (RG-LRU blocks, local MQA attention, a ragged tail) and
    mamba2-smoke (SSD blocks) on the card against the CPU, from the same
    weights: a prefill of 2 × 12 tokens and 3 decode steps fed the CPU's
    greedy tokens, the logits at ``rtol=5e-2, atol=5e-2`` (``atol=0.15``
    for the hybrid, `tests/test_arch_smoke.py`) with a correlation above
    0.999, and every layer's cache after the last step (the conv rings,
    the f32 recurrent states, the attention's K/V) at the same rule."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.models import lm

    cfg = get_smoke(arch)
    tol = dict(rtol=5e-2, atol=0.15 if cfg.family == "hybrid" else 5e-2)
    models = {"cpu": lm.init_params(cfg, torch.Generator().manual_seed(0))}
    models["card"] = copy.deepcopy(models["cpu"]).to(cuda)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))
    outs, caches, fed = {}, {}, []
    for where in ("cpu", "card"):
        dev = cuda if where == "card" else torch.device("cpu")
        with torch.inference_mode():
            logits, cache = lm.prefill(cfg, models[where], tokens.to(dev), 20)
            seen = [logits]
            for i in range(3):
                if where == "cpu":
                    fed.append(torch.argmax(seen[-1][:, -1:], dim=-1))
                step, cache = lm.decode_step(cfg, models[where], cache, fed[i].to(dev), 12 + i)
                seen.append(step)
        outs[where] = [x.float().cpu() for x in seen]
        caches[where] = [{k: v.float().cpu() for k, v in c.items()} for c in cache]
    pairs = list(zip(outs["card"], outs["cpu"]))
    pairs += [(g[k], w[k]) for g, w in zip(caches["card"], caches["cpu"]) for k in w]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
        if want.any():
            assert np.corrcoef(want.ravel().numpy(), got.ravel().numpy())[0, 1] > 0.999


@pytest.mark.parametrize("arch", ["whisper_small", "internvl2_26b"])
def test_encdec_vlm_smoke_card_matches_cpu(cuda, arch):
    """whisper-smoke (the encoder, cross-attention over its frames) and
    internvl-smoke (an image prefix) on the card against the CPU, from the
    same weights and extras (`serve.draw_extras`): a prefill of 2 × 12
    tokens and 3 decode steps fed the CPU's greedy tokens, the logits at
    ``rtol=5e-2, atol=5e-2`` with a correlation above 0.999
    (`tests/test_arch_smoke.py`), and every layer's cache after the last
    step (whisper's ``cross_k``/``cross_v`` beside K/V) at the same rule."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_smoke(arch)
    models = {"cpu": lm.init_params(cfg, torch.Generator().manual_seed(0))}
    models["card"] = copy.deepcopy(models["cpu"]).to(cuda)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12)))
    extras = serve.draw_extras(cfg, rng, 2, "cpu")
    pos0 = serve.prefix_len(cfg) + 12
    outs, caches, fed = {}, {}, []
    for where in ("cpu", "card"):
        dev = cuda if where == "card" else torch.device("cpu")
        with torch.inference_mode():
            logits, cache = lm.prefill(cfg, models[where], tokens.to(dev), pos0 + 3,
                                       **{k: v.to(dev) for k, v in extras.items()})
            seen = [logits]
            for i in range(3):
                if where == "cpu":
                    fed.append(torch.argmax(seen[-1][:, -1:], dim=-1))
                step, cache = lm.decode_step(cfg, models[where], cache, fed[i].to(dev), pos0 + i)
                seen.append(step)
        outs[where] = [x.float().cpu() for x in seen]
        caches[where] = [{k: v.float().cpu() for k, v in c.items()} for c in cache]
    pairs = list(zip(outs["card"], outs["cpu"]))
    pairs += [(g[k], w[k]) for g, w in zip(caches["card"], caches["cpu"]) for k in w]
    assert all("cross_k" in c for c in caches["cpu"]) == (cfg.family == "encdec")
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-2, atol=5e-2)
        if want.any():
            assert np.corrcoef(want.ravel().numpy(), got.ravel().numpy())[0, 1] > 0.999


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v2_236b", "recurrentgemma_9b",
                                  "mamba2_130m", "whisper_small", "internvl2_26b"])
def test_family_train_step_card_matches_cpu(cuda, arch, monkeypatch):
    """A train step of each family beyond the dense one (MoE, hybrid, SSM,
    encoder-decoder, VLM) on its smoke config, card against CPU from the
    same weights and batches (whisper's frames and internvl's image
    embeddings drawn as `serve.draw_extras` draws them): `lm.loss_fn`,
    its router terms and every gradient leaf at the CPU tests'
    tolerances (``rtol=1e-3``; relative L2 ``5e-2``), then one
    `make_train_step` step each whose losses agree at ``rtol=2e-2``.  The
    card takes the CPU's routing decisions (each MoE call's expert ids),
    so that a near tie that the two lowerings break apart moves no
    gradient; the experts are scaled by fan-in, as in
    `test_moe_smoke_card_matches_cpu`."""
    import copy

    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.launch.train import batch_tensors
    from repro_torch.models import lm, moe
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    cfg = get_smoke(arch)
    models = {"cpu": lm.init_params(cfg, torch.Generator().manual_seed(0))}
    if cfg.is_moe:
        for blk in models["cpu"].blocks:
            for name in ("wi", "wg", "wo"):
                w = getattr(blk.ffn, name)
                w.copy_((w.float() * np.sqrt(w.shape[0] / w.shape[1])).to(w.dtype))
    models["card"] = copy.deepcopy(models["cpu"]).to(cuda)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 4, 17))
    batches = [{"tokens": t[:, :-1], "targets": t[:, 1:],
                "loss_weights": rng.uniform(0.2, 2.0, 4).astype(np.float32)} for t in toks]
    extras = [serve.draw_extras(cfg, rng, 4, "cpu") for _ in batches]
    routed, real_route = [], moe.route

    def route(p, xt, c):
        logits, probs, gates, idx = real_route(p, xt, c)
        if xt.device.type == "cpu":
            routed.append(idx)
        else:
            idx = routed.pop(0).to(xt.device)
            gates = torch.gather(probs, 1, idx)
            gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return logits, probs, gates, idx

    monkeypatch.setattr(moe, "route", route)
    out = {}
    ocfg = opt.AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=6)
    for where in ("cpu", "card"):
        dev = cuda if where == "card" else torch.device("cpu")
        model = models[where].requires_grad_(True)
        data = [{**batch_tensors(b, dev), **{k: v.to(dev) for k, v in x.items()}}
                for b, x in zip(batches, extras)]
        loss, aux = lm.loss_fn(cfg, model, data[0])
        names, leaves = zip(*model.named_parameters())
        grads = dict(zip(names, (g.float().cpu() for g in torch.autograd.grad(loss, leaves))))
        step = steps.make_train_step(cfg, ocfg, steps.TrainOptions(remat=False))
        _, _, metrics = step(model, opt.init_state(ocfg, lm.param_tree(model)), data[1])
        out[where] = ([float(loss.detach())] + [float(aux[k].detach()) for k in ("lb_loss", "z_loss")],
                      grads, float(metrics["loss"]))
    assert not routed
    (cpu_l, cpu_g, cpu_step), (card_l, card_g, card_step) = out["cpu"], out["card"]
    np.testing.assert_allclose(card_l, cpu_l, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(card_step, cpu_step, rtol=2e-2)
    assert np.isfinite(card_step)
    for name, want in cpu_g.items():
        rel = float((card_g[name] - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= 5e-2, (name, rel)
