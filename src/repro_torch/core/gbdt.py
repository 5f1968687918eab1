"""Histogram-based gradient-boosted decision trees (the paper's XGBoost).

The paper trains k=4 XGBoost regressors per workload (§4.3, Appendix B.2);
this is the reference's own XGBoost-class histogram GBDT:

  * **Fit** (offline): features are quantile-binned to uint8 codes
    (256 bins).  Trees are grown level-wise to a fixed depth; split search
    computes per-(node, feature, bin) gradient/hessian histograms and picks
    the split maximizing the second-order gain
    GL²/(HL+λ) + GR²/(HR+λ) − G²/(H+λ).  Squared-error loss
    (g = pred − y, h = 1), matching Appendix B.2.  ``backend="host"`` is
    vectorized numpy; ``backend="device"`` runs the histograms, their
    prefix sums, the split search and the node partition of each tree on
    a torch device, through the tree_hist and cumsum_seq kernels
    (`kernels/tree_hist.py`: hand-written CUDA on the card, their plain
    versions on the CPU).
  * **Predict** (query time): the forest is exported as dense arrays
    (feature id / bin threshold per internal node, values per leaf) and
    traversed level by level on the host.

**Backend parity contract.**  Both backends accumulate histograms as f32
left folds in ascending row order per (node, feature, bin) segment —
`np.add.at` on the host, the tree_hist kernel on the device — take the
bin prefix sums as left folds (`np.cumsum` / cumsum_seq), run the split
search as the identical f32 expression DAG (separate eager ops: nothing
fuses a multiply-add into an FMA), and apply the boosting update as a
separately-rounded ``lr·leaf`` host-side step.  The exported forest is
therefore *bit-identical* across backends on the same binned codes, on
the CPU and on the card alike.

Fixed-depth complete trees keep both paths branch-free; unused subtrees are
padded (gain −inf splits are frozen into "always left" with value-copying
leaves).

**``parity_relaxation``** (`ExecOptions.parity_relaxation`, device
backend only) keeps y, w and the running prediction on the device for
the whole forest: gradients and the boosting update ``pred + lr·leaf``
run there, with one transfer in and one out per fit instead of per tree.
On the card the levels still launch the tree_hist and cumsum_seq
kernels; on the CPU the histograms become blocked one-hot matmuls
(`kernels/tree_hist.tree_hist_matmul`).  The forest is allclose to the
host fit, not bitwise equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.backends import ExecOptions
from repro_torch.core.clustering import bucket_size as _bucket
from repro_torch.kernels.telemetry import TraceRegistry
from repro_torch.kernels.tree_hist import cumsum_seq, tree_hist

NUM_BINS = 256  # uint8 codes

# device tree fits per (row bucket, features, subsample bucket, sampled
# features, depth) — the shape keys of the reference's compile census
TRACES = TraceRegistry("gbdt")


# --------------------------------------------------------------------------
# quantile binning
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Binner:
    """Per-feature quantile bin edges; code = #edges strictly below value."""

    edges: np.ndarray  # (n_features, NUM_BINS - 1)

    @staticmethod
    def fit(x: np.ndarray, num_bins: int = NUM_BINS) -> "Binner":
        qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
        edges = np.quantile(x, qs, axis=0).T  # (F, B-1)
        return Binner(np.ascontiguousarray(edges))

    def _lut(self):
        """Padded flat edges for the branchless search (built once, cached)."""
        lut = getattr(self, "_lut_cache", None)
        if lut is None:
            f, m = self.edges.shape
            width = 1 << m.bit_length()  # power of two > m ⇒ no bounds checks
            ep = np.full((f, width), np.inf)
            ep[:, :m] = self.edges
            lut = (
                ep.ravel(),
                (np.arange(f, dtype=np.int64) * width)[:, None],
                np.ascontiguousarray(ep[:, width // 2 - 1])[:, None],
                width,
            )
            self._lut_cache = lut
        return lut

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Vectorized `searchsorted(edges[f], x[:, f], side="right")`.

        One branchless binary search over every (row, feature) cell at
        once — ⌈log₂ 256⌉ gather/compare passes on the whole matrix.
        Edges are padded to a power of two with +inf so no probe needs a
        bounds check, and the first probe is a broadcast compare against
        the cached midpoint column.  Invariant: pos = #{i : edges[f, i] <= v}
        — exactly bisect-right; NaN sorts past every edge, matching
        `np.searchsorted`.
        """
        flat, off, mid, width = self._lut()
        m = self.edges.shape[1]
        xt = x.T  # (F, N)
        pos = np.where(mid <= xt, np.int64(width // 2), np.int64(0))
        b = width // 4
        while b:
            ev = flat[pos + (b - 1) + off]
            pos += np.where(ev <= xt, b, 0)
            b >>= 1
        np.minimum(pos, m, out=pos)
        pos[np.isnan(xt)] = m
        return np.ascontiguousarray(pos.astype(np.uint8).T)


# --------------------------------------------------------------------------
# forest container
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Forest:
    """Complete binary trees of fixed depth.

    feat[t, i] / thr[t, i]: internal node i of tree t splits on
    ``code[feat] <= thr`` (left) vs ``>`` (right).  leaf[t, j] are leaf
    values in level order.  Prediction = base + lr * Σ_t leaf_t(x).
    """

    depth: int
    learning_rate: float
    base: float
    feat: np.ndarray  # (T, 2**depth - 1) int32
    thr: np.ndarray  # (T, 2**depth - 1) int32 (bin code threshold)
    leaf: np.ndarray  # (T, 2**depth) float32
    binner: Binner

    @property
    def num_trees(self) -> int:
        return self.feat.shape[0]

    def predict_codes(self, codes: np.ndarray) -> np.ndarray:
        n = codes.shape[0]
        out = np.full(n, self.base, np.float64)
        for t in range(self.num_trees):
            idx = np.zeros(n, np.int64)
            for _ in range(self.depth):
                f = self.feat[t, idx]
                go_right = codes[np.arange(n), f] > self.thr[t, idx]
                idx = 2 * idx + 1 + go_right
            out += self.learning_rate * self.leaf[t, idx - (2**self.depth - 1)]
        return out

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_codes(self.binner.transform(x))


# --------------------------------------------------------------------------
# fitting — shared preamble
# --------------------------------------------------------------------------
def _sample_plan(rng, n, n_feat, num_trees, rowsample, colsample):
    """Per-tree (row, feature) subsets; one rng consumption order for both
    backends so a host fit and a device fit draw identical subsamples."""
    plan = []
    for _ in range(num_trees):
        if rowsample < 1.0:
            size = min(n, max(32, int(rowsample * n)))
            rows = np.sort(rng.choice(n, size=size, replace=False))
        else:
            rows = np.arange(n)
        if colsample < 1.0:
            fs = np.sort(rng.choice(n_feat, size=max(1, int(colsample * n_feat)), replace=False))
        else:
            fs = np.arange(n_feat)
        plan.append((rows, fs))
    return plan


def _route_all(codes, feats_t, thrs_t, depth):
    """Leaf index of every row under one tree (host, level loop)."""
    n = codes.shape[0]
    full = np.zeros(n, np.int64)
    base_id = 0
    for level in range(depth):
        ids = base_id + np.arange(2**level)
        gr = codes[np.arange(n), feats_t[ids][full]] > thrs_t[ids][full]
        full = 2 * full + gr
        base_id += 2**level
    return full


# --------------------------------------------------------------------------
# host backend (canonical f32 numpy)
# --------------------------------------------------------------------------
def _fit_host(codes, y, w, pred, plan, feats, thrs, leaves, *, depth, lr, lam, mcw):
    """Level-wise fit on numpy.  All reductions are f32 left folds in row
    order (`np.add.at`) and the gain DAG is pure f32 — the bit-parity
    reference the device backend is tested against."""
    num_trees = feats.shape[0]
    n_feat = codes.shape[1]
    for t in range(num_trees):
        rows, fs = plan[t]
        # full-sample trees read the matrix directly (fancy-index copies it)
        codes_t = codes if len(rows) == codes.shape[0] else codes[rows]
        nt = codes_t.shape[0]
        arangen = np.arange(nt)
        g = (w * (pred - y))[rows]  # f32; dL/dpred for 0.5*(pred-y)^2
        h = w[rows].copy()
        node = np.zeros(nt, np.int64)  # node index within current level
        node_base = 0  # first node id of current level in the tree arrays
        for level in range(depth):
            n_nodes = 2**level
            # gradient histograms: (nodes, F, B) — one f32 scatter pass per
            # level; features outside `fs` keep zero histograms (dead).
            flat_idx = (
                (node[:, None] * n_feat + fs[None, :]) * NUM_BINS + codes_t[:, fs]
            ).reshape(-1)
            size = n_nodes * n_feat * NUM_BINS
            G = np.zeros(size, np.float32)
            H = np.zeros(size, np.float32)
            np.add.at(G, flat_idx, np.repeat(g, fs.size))
            np.add.at(H, flat_idx, np.repeat(h, fs.size))
            G = G.reshape(n_nodes, n_feat, NUM_BINS)
            H = H.reshape(n_nodes, n_feat, NUM_BINS)
            GL = G.cumsum(axis=2)
            HL = H.cumsum(axis=2)
            Gt = GL[:, :, -1:]
            Ht = HL[:, :, -1:]
            GR, HR = Gt - GL, Ht - HL
            gain = GL * GL / (HL + lam) + GR * GR / (HR + lam) - Gt * Gt / (Ht + lam)
            ok = (HL >= mcw) & (HR >= mcw)
            gain = np.where(ok, gain, -np.inf)
            # exclude the last bin (right side empty by construction)
            gain[:, :, -1] = -np.inf
            flat = gain.reshape(n_nodes, -1)
            best = flat.argmax(axis=1)
            best_gain = flat[np.arange(n_nodes), best]
            bf = (best // NUM_BINS).astype(np.int32)
            bb = (best % NUM_BINS).astype(np.int32)
            # nodes with no valid split: freeze to always-left (thr = NUM_BINS)
            dead = ~np.isfinite(best_gain)
            bf[dead] = 0
            bb_store = np.where(dead, NUM_BINS, bb).astype(np.int32)
            ids = node_base + np.arange(n_nodes)
            feats[t, ids] = bf
            thrs[t, ids] = bb_store
            go_right = codes_t[arangen, bf[node]] > bb_store[node]
            node = 2 * node + go_right
            node_base += n_nodes
        # leaf values (from the subsample)
        Gs = np.zeros(2**depth, np.float32)
        Hs = np.zeros(2**depth, np.float32)
        np.add.at(Gs, node, g)
        np.add.at(Hs, node, h)
        lv = -Gs / (Hs + lam)
        leaves[t] = lv
        # route ALL rows for the prediction update; lr·leaf is rounded once
        # before the add (the FMA-free form the device backend also uses)
        scaled = np.float32(lr) * lv
        if len(rows) < codes.shape[0]:
            pred += scaled[_route_all(codes, feats[t], thrs[t], depth)]
        else:
            pred += scaled[node]


# --------------------------------------------------------------------------
# device backend (torch: kernel histograms + eager split search)
# --------------------------------------------------------------------------
def _tree_levels(codes_t, rows, fs, g, h, lam, mcw, *, depth, relaxed=False):
    """Level-wise split search + leaf values for one boosting tree.

    codes_t (F, Npad) int32 resident bin codes, feature-major; rows (ntp,)
    int64 sampled row ids (-1 = pad, dropped from every reduction); fs
    (fc,) int32 sampled feature ids; g/h (ntp,) f32 aligned with `rows`;
    lam/mcw 0-dim f32.  Every f32 step is one eager op, so each rounds as
    numpy's does.  ``relaxed`` takes the histograms' relaxed plain version
    on the CPU (`tree_hist`).  → (feats, thrs, leaf values, leaf index of
    every row).
    """
    n_feat, npad = codes_t.shape
    dev = codes_t.device
    nmax = 2 ** (depth - 1)
    n_int = 2**depth - 1
    valid = rows >= 0
    rix = torch.clamp_min(rows, 0)
    codes_sub = codes_t[fs.long()][:, rix]  # (fc, ntp): the kernel's column layout
    neg_inf = torch.tensor(-torch.inf, device=dev)
    node = torch.zeros(rows.shape[0], dtype=torch.int64, device=dev)
    feats = torch.zeros(n_int + 1, dtype=torch.int32, device=dev)  # +1 = dump slot
    thrs = torch.full((n_int + 1,), NUM_BINS, dtype=torch.int32, device=dev)
    slot = torch.arange(nmax, device=dev)
    for lvl in range(depth):
        node_m = torch.where(valid, node, -1).to(torch.int32)
        GH = tree_hist(codes_sub.T, fs, node_m, g, h, nmax, n_feat, NUM_BINS,
                       relaxed=relaxed)
        GHL = cumsum_seq(GH)  # (2, nmax, F, B) left-fold prefix sums
        GL, HL = GHL[0], GHL[1]
        Gt = GL[..., -1:]
        Ht = HL[..., -1:]
        GR, HR = Gt - GL, Ht - HL
        gain = GL * GL / (HL + lam) + GR * GR / (HR + lam) - Gt * Gt / (Ht + lam)
        ok = (HL >= mcw) & (HR >= mcw)
        gain = torch.where(ok, gain, neg_inf)
        gain[..., -1] = -torch.inf
        flat = gain.reshape(nmax, -1)
        best = torch.argmax(flat, dim=1)  # first maximum, as np.argmax
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        bf = torch.div(best, NUM_BINS, rounding_mode="floor").to(torch.int32)
        bb = (best % NUM_BINS).to(torch.int32)
        dead = ~torch.isfinite(best_gain)
        bf = torch.where(dead, 0, bf).to(torch.int32)
        bbs = torch.where(dead, NUM_BINS, bb).to(torch.int32)
        # this level occupies tree slots [2^l - 1, 2^{l+1} - 1); histogram
        # slots past the level's width are all-dead and go to the dump slot
        n_nodes = 1 << lvl
        write_ix = torch.where(slot < n_nodes, n_nodes - 1 + slot, n_int)
        feats[write_ix] = bf
        thrs[write_ix] = bbs
        code_at = codes_t[bf[node].long(), rix]
        node = 2 * node + (code_at > bbs[node]).to(torch.int64)

    # leaf sums: the same left fold, one column of one bin over 2^depth nodes
    leaf_node = torch.where(valid, node, -1).to(torch.int32)
    zero_col = torch.zeros((rows.shape[0], 1), dtype=torch.int32, device=dev)
    GHs = tree_hist(zero_col, torch.zeros(1, dtype=torch.int32, device=dev), leaf_node,
                    g, h, 2**depth, 1, 1, relaxed=relaxed)[:, :, 0, 0]
    lv = -GHs[0] / (GHs[1] + lam)

    full = torch.zeros(npad, dtype=torch.int64, device=dev)
    cols = torch.arange(npad, device=dev)
    for lvl in range(depth):
        idx = (1 << lvl) - 1 + full
        code_at = codes_t[feats[idx].long(), cols]
        full = 2 * full + (code_at > thrs[idx]).to(torch.int64)
    return feats[:n_int], thrs[:n_int], lv, full


def _plan_tensors(rows, fs, dev):
    """One tree's sampled rows, padded to their bucket with -1, and its
    sampled features, on ``dev``."""
    rows_p = np.full(_bucket(rows.shape[0]), -1, np.int64)
    rows_p[: rows.shape[0]] = rows
    return (torch.from_numpy(rows_p).to(dev),
            torch.from_numpy(fs.astype(np.int32)).to(dev))


def _fit_tree_resident(codes_t, rows, fs, y, w, pred, lam, mcw, lr, *, depth):
    """`parity_relaxation` tree: gradients AND the boosting update stay on
    the device.  ``pred + lr·leaf`` rounds on the device and the CPU
    histograms are tiled, so the fit is allclose to the host forest, NOT
    bitwise equal.  → (feats, thrs, leaf values, the updated pred)."""
    valid = rows >= 0
    rix = torch.clamp_min(rows, 0)
    gfull = w * (pred - y)
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    g = torch.where(valid, gfull[rix], zero)
    h = torch.where(valid, w[rix], zero)
    feats, thrs, lv, full = _tree_levels(codes_t, rows, fs, g, h, lam, mcw, depth=depth,
                                         relaxed=True)
    return feats, thrs, lv, pred + lr * lv[full]


def _fit_device(codes, y, w, pred, plan, feats, thrs, leaves, *, depth, lr, lam, mcw, device,
                parity_relaxation=False):
    n, n_feat = codes.shape
    npad = _bucket(n)
    dev = ExecOptions(device=str(device)).torch_device()
    codes_t = torch.from_numpy(
        np.ascontiguousarray(np.pad(codes.astype(np.int32), ((0, npad - n), (0, 0))).T)
    ).to(dev)
    lam_d = torch.tensor(lam, dtype=torch.float32, device=dev)
    mcw_d = torch.tensor(mcw, dtype=torch.float32, device=dev)
    lr32 = np.float32(lr)
    if parity_relaxation:
        # device-resident boosting: y/w/pred live on the device for the
        # whole forest and the trees are read back once, after the last
        def padded(a):
            return torch.from_numpy(np.pad(a.astype(np.float32), (0, npad - n))).to(dev)

        y_d, w_d, pred_d = padded(y), padded(w), padded(pred)
        lr_d = torch.tensor(lr32, device=dev)
        trees = []
        for rows, fs in plan:
            TRACES.note("fit_tree_res", npad, n_feat, _bucket(rows.shape[0]), fs.shape[0], depth)
            *tree, pred_d = _fit_tree_resident(codes_t, *_plan_tensors(rows, fs, dev), y_d, w_d,
                                               pred_d, lam_d, mcw_d, lr_d, depth=depth)
            trees.append(tree)
        if trees:
            feats[:], thrs[:], leaves[:] = (torch.stack(t).cpu().numpy() for t in zip(*trees))
        pred[:] = pred_d.cpu().numpy()[:n]
        return
    for t in range(feats.shape[0]):
        rows, fs = plan[t]
        nt = rows.shape[0]
        ntp = _bucket(nt)
        TRACES.note("fit_tree", npad, n_feat, ntp, fs.shape[0], depth)
        gfull = w * (pred - y)  # f32, identical elementwise to the host DAG
        gp = np.zeros(ntp, np.float32)
        gp[:nt] = gfull[rows]
        hp = np.zeros(ntp, np.float32)
        hp[:nt] = w[rows]
        feat_t, thr_t, lv, full = _tree_levels(
            codes_t,
            *_plan_tensors(rows, fs, dev),
            torch.from_numpy(gp).to(dev),
            torch.from_numpy(hp).to(dev),
            lam_d,
            mcw_d,
            depth=depth,
        )
        feats[t] = feat_t.cpu().numpy()
        thrs[t] = thr_t.cpu().numpy()
        lv = lv.cpu().numpy()
        leaves[t] = lv
        scaled = lr32 * lv
        pred += scaled[full.cpu().numpy()[:n]]


def fit_census(n: int, n_feat: int, depth: int, rowsample: float, colsample: float,
               parity_relaxation: bool = False) -> set:
    """Expected `TRACES` keys for one device fit: one shape key per
    (row bucket, features, subsample bucket, sampled features, depth);
    every tree of a fit shares it."""
    nt = n if rowsample >= 1.0 else min(n, max(32, int(rowsample * n)))
    fc = n_feat if colsample >= 1.0 else max(1, int(colsample * n_feat))
    kind = "fit_tree_res" if parity_relaxation else "fit_tree"
    return {(kind, _bucket(n), n_feat, _bucket(nt), fc, depth)}


# --------------------------------------------------------------------------
# public fit entry point
# --------------------------------------------------------------------------
def fit_gbdt(
    x: np.ndarray,
    y: np.ndarray,
    *,
    num_trees: int = 60,
    depth: int = 5,
    learning_rate: float = 0.3,
    lam: float = 1.0,
    min_child_weight: float = 4.0,
    sample_weight: np.ndarray | None = None,
    binner: Binner | None = None,
    seed: int = 0,
    colsample: float = 1.0,
    rowsample: float = 1.0,
    codes: np.ndarray | None = None,
    options: ExecOptions | None = None,
    parity_relaxation: bool = False,
) -> Forest:
    """Squared-error histogram GBDT (level-wise, fixed depth).

    ``options`` picks the backend (default: the device backend on CUDA);
    both backends export bit-identical forests for the same inputs (see
    the module docstring).  ``codes`` accepts the precomputed
    `binner.transform(x)` so callers fitting several forests on one matrix
    (the funnel's k models) bin it once instead of per fit.
    ``parity_relaxation`` (device backend only) keeps the boosting update
    on the device — allclose to the host forest, not bitwise (see the
    module docstring).
    """
    options = options if options is not None else ExecOptions()
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float32)
    n, n_feat = x.shape
    w = (
        np.ones(n, np.float32)
        if sample_weight is None
        else np.asarray(sample_weight, np.float32)
    )
    if codes is None:
        binner = binner or Binner.fit(x)
        codes = binner.transform(x)
    elif binner is None:
        raise ValueError("precomputed codes require the binner that made them")
    codes = np.asarray(codes, np.int64)  # (n, F)
    rng = np.random.default_rng(seed)
    plan = _sample_plan(rng, n, n_feat, num_trees, rowsample, colsample)

    base = float(np.average(y.astype(np.float64), weights=w.astype(np.float64)))
    pred = np.full(n, base, np.float32)
    n_internal = 2**depth - 1
    feats = np.zeros((num_trees, n_internal), np.int32)
    thrs = np.full((num_trees, n_internal), NUM_BINS, np.int32)  # always-left default
    leaves = np.zeros((num_trees, 2**depth), np.float32)

    kw = dict(
        depth=depth,
        lr=learning_rate,
        lam=np.float32(lam),
        mcw=np.float32(min_child_weight),
    )
    if options.backend == "device":
        _fit_device(codes, y, w, pred, plan, feats, thrs, leaves, device=options.device,
                    parity_relaxation=parity_relaxation, **kw)
    else:
        _fit_host(codes, y, w, pred, plan, feats, thrs, leaves, **kw)

    return Forest(depth, learning_rate, base, feats, thrs, leaves, binner)


def importance_gain(forest: Forest, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-feature total gain (paper Fig 5 'gain' metric, recomputed).

    We re-derive gain on the training data by walking each tree and
    accumulating the achieved impurity reduction at every internal node,
    attributed to the node's split feature.
    """
    codes = forest.binner.transform(np.asarray(x, np.float64)).astype(np.int64)
    y = np.asarray(y, np.float64)
    n, n_feat = codes.shape
    out = np.zeros(n_feat)
    pred = np.full(n, forest.base)
    lam = 1.0
    for t in range(forest.num_trees):
        g = pred - y
        h = np.ones(n)
        node = np.zeros(n, np.int64)
        node_base = 0
        for level in range(forest.depth):
            n_nodes = 2**level
            ids = node_base + np.arange(n_nodes)
            Gs = np.zeros(n_nodes)
            Hs = np.zeros(n_nodes)
            np.add.at(Gs, node, g)
            np.add.at(Hs, node, h)
            f = forest.feat[t, ids]
            thr = forest.thr[t, ids]
            go_right = codes[np.arange(n), f[node]] > thr[node]
            GL = np.zeros(n_nodes)
            HL = np.zeros(n_nodes)
            np.add.at(GL, node[~go_right], g[~go_right])
            np.add.at(HL, node[~go_right], h[~go_right])
            GR, HR = Gs - GL, Hs - HL
            gain = GL**2 / (HL + lam) + GR**2 / (HR + lam) - Gs**2 / (Hs + lam)
            live = thr < NUM_BINS
            np.add.at(out, f[live], np.maximum(gain[live], 0.0))
            node = 2 * node + go_right
            node_base += n_nodes
        idx = node
        lv = forest.leaf[t, idx]
        pred = pred + forest.learning_rate * lv
    return out
