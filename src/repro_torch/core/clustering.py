"""Clustering-based sample selection (paper §4.2) — torch KMeans + numpy HAC.

KMeans runs on a torch device (``device=``, the card by default; a CUDA
request without CUDA raises).  Its assignment distances are the
x² − 2x·cᵀ + c² expansion, computed by the pdist_sq kernel
(`kernels/pdist.py`: the hand-written CUDA kernel on the card, its plain
version on the CPU).  Initialization is deterministic greedy
farthest-point (k-means++ without the randomness — the picker must be
reproducible per query, Appendix D's "deterministic answer" argument).

Every public entry point pads its inputs to **power-of-two shape
buckets** — rows to `bucket_size(n)`, cluster count to `bucket_size(k)` —
and masks padded rows / clusters out of every step (seeding, assignment,
center update, empty-cluster relocation, medians, exemplars), as the
reference does, so the kernels see O(log²) distinct shapes.  The padded
math is exact: masked rows contribute zero to every reduction, padded
rows score −1 in the seeding, centres ≥ k stay masked, and ties break to
the lowest index, so a padded run selects what an exact-shape run does.
`trace_counts()` counts runs per (entry point, row bucket, cluster
bucket).

Exemplar selection follows the paper: the member whose feature vector is
nearest the *median* feature vector of its cluster; weight = cluster
size.  The unbiased variant (random member, Appendix D) is kept for the
Fig-12 benchmark.  HAC (single / ward linkage) stays numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backends import ExecOptions
from repro_torch.kernels.ops import pdist_sq_op
from repro_torch.kernels.telemetry import TraceRegistry

_BIG = 1e30

MIN_BUCKET = 8
DEFAULT_DEVICE = "cuda"


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power of two ≥ max(n, minimum)."""
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# run accounting (shared registry pattern; see kernels/telemetry)
# --------------------------------------------------------------------------
TRACES = TraceRegistry("clustering")


def trace_counts() -> dict:
    """{(entry, row_bucket, cluster_bucket): runs} since the last reset."""
    return TRACES.counts()


def total_traces() -> int:
    """Runs over every key since the last reset."""
    return TRACES.total()


def reset_trace_counts() -> None:
    TRACES.reset()


def _resolve(device) -> torch.device:
    dev = ExecOptions(device=str(device)).torch_device()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the Lloyd product: IEEE f32
    return dev


# --------------------------------------------------------------------------
# KMeans (masked power-of-two bucket shapes)
# --------------------------------------------------------------------------
def _pairwise_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||² through the pdist_sq kernel."""
    return pdist_sq_op(a.contiguous(), b.contiguous())


def _padded(x, nb: int, dev: torch.device) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    return torch.nn.functional.pad(x, (0, 0, 0, nb - x.shape[0]))


def _fit_body(x, row_valid, center_valid, k: int, iters: int):
    """Masked farthest-point init + Lloyd on padded (nb, f) / (kb,) shapes.

    Padded rows (row_valid False) never seed, never join a cluster, and
    never attract a relocation; centers ≥ k stay at zero and are masked out
    of every assignment, so results are independent of the bucket sizes.
    """
    nb, f = x.shape
    kb = center_valid.shape[0]
    neg = torch.tensor(-1.0, device=x.device)
    big = torch.tensor(_BIG, device=x.device)

    # --- deterministic greedy farthest-point seeding (padding-invariant:
    # argmax ties break to the lowest index, and padded rows score -1 —
    # and keep it, since min(-1, d) = -1 for every distance d >= 0).
    # Steps i >= k change nothing in the reference's masked scan, so the
    # loop stops at k.
    norms = torch.where(row_valid, torch.sum(x * x, dim=1), neg)
    first = torch.argmax(norms)
    centers = torch.zeros((kb, f), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    mind = torch.where(row_valid, torch.sum((x - x[first]) ** 2, dim=1), neg)
    for i in range(1, min(k, kb)):
        c = x[torch.argmax(mind)]  # farthest valid point from current centers
        mind = torch.minimum(mind, torch.sum((x - c) ** 2, dim=1))
        centers[i] = c

    slots = torch.arange(kb, device=x.device)
    for _ in range(iters):
        d = torch.where(center_valid[None, :], _pairwise_sq(x, centers), big)  # (nb, kb)
        assign = torch.argmin(d, dim=1)
        onehot = (assign[:, None] == slots[None, :]).to(x.dtype) * row_valid[:, None]
        counts = onehot.sum(dim=0)  # (kb,)
        sums = onehot.T @ x  # (kb, f)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        # relocate empty (valid) clusters to the worst-fit points (one per
        # cluster, ranked by current distance-to-assigned-center)
        dmin = torch.where(row_valid, torch.min(d, dim=1).values, neg)
        order = torch.argsort(-dmin, stable=True)  # farthest valid points first
        empty = (counts == 0) & center_valid
        empty_rank = torch.cumsum(empty.to(torch.int64), dim=0) - 1  # rank among empties
        reloc = x[order[torch.clamp(empty_rank, 0, nb - 1)]]
        keep_mean = (counts > 0) | ~center_valid
        centers = torch.where(keep_mean[:, None], new, reloc)

    d = torch.where(center_valid[None, :], _pairwise_sq(x, centers), big)
    assign = torch.where(row_valid, torch.argmin(d, dim=1), -1)
    return centers, assign


def _medians_body(x, assign, kb: int) -> torch.Tensor:
    """(kb, f) per-cluster per-feature medians: the mean of the two middle
    members (the same member values the reference's masked sort picks).
    Rows with assign == -1 are members of no cluster; an empty cluster's
    median is _BIG, as in the reference."""
    nb, f = x.shape
    vals, order = torch.sort(x, dim=0, stable=True)  # per-feature value order
    # stable re-sort by cluster: members of cluster c become contiguous,
    # ascending in value; non-members (-1) come first
    key = assign[order]
    by_cluster = torch.argsort(key, dim=0, stable=True)
    s = torch.gather(vals, 0, by_cluster)
    counts = torch.bincount(assign[assign >= 0], minlength=kb)[:kb]
    start = (assign < 0).sum() + torch.cumsum(counts, 0) - counts
    lo = start + torch.clamp((counts - 1) // 2, min=0)
    hi = start + torch.clamp(counts // 2, min=0)
    lo = torch.clamp(lo, max=nb - 1)
    hi = torch.clamp(hi, max=nb - 1)
    med = 0.5 * (s[lo] + s[hi])  # (kb, f)
    return torch.where((counts > 0)[:, None], med, torch.tensor(_BIG, device=x.device))


def _exemplar_body(x, assign, center_valid):
    """Paper §4.2: exemplar = member nearest the cluster median."""
    kb = center_valid.shape[0]
    medians = _medians_body(x, assign, kb)
    d = _pairwise_sq(x, medians)  # (nb, kb)
    member = assign[:, None] == torch.arange(kb, device=x.device)[None, :]
    d = torch.where(member, d, torch.tensor(_BIG, device=x.device))
    ex = torch.argmin(d, dim=0)  # (kb,)
    counts = member.sum(dim=0)
    return ex, counts.to(torch.float32), (counts > 0) & center_valid


def _masks(n: int, nb: int, k: int, kb: int, dev):
    return torch.arange(nb, device=dev) < n, torch.arange(kb, device=dev) < k


# --------------------------------------------------------------------------
# public API (exact-shape in, exact-shape out)
# --------------------------------------------------------------------------
def kmeans_fit(x, k: int, iters: int = 25, seed: int = 0, *, device=DEFAULT_DEVICE):
    """Deterministic KMeans → (centers (k, f), assign (n,)) torch tensors on
    ``device``.  `seed` is kept for API compatibility — initialization is
    deterministic farthest-point, so it has no effect."""
    del seed
    dev = _resolve(device)
    n, k = np.asarray(x).shape[0], int(k)
    nb, kb = bucket_size(n), bucket_size(k)
    TRACES.note("kmeans_fit", nb, kb)
    row_valid, center_valid = _masks(n, nb, k, kb, dev)
    centers, assign = _fit_body(_padded(x, nb, dev), row_valid, center_valid, k, int(iters))
    return centers[:k], assign[:n]


def cluster_medians(x, assign, k: int, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Per-cluster per-feature median (k, f)."""
    dev = _resolve(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    a = torch.as_tensor(np.asarray(assign)).to(dev).long()
    return _medians_body(xt, a, int(k))


def select_exemplars(x, assign, k: int, *, device=DEFAULT_DEVICE):
    """(exemplar_ids (k,), weights (k,), valid (k,)) as numpy arrays —
    `valid` is False for empty clusters (possible when k > #distinct
    points)."""
    dev = _resolve(device)
    n, k = np.asarray(x).shape[0], int(k)
    nb, kb = bucket_size(n), bucket_size(k)
    TRACES.note("exemplars", nb, kb)
    a = torch.full((nb,), -1, dtype=torch.int64, device=dev)
    a[:n] = torch.as_tensor(np.asarray(assign, np.int64)).to(dev)
    _, center_valid = _masks(n, nb, k, kb, dev)
    ex, wts, valid = _exemplar_body(_padded(x, nb, dev), a, center_valid)
    return ex[:k].cpu().numpy(), wts[:k].cpu().numpy(), valid[:k].cpu().numpy()


def kmeans_select(features: np.ndarray, budget: int, iters: int = 25, *,
                  device=DEFAULT_DEVICE) -> tuple[np.ndarray, np.ndarray]:
    """End-to-end §4.2 selection: (partition_ids, weights) under `budget`."""
    n = features.shape[0]
    if budget >= n:
        return np.arange(n), np.ones(n)
    dev = _resolve(device)
    k = int(budget)
    nb, kb = bucket_size(n), bucket_size(k)
    TRACES.note("kmeans_select", nb, kb)
    row_valid, center_valid = _masks(n, nb, k, kb, dev)
    x = _padded(features, nb, dev)
    _, assign = _fit_body(x, row_valid, center_valid, k, int(iters))
    ex, wts, valid = _exemplar_body(x, assign, center_valid)
    ex, wts, valid = ex.cpu().numpy(), wts.cpu().numpy(), valid.cpu().numpy()
    return ex[valid], wts[valid]


def kmeans_select_unbiased(
    features: np.ndarray, budget: int, seed: int = 0, iters: int = 25, *,
    device=DEFAULT_DEVICE,
) -> tuple[np.ndarray, np.ndarray]:
    """Appendix D unbiased variant: exemplar drawn uniformly in the cluster."""
    n = features.shape[0]
    if budget >= n:
        return np.arange(n), np.ones(n)
    _, assign = kmeans_fit(features, int(budget), iters, device=device)
    assign = assign.cpu().numpy()
    rng = np.random.default_rng(seed)
    ids, wts = [], []
    for c in range(int(budget)):
        members = np.flatnonzero(assign == c)
        if members.size == 0:
            continue
        ids.append(int(rng.choice(members)))
        wts.append(float(members.size))
    return np.asarray(ids, np.int64), np.asarray(wts)


# --------------------------------------------------------------------------
# Hierarchical agglomerative clustering (numpy; Table 6 repro)
# --------------------------------------------------------------------------
def hac_fit(x: np.ndarray, k: int, linkage: str = "ward") -> np.ndarray:
    """Lance–Williams HAC; returns cluster assignment (n,) with k clusters."""
    n = x.shape[0]
    if k >= n:
        return np.arange(n)
    d = np.sqrt(np.maximum(_pairwise_sq_np(x), 0.0))
    if linkage == "ward":
        d = d**2  # ward works on squared distances
    np.fill_diagonal(d, np.inf)
    size = np.ones(n)
    active = np.ones(n, bool)
    parent = np.arange(n)
    for _ in range(n - k):
        flat = np.argmin(d)
        i, j = divmod(flat, n)
        if i > j:
            i, j = j, i
        # merge j into i (Lance–Williams)
        if linkage == "single":
            new = np.minimum(d[i], d[j])
        elif linkage == "ward":
            si, sj, sk = size[i], size[j], size
            new = ((si + sk) * d[i] + (sj + sk) * d[j] - sk * d[i, j]) / (si + sj + sk)
        else:
            raise ValueError(linkage)
        d[i, :] = new
        d[:, i] = new
        d[i, i] = np.inf
        d[j, :] = np.inf
        d[:, j] = np.inf
        size[i] += size[j]
        active[j] = False
        parent[parent == j] = i
    # relabel to 0..k-1
    labels = {p: idx for idx, p in enumerate(np.flatnonzero(active))}
    return np.asarray([labels[p] for p in parent])


def hac_select(
    features: np.ndarray, budget: int, linkage: str = "ward", *, device=DEFAULT_DEVICE
) -> tuple[np.ndarray, np.ndarray]:
    n = features.shape[0]
    if budget >= n:
        return np.arange(n), np.ones(n)
    assign = hac_fit(features, int(budget), linkage)
    ex, wts, valid = select_exemplars(features, assign, int(budget), device=device)
    return ex[valid], wts[valid]


def _pairwise_sq_np(x: np.ndarray) -> np.ndarray:
    aa = (x * x).sum(axis=1)
    return aa[:, None] + aa[None, :] - 2.0 * (x @ x.T)
