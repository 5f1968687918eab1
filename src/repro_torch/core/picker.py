"""The PS³ partition picker (paper §4, Algorithm 1) and its trainer.

Pipeline per query (Algorithm 1):
  1. selectivity filter  — candidates = partitions with sel_upper > 0
     (admissible: perfect recall, §3.2);
  2. OUTLIER(F, gb_col)  — rare group-by bitmap groups get weight 1,
     capped at `outlier_frac` of the budget (§4.4);
  3. IMPORTANCEGROUP     — the trained funnel sorts remaining candidates
     into k+1 groups (§4.3, Algorithm 2);
  4. ALLOCATESAMPLES     — per-group budget with rate decay α (§4.3);
  5. CLUSTERING          — KMeans per group; exemplar nearest the cluster
     median, weight = cluster size (§4.2).  Falls back to uniform
     selection inside the group when the predicate has more than
     `max_clauses_for_clustering` clauses (Appendix B.1 failure case).

Training (`train_picker`) — one-time per (dataset, layout, workload):
generate training queries, compute per-partition answers (truth labels) and
features, fit the funnel (Algorithm 4 labels), then greedy leave-one-out
feature selection for clustering (Algorithm 3).

KMeans runs on the device of the picker's ``options`` (the card by
default); the training labels and the GBDT fit follow ``options`` too.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
from torch.profiler import record_function

from repro_torch.backends import ExecOptions
from repro_torch.core import featsel
from repro_torch.core.clustering import kmeans_select, kmeans_select_unbiased
from repro_torch.core.features import FeatureBuilder
from repro_torch.core.funnel import (
    DEFAULT_ALPHA,
    DEFAULT_NUM_MODELS,
    ImportanceFunnel,
    allocate,
    train_funnel,
)
from repro_torch.core.outliers import DEFAULT_OUTLIER_FRAC, find_outliers
from repro_torch.data.table import Table
from repro_torch.queries.engine import (
    EvalCache,
    PartitionAnswers,
    per_partition_answers,
    per_partition_answers_batch,
)
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.queries.ir import Query


@dataclasses.dataclass
class PickerConfig:
    num_models: int = DEFAULT_NUM_MODELS
    alpha: float = DEFAULT_ALPHA
    outlier_frac: float = DEFAULT_OUTLIER_FRAC
    kmeans_iters: int = 25
    max_clauses_for_clustering: int = 10
    feature_selection: bool = True
    num_trees: int = 60
    tree_depth: int = 5
    seed: int = 0


@dataclasses.dataclass
class Selection:
    """Weighted partition choices S = {(p_j, w_j)} (paper §2.4)."""

    ids: np.ndarray
    weights: np.ndarray
    # diagnostics
    num_outliers: int = 0
    group_sizes: tuple[int, ...] = ()
    group_budgets: tuple[int, ...] = ()
    picker_ms: float = 0.0
    clustering_ms: float = 0.0


class PS3Picker:
    """Trained picker bound to one (table, layout, workload)."""

    def __init__(
        self,
        table: Table,
        features: FeatureBuilder,
        funnel: ImportanceFunnel,
        cluster_mask: np.ndarray,  # (dim,) 0/1 — Algorithm 3 output
        config: PickerConfig,
        *,
        options: ExecOptions | None = None,
    ):
        self.table = table
        self.fb = features
        self.funnel = funnel
        self.cluster_mask = cluster_mask
        self.config = config
        self.options = options if options is not None else ExecOptions()

    # ---- Algorithm 1 ------------------------------------------------------
    def pick(
        self,
        query: Query,
        budget: int,
        *,
        use_outliers: bool = True,
        use_funnel: bool = True,
        use_clustering: bool = True,
        unbiased: bool = False,
        seed: int = 0,
        feats: np.ndarray | None = None,
        sel: np.ndarray | None = None,
    ) -> Selection:
        """`feats`/`sel` accept precomputed feature/selectivity matrices (the
        batched serving path computes them once for a whole query batch)."""
        t_start = time.perf_counter()
        cfg = self.config
        if feats is None:
            feats = self.fb.features(query)
        if sel is None:
            sel = self.fb.selectivity(query)
        n = feats.shape[0]
        # tombstoned partitions never enter the candidate set: deleted
        # mass must not leak into estimates or stratum populations N_h
        candidates = np.flatnonzero((sel[:, 0] > 0) & self.table.live_mask())
        if candidates.size == 0:
            return Selection(np.empty(0, np.int64), np.empty(0))
        budget = int(min(budget, candidates.size))

        ids: list[np.ndarray] = []
        wts: list[np.ndarray] = []

        # ---- outliers (§4.4)
        outlier_ids = np.empty(0, np.int64)
        if use_outliers and query.groupby:
            gb_bits = self._gb_bitmaps(query, candidates)
            max_out = int(cfg.outlier_frac * budget)
            outlier_ids = find_outliers(candidates, gb_bits, max_out)
            if outlier_ids.size:
                ids.append(outlier_ids)
                wts.append(np.ones(outlier_ids.size))
        inliers = np.setdiff1d(candidates, outlier_ids, assume_unique=False)
        remaining = budget - outlier_ids.size

        # ---- importance groups (§4.3)
        if use_funnel:
            groups = self.funnel.classify(feats, inliers)
        else:
            groups = [inliers]
        budgets = allocate([g.size for g in groups], remaining, cfg.alpha)

        # ---- per-group selection (§4.2)
        cluster_feats = feats * self.cluster_mask[None, :]
        use_cluster = (
            use_clustering
            and query.predicate.num_clauses <= cfg.max_clauses_for_clustering
        )
        t_cluster = 0.0
        rng = np.random.default_rng(seed)
        device = self.options.device
        for g, b in zip(groups, budgets):
            if b <= 0 or g.size == 0:
                continue
            if b >= g.size:
                ids.append(g)
                wts.append(np.ones(g.size))
                continue
            if use_cluster:
                t0 = time.perf_counter()
                if unbiased:
                    loc, w = kmeans_select_unbiased(
                        cluster_feats[g], b, seed=seed, iters=cfg.kmeans_iters, device=device
                    )
                else:
                    loc, w = kmeans_select(
                        cluster_feats[g], b, iters=cfg.kmeans_iters, device=device
                    )
                t_cluster += time.perf_counter() - t0
                ids.append(g[loc])
                wts.append(w)
            else:  # Appendix B.1 fallback: uniform within the group
                loc = rng.choice(g.size, size=b, replace=False)
                ids.append(g[loc])
                wts.append(np.full(b, g.size / b))

        if not ids:
            return Selection(np.empty(0, np.int64), np.empty(0))
        out_ids = np.concatenate(ids)
        out_wts = np.concatenate(wts)
        return Selection(
            out_ids,
            out_wts,
            num_outliers=int(outlier_ids.size),
            group_sizes=tuple(int(g.size) for g in groups),
            group_budgets=tuple(int(b) for b in budgets),
            picker_ms=(time.perf_counter() - t_start) * 1e3,
            clustering_ms=t_cluster * 1e3,
        )

    # ---- helpers ------------------------------------------------------
    def _gb_bitmaps(self, query: Query, candidates: np.ndarray) -> np.ndarray:
        blocks = []
        for col in query.groupby:
            cs = self.fb.sk.columns.get(col)
            if cs is not None and cs.bitmap is not None:
                blocks.append(cs.bitmap[candidates])
        if not blocks:
            return np.zeros((candidates.size, 0))
        return np.concatenate(blocks, axis=1)

    def answer(
        self, query: Query, budget: int, answers: PartitionAnswers | None = None, **kw
    ):
        """Convenience: approximate answer Ã_g + the selection used."""
        sel = self.pick(query, budget, **kw)
        answers = answers or per_partition_answers(self.table, query, options=self.options)
        return answers.estimate(sel.ids, sel.weights), sel


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------
@dataclasses.dataclass
class TrainedArtifacts:
    picker: PS3Picker
    features: list[np.ndarray]
    contributions: list[np.ndarray]
    queries: list[Query]
    train_seconds: float


def build_training_data(
    table: Table,
    fb: FeatureBuilder,
    queries: list[Query],
    cache: EvalCache | None = None,
    *,
    options: ExecOptions | None = None,
) -> tuple[list[np.ndarray], list[np.ndarray], list[PartitionAnswers]]:
    """Truth labels + features for a training workload.

    Per-partition answers run through `per_partition_answers_batch` — one
    stacked device pass per shape bucket under the device backend — and
    the shared `EvalCache` keeps group codes and projection casts hot
    across the workload instead of rebuilding them per query.
    """
    options = options if options is not None else ExecOptions()
    cache = cache or EvalCache(table, options=options)
    with record_function("picker.labels"):
        answers = per_partition_answers_batch(table, queries, cache=cache, options=options)
    with record_function("picker.features"):
        feats = [fb.features(q) for q in queries]
    contribs = [a.contribution() for a in answers]
    return feats, contribs, answers


def train_picker(
    table: Table,
    workload: WorkloadSpec,
    num_train_queries: int = 100,
    config: PickerConfig | None = None,
    fb: FeatureBuilder | None = None,
    queries: list[Query] | None = None,
    *,
    options: ExecOptions | None = None,
) -> TrainedArtifacts:
    t0 = time.perf_counter()
    options = options if options is not None else ExecOptions()
    config = config or PickerConfig()
    if fb is None:
        from repro_torch.core.sketches import build_sketches

        fb = FeatureBuilder(table, build_sketches(table, options=options))
    queries = queries or workload.sample_workload(num_train_queries)
    feats, contribs, answers = build_training_data(table, fb, queries, options=options)
    funnel = train_funnel(
        feats,
        contribs,
        num_models=config.num_models,
        num_trees=config.num_trees,
        depth=config.tree_depth,
        seed=config.seed,
        options=options,
        parity_relaxation=options.parity_relaxation,
    )
    if config.feature_selection:
        with record_function("featsel"):
            mask = featsel.select_features(
                fb, feats, answers, seed=config.seed, device=options.device
            )
    else:
        mask = np.ones(fb.schema.dim)
    picker = PS3Picker(table, fb, funnel, mask, config, options=options)
    return TrainedArtifacts(
        picker, feats, contribs, queries, time.perf_counter() - t0
    )
