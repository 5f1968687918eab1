"""Batched serving engine for the PS³ picker.

The single-query `PS3Picker.pick` path recomputes the normalized feature
matrix and the predicate selectivity per query.  `BatchPicker` is the
serving-facing API that amortizes what a batch shares:

  * **one vectorized feature pass** — `FeatureBuilder.features_batch`
    broadcasts the shared normalized base matrix against per-query column
    masks, so a batch of Q queries costs one O(N·dim) pass plus Q cheap
    mask products instead of Q full passes;
  * **bounded shape keys** — clustering runs through the pad-and-bucket
    masked paths in `core/clustering.py` (power-of-two shape buckets,
    dynamic n/k masking, the pdist_sq kernel on the card), so the set of
    launch shapes is bounded by the bucket count regardless of how many
    distinct candidate-set sizes traffic produces;
  * **answer reuse** — exact per-partition answers are memoized in a
    bounded LRU (`queries.engine.AnswerStore`) keyed by canonical query
    text, so repeated queries never rescan the table;
  * **append survival (streaming plane)** — when the served table grows
    through in-place partition appends (`append_partitions` /
    `concat_tables(into=)`), the answer LRU keeps every held entry and
    evaluates only the appended partitions on next access, and the
    underlying `EvalCache` writes the new partitions into its device
    stack's reserved slack — serving never pays an O(P) rebuild for an
    O(delta) append (`serve_stats` reports ``answers_carried`` /
    ``stack_appends``).

`serve_stats` snapshots throughput (picks/sec) and the shape census.
PyTorch runs eagerly, so nothing compiles: the port's trace registries
count runs per shape key, and what the reference counts as a compile is
here the first run of a key — ``compiles`` counts shape keys first seen
during a batch, ``shape_buckets``/``bucket_traces`` the clustering keys
and ``eval_compiles`` the query-eval launch keys first seen since the
BatchPicker was made.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

import numpy as np

from repro_torch.backends import ExecOptions
from repro_torch.core import clustering
from repro_torch.core.picker import PS3Picker, Selection
from repro_torch.queries import device as query_device
from repro_torch.queries.engine import AnswerStore, PartitionAnswers
from repro_torch.queries.ir import Query


@dataclasses.dataclass
class ServingStats:
    """Cumulative counters across every batch served by one BatchPicker."""

    picks: int = 0
    seconds: float = 0.0
    compiles: int = 0  # clustering shape keys first seen (the reference's traces)
    answer_hits: int = 0
    answer_misses: int = 0

    @property
    def picks_per_sec(self) -> float:
        return self.picks / self.seconds if self.seconds > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "picks": self.picks,
            "seconds": self.seconds,
            "picks_per_sec": self.picks_per_sec,
            "compiles": self.compiles,
            "answer_hits": self.answer_hits,
            "answer_misses": self.answer_misses,
        }


class BatchPicker:
    """Serves batches of queries against one trained `PS3Picker`.

    Thin, stateful, and cheap to construct: all heavy artifacts (sketches,
    funnel, cluster mask) live on the wrapped picker; this layer only adds
    the batched feature pass, the answer LRU, and telemetry.  ``options``
    default to the picker's own (the card, unless the picker was built
    for the CPU); a CUDA request without a card raises.

    Cache behavior under data growth: the answer LRU and its `EvalCache`
    self-synchronize against the served table's version — in-place
    partition appends keep cached answers for untouched partitions and
    cost one O(delta) stack write + delta evaluation (see `AnswerStore`);
    non-append mutations drop and rebuild.  The compile census stays flat
    across in-bucket appends, so long-running servers do not re-trace as
    their table grows.
    """

    def __init__(
        self,
        picker: PS3Picker,
        answer_capacity: int = 256,
        *,
        options: ExecOptions | None = None,
    ):
        options = options if options is not None else picker.options
        self.picker = picker
        self.options = options
        self.answers = AnswerStore(
            picker.table, capacity=answer_capacity, options=options
        )
        self.stats = ServingStats()
        # census baseline: report only buckets traced after this instance
        # was created, not process-wide history (e.g. training-time picks)
        self._bucket_base = dict(clustering.trace_counts())
        self._eval_base = dict(query_device.TRACES.counts())

    # ---- picking ----------------------------------------------------------
    def pick_batch(
        self, queries: Sequence[Query], budget: int, **pick_kw
    ) -> list[Selection]:
        """Per-query Selections for a batch, via one vectorized feature pass."""
        queries = list(queries)
        keys0 = set(clustering.trace_counts())
        t0 = time.perf_counter()
        feats, sels = self.picker.fb.features_batch(queries)
        out = [
            self.picker.pick(q, budget, feats=feats[i], sel=sels[i], **pick_kw)
            for i, q in enumerate(queries)
        ]
        self.stats.picks += len(queries)
        self.stats.seconds += time.perf_counter() - t0
        self.stats.compiles += len(set(clustering.trace_counts()) - keys0)
        return out

    # ---- answering --------------------------------------------------------
    def answer_batch(
        self, queries: Sequence[Query], budget: int, **pick_kw
    ) -> list[tuple[np.ndarray, Selection]]:
        """(estimate Ã_g, Selection) per query; exact answers are cached.

        Cache misses for the whole batch are evaluated in one stacked pass
        (`AnswerStore.get_batch`), so a cold batch is a handful of kernel
        launches instead of Q table rescans.
        """
        queries = list(queries)  # pick_batch would otherwise drain an iterator
        selections = self.pick_batch(queries, budget, **pick_kw)
        hits0, misses0 = self.answers.hits, self.answers.misses
        answers = self.answers.get_batch(queries)
        out = [
            (ans.estimate(sel.ids, sel.weights), sel)
            for ans, sel in zip(answers, selections)
        ]
        self.stats.answer_hits += self.answers.hits - hits0
        self.stats.answer_misses += self.answers.misses - misses0
        return out

    def cached_answers(self, query: Query) -> PartitionAnswers:
        """Exact per-partition answers for one query, through the LRU."""
        return self.answers.get(query)

    # ---- telemetry --------------------------------------------------------
    def serve_stats(self) -> dict:
        """Cumulative stats + the shape-key census since construction
        (keys first seen since then, with their runs)."""
        buckets = {
            key: count for key, count in clustering.trace_counts().items()
            if key not in self._bucket_base
        }
        eval_compiles = len(set(query_device.TRACES.counts()) - set(self._eval_base))
        plane = self.answers.plane
        return {
            **self.stats.as_dict(),
            "shape_buckets": len(buckets),
            "bucket_traces": {
                f"{kern}:n{nb}:k{kb}": c for (kern, nb, kb), c in buckets.items()
            },
            "eval_compiles": eval_compiles,  # new query-eval launch keys
            # partition plane the answer path evaluates on (1 = unsharded)
            "mesh_devices": plane.num_devices if plane is not None else 1,
            # streaming-append telemetry: answers kept across appends and
            # in-place device-stack slack writes vs full stack rebuilds
            "answers_carried": self.answers.carried,
            "answer_delta_evals": self.answers.delta_evals,
            "stack_appends": self.answers._eval_cache.stack_appends,
            "stack_rebuilds": self.answers._eval_cache.stack_rebuilds,
            # robustness plane: injected-read telemetry (None = fault-free)
            "fault_report": (
                None if self.answers.injector is None
                else self.answers.injector.report()
            ),
        }


def pick_stream(
    picker: PS3Picker,
    queries: Iterable[Query],
    budget: int,
    batch_size: int = 32,
    **pick_kw,
) -> Iterable[Selection]:
    """Convenience: chunk an unbounded query stream through a BatchPicker."""
    bp = BatchPicker(picker)
    chunk: list[Query] = []
    for q in queries:
        chunk.append(q)
        if len(chunk) >= batch_size:
            yield from bp.pick_batch(chunk, budget, **pick_kw)
            chunk = []
    if chunk:
        yield from bp.pick_batch(chunk, budget, **pick_kw)
