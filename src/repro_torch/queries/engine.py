"""Columnar query evaluation over partitioned tables.

Produces, for a query Q, the per-partition answers A_{g,i} (paper §2.4) —
the quantity the whole system is built around: truth labels for picker
training, per-partition contributions, and the weighted estimator all read
from it.

Two execution backends with identical semantics (see `repro_torch.backends`):
  * ``backend="host"``   — vectorized numpy (bincount segment sums);
  * ``backend="device"`` — the kernel layer: `queries.device` runs the
    fused predicate + group-aggregate kernel behind a shape-bucketed
    driver, stacking whole query batches into one launch on the torch
    device of the options (CUDA kernels on a GPU, their plain PyTorch
    versions on the CPU).  Predicates outside the canonical interval
    form — non-finite columns under ``!=``, ``+inf`` under equality,
    oversized ``in``-lists — fall back to the host path with exact parity.

`EvalCache` carries the workload-invariant intermediates (group codes per
group-by tuple, per-column float casts, per-aggregate projections) so a
training workload or serving batch never recomputes them per query.
`AnswerStore` caches whole answers (and the planner's partial answers)
per query.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.backends import ExecOptions
from repro_torch.core.clustering import bucket_size
from repro_torch.data.table import CATEGORICAL, Table
from repro_torch.errors import InvalidQueryError, StaleStateError
from repro_torch.queries.ir import Aggregate, Predicate, Query

MAX_GROUPS = 4096  # generator guarantees radix product <= this


# --------------------------------------------------------------------------
# predicate evaluation
# --------------------------------------------------------------------------
def _clause_mask_np(table: Table, clause) -> np.ndarray:
    col = table.columns[clause.col]
    op, v = clause.op, clause.value
    if op == "<":
        return col < v
    if op == "<=":
        return col <= v
    if op == ">":
        return col > v
    if op == ">=":
        return col >= v
    if op == "==":
        return col == v
    if op == "!=":
        return col != v
    if op == "in":
        return np.isin(col, np.asarray(v))
    raise InvalidQueryError(f"unknown predicate operator {op!r}")


def predicate_mask(table: Table, predicate: Predicate) -> np.ndarray:
    """(parts, rows) bool mask of rows passing the predicate."""
    shape = (table.num_partitions, table.rows_per_partition)
    mask = np.ones(shape, dtype=bool)
    for group in predicate.groups:
        gmask = np.zeros(shape, dtype=bool)
        for clause in group.clauses:
            gmask |= _clause_mask_np(table, clause)
        mask &= gmask
    return mask


# --------------------------------------------------------------------------
# group codes
# --------------------------------------------------------------------------
def group_radix_checked(table: Table, groupby: tuple[str, ...]) -> int:
    """The combined group radix with `group_codes`'s validation, without
    materializing the (P, R) code arrays — the device path derives codes
    on the device."""
    radix = 1
    for name in groupby:
        spec = table.spec(name)
        if spec.kind != CATEGORICAL:
            raise InvalidQueryError(f"group-by on non-categorical column {name}")
        radix *= spec.cardinality
    if radix > MAX_GROUPS:
        raise InvalidQueryError(f"group radix {radix} exceeds MAX_GROUPS")
    return radix


def group_codes(table: Table, groupby: tuple[str, ...]) -> tuple[np.ndarray, int]:
    """Mixed-radix combined group code per row; returns (codes, radix)."""
    shape = (table.num_partitions, table.rows_per_partition)
    codes = np.zeros(shape, dtype=np.int64)
    radix = 1
    for name in groupby:
        spec = table.spec(name)
        if spec.kind != CATEGORICAL:
            raise InvalidQueryError(f"group-by on non-categorical column {name}")
        codes = codes * spec.cardinality + table.columns[name].astype(np.int64)
        radix *= spec.cardinality
    if radix > MAX_GROUPS:
        raise InvalidQueryError(f"group radix {radix} exceeds MAX_GROUPS")
    return codes, radix


# --------------------------------------------------------------------------
# aggregate raw components
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _AggPlan:
    """Each aggregate is finalized from raw segment sums.

    raw component 0 is always the passing-row count.
    """

    kind: str
    raw_index: int  # for sum/avg: index of the value-sum component


def plan_aggregates(aggregates: tuple[Aggregate, ...]):
    plans: list[_AggPlan] = []
    n_raw = 1  # component 0 = count
    for agg in aggregates:
        if agg.kind == "count":
            plans.append(_AggPlan("count", 0))
        else:
            plans.append(_AggPlan(agg.kind, n_raw))
            n_raw += 1
    return plans, n_raw


# --------------------------------------------------------------------------
# per-partition answers
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PartitionAnswers:
    """A_{g,i}: raw per-partition segment sums for the occupied groups."""

    query: Query
    group_keys: np.ndarray  # (G,) combined codes of occupied groups
    raw: np.ndarray  # (N, G, n_raw) float64; [..., 0] = passing-row count
    plans: list[_AggPlan]

    @property
    def num_partitions(self) -> int:
        return self.raw.shape[0]

    @property
    def num_groups(self) -> int:
        return self.raw.shape[1]

    @property
    def num_aggregates(self) -> int:
        return len(self.plans)

    def estimate(self, part_ids: np.ndarray, weights: np.ndarray) -> np.ndarray:
        """Weighted estimate Ã_g (G, n_aggs); NaN marks a missed group."""
        w = np.asarray(weights, np.float64)
        raw = np.tensordot(w, self.raw[np.asarray(part_ids)], axes=(0, 0))  # (G, n_raw)
        return self._finalize(raw)

    def truth(self) -> np.ndarray:
        return self._finalize(self.raw.sum(axis=0))

    def _finalize(self, raw: np.ndarray) -> np.ndarray:
        cnt = raw[:, 0]
        out = np.zeros((raw.shape[0], len(self.plans)), np.float64)
        for j, p in enumerate(self.plans):
            if p.kind == "count":
                out[:, j] = cnt
            elif p.kind == "sum":
                out[:, j] = raw[:, p.raw_index]
            else:  # avg
                with np.errstate(invalid="ignore", divide="ignore"):
                    out[:, j] = raw[:, p.raw_index] / cnt
        out[cnt <= 0] = np.nan  # group missed entirely
        return out

    def contribution(self) -> np.ndarray:
        """Paper §4.3: max over groups & aggregates of A_{g,i}[j] / A_g[j]."""
        total = self.raw.sum(axis=0)  # (G, n_raw)
        safe = np.where(np.abs(total) > 1e-12, total, np.inf)
        ratios = np.abs(self.raw) / np.abs(safe)  # (N, G, n_raw)
        return ratios.max(axis=(1, 2)) if ratios.size else np.zeros(self.raw.shape[0])


def query_key(query: Query) -> str:
    """Canonical cache key for a query (stable across equal IR values)."""
    return query.describe()


def subset_fingerprint(part_ids: np.ndarray) -> str:
    """Canonical fingerprint of an ordered partition-id subset.

    Partial (subset) answers are keyed by ``(query_key, this)`` — the
    planner's escalation rounds each read a different subset of the same
    query, and an answer for a smaller round must never be served as the
    answer for a larger one (or as the full-table answer)."""
    ids = np.ascontiguousarray(np.asarray(part_ids, dtype=np.int64))
    return hashlib.sha1(ids.tobytes()).hexdigest()


# --------------------------------------------------------------------------
# workload-invariant evaluation cache
# --------------------------------------------------------------------------
def stack_partitions(num_partitions: int) -> int:
    """Physical partition count of the device column stack: P padded to a
    power-of-two shape bucket.

    The slack between P and the bucket is the streaming plane's headroom:
    appends write new partition columns into it without changing the
    stack's shape, so the driver's shape-bucket signatures stay the same
    until the bucket overflows and the stack is re-padded."""
    return bucket_size(num_partitions, minimum=1)


class EvalCache:
    """Per-table cache of the intermediates shared across a workload.

    Group codes depend only on the group-by tuple, float casts only on the
    column, and projections only on the aggregate's term list — a training
    workload of 100 queries re-derives each a handful of times at most.
    The device driver reads the column stack (`device_stack`) and the
    non-finiteness flags that route queries from here.

    ``options.device`` is the torch device the column stack lives on
    (resolved at the first `device_stack` call, so a host-backend cache
    never needs the device).

    **Invalidation semantics.**  Every accessor checks the table's data
    version first.  A version bump whose chain is pure partition appends
    (`Table.append_range`) keeps the device column stack and *grows* it in
    place: the new partition columns are written into the stack's
    reserved bucket slack (one O(delta) transfer, `stack_partitions`),
    re-padding only when the bucket overflows; the cheap
    host-side caches (codes, casts, projections) are dropped and rebuilt
    lazily.  Any other version bump drops everything.  A table whose
    *contents* changed without a version bump (out-of-band mutation of a
    column array) is detected by a boundary fingerprint and raises — a
    clear error instead of silently stale answers.
    """

    def __init__(self, table: Table, *, options: ExecOptions | None = None):
        self.table = table
        self.options = options if options is not None else ExecOptions()
        self._version = table.version
        self._fp = table.fingerprint()
        self._fp_tick = 0
        self._codes: dict[tuple[str, ...], tuple[np.ndarray, int]] = {}
        self._f64: dict[str, np.ndarray] = {}
        self._proj: dict[tuple, np.ndarray] = {}
        self._posinf: dict[str, bool] = {}
        self._nonfinite: dict[str, bool] = {}
        self._stack: torch.Tensor | None = None  # (n_cols+1, P_bucket, R) on device
        self._stack_p = 0  # logical partitions currently written into it
        self.col_index = {s.name: i for i, s in enumerate(table.schema)}
        self.ones_index = len(table.schema)
        # readers on several threads may share one cache; every public
        # accessor holds this re-entrant lock so `_sync`'s clear-and-rebuild
        # and an in-flight read can never interleave
        self._lock = threading.RLock()
        self.codes_builds = 0
        self.cast_builds = 0
        self.stack_appends = 0  # in-place slack writes (streaming appends)
        self.stack_rebuilds = 0  # full stack (re)builds incl. overflows

    # the fingerprint guard costs ~1-2 µs/column, so hot accessors only
    # re-verify every Nth sync; public batch entries
    # (per_partition_answers_batch, device_stack) force a check, bounding
    # how long an out-of-band mutation can go unnoticed to one batch
    FP_CHECK_EVERY = 64

    def check_fingerprint(self) -> None:
        """Raise if the table's contents moved without a version bump
        (out-of-band mutation of a column array).  Safe to call anytime:
        a *declared* change (version bumped) is reconciled by `_sync`
        instead."""
        with self._lock:
            self._check_fingerprint_locked()

    def _check_fingerprint_locked(self) -> None:
        self._fp_tick = 0
        if self.table.version != self._version:
            return
        if self.table.fingerprint() != self._fp:
            raise StaleStateError(
                f"table {self.table.name!r} changed without a version "
                "bump (out-of-band mutation of a column array?); use "
                "append_partitions/concat_tables(into=) so caches can "
                "see the change instead of serving stale answers"
            )

    def _sync(self) -> None:
        """Reconcile with the table's data version: grow in place after a
        pure append chain, drop everything otherwise, raise on out-of-band
        mutation (data changed, version did not — checked every
        ``FP_CHECK_EVERY`` accessor calls and at every public batch
        entry via `check_fingerprint`)."""
        with self._lock:
            self._sync_locked()

    def _sync_locked(self) -> None:
        if self.table.version == self._version:
            self._fp_tick += 1
            if self._fp_tick >= self.FP_CHECK_EVERY:
                self._check_fingerprint_locked()
            return
        events = self.table.mutation_events(self._version)
        appends = bool(events) and all(ev[0] == "append" for ev in events)
        if appends:
            # pure append chain: the PRE-append region must still match
            # our snapshot, or an out-of-band mutation hid behind the
            # append's version bump — the grown stack would serve stale
            # data for the mutated rows
            if self.table.fingerprint(events[0][1]) != self._fp:
                raise StaleStateError(
                    f"table {self.table.name!r}: pre-append partitions "
                    "changed outside the append API (out-of-band mutation "
                    "before append_partitions?); caches cannot update "
                    "incrementally from this snapshot"
                )
        self._codes.clear()
        self._f64.clear()
        self._proj.clear()
        if not appends:
            # any other mutation (deletes, compaction, rebalancing, an
            # unlogged bump) drops everything: the in-place folds of
            # those events come with the lifecycle slice
            self._posinf.clear()
            self._nonfinite.clear()
            self._stack = None
            self._stack_p = 0
        else:
            start = events[0][1]  # partitions before the first append
            # the non-finiteness flags route queries between backends:
            # extend them with a delta-only scan
            for col in list(self._posinf):
                self._posinf[col] = self._posinf[col] or bool(
                    np.isposinf(self.table.columns[col][start:]).any()
                )
            for col in list(self._nonfinite):
                self._nonfinite[col] = self._nonfinite[col] or not bool(
                    np.isfinite(self.table.columns[col][start:]).all()
                )
            if self._stack is not None:
                self._grow_stack()
        self._version = self.table.version
        self._fp = self.table.fingerprint()
        self._fp_tick = 0

    def group_codes(self, groupby: tuple[str, ...]) -> tuple[np.ndarray, int]:
        with self._lock:
            self._sync_locked()
            hit = self._codes.get(groupby)
            if hit is None:
                self.codes_builds += 1
                hit = self._codes[groupby] = group_codes(self.table, groupby)
            return hit

    def f64(self, col: str) -> np.ndarray:
        with self._lock:
            self._sync_locked()
            hit = self._f64.get(col)
            if hit is None:
                self.cast_builds += 1
                hit = self._f64[col] = self.table.columns[col].astype(np.float64)
            return hit

    def has_posinf(self, col: str) -> bool:
        """+inf rows defeat the half-open interval form (`x < hi` can never
        admit x = inf), so clauses on such columns take the host path."""
        with self._lock:
            self._sync_locked()
            hit = self._posinf.get(col)
            if hit is None:
                hit = self._posinf[col] = bool(
                    np.isposinf(self.table.columns[col]).any()
                )
            return hit

    def has_nonfinite(self, col: str) -> bool:
        """inf/NaN rows defeat the device driver's projection einsums (they
        contract zero coefficients against every column, and 0·inf = NaN),
        so aggregates over such columns take the host path and the stack is
        sanitized for the contraction inputs (`queries.device`)."""
        with self._lock:
            self._sync_locked()
            hit = self._nonfinite.get(col)
            if hit is None:
                hit = self._nonfinite[col] = not bool(
                    np.isfinite(self.table.columns[col]).all()
                )
            return hit

    def _host_stack(self, lo: int, hi: int) -> np.ndarray:
        """(n_cols+1, hi-lo, R) host column stack incl. the ones column."""
        t = self.table
        rows = [
            np.ascontiguousarray(t.columns[s.name][lo:hi], dtype=np.float32)
            for s in t.schema
        ]
        rows.append(np.ones((hi - lo, t.rows_per_partition), np.float32))
        return np.stack(rows)

    def _write_stack(self, host: np.ndarray, start: int) -> None:
        """Write host partitions into the device stack at ``start``, in
        place (one host→device copy of the written region only)."""
        dst = self._stack[:, start : start + host.shape[1]]
        dst.copy_(torch.from_numpy(host))

    def _grow_stack(self) -> None:
        """Append partitions [stack_p, P) into the device stack's slack —
        the O(delta) transfer; overflowing the shape bucket drops the
        stack for a full re-pad on next access."""
        n = self.table.num_partitions
        start = self._stack_p
        if n == start:
            return  # empty append: nothing to write
        if n > self._stack.shape[1]:
            # bucket overflow: drop, and let the next device_stack() call
            # re-pad at the new bucket — counted there
            self._stack = None
            self._stack_p = 0
            return
        self._write_stack(self._host_stack(start, n), start)
        self._stack_p = n
        self.stack_appends += 1

    def device_stack(self) -> torch.Tensor:
        """(n_cols+1, P_bucket, R) float32 column stack on ``options.device``.

        The trailing pseudo-column is all-ones: the count component and
        always-true padding clauses read it, so the device driver's only
        per-query inputs are small descriptors (indices / bounds /
        coefficients) — the table itself ships once per EvalCache.

        The partition axis is zero-padded to `stack_partitions` (the
        power-of-two shape bucket).  The zero slack beyond the table's
        real P — including the zeroed ones-column, so padded partitions
        can never contribute a count — is the streaming plane's append
        headroom: `_grow_stack` writes new partitions into it in place,
        and the driver slices answers back to the real P.
        """
        with self._lock:
            self._sync_locked()
            self._check_fingerprint_locked()  # costliest thing to poison
            if self._stack is None:
                t = self.table
                device = self.options.torch_device()
                with record_function("eval.stack_upload"):
                    self._stack = torch.zeros(
                        (len(t.schema) + 1, stack_partitions(t.num_partitions),
                         t.rows_per_partition),
                        dtype=torch.float32, device=device,
                    )
                    self._write_stack(self._host_stack(0, t.num_partitions), 0)
                self.stack_rebuilds += 1
                self._stack_p = t.num_partitions
            return self._stack

    # distinct aggregate term tuples are unbounded across a serving
    # lifetime; each projection is a (P, R) float64 array, so the cache
    # is a small LRU rather than grow-forever like the cheap code caches
    PROJ_CAPACITY = 32

    def projection(self, agg: Aggregate) -> np.ndarray:
        with self._lock:
            self._sync_locked()
            if len(agg.terms) == 1 and agg.terms[0][0] == 1.0:
                return self.f64(agg.terms[0][1])  # identity projection: alias
            key = agg.terms
            hit = self._proj.pop(key, None)
            if hit is None:
                hit = np.zeros(
                    (self.table.num_partitions, self.table.rows_per_partition),
                    np.float64,
                )
                for coef, col in agg.terms:
                    hit += coef * self.f64(col)
            self._proj[key] = hit  # re-insert = most recently used
            while len(self._proj) > self.PROJ_CAPACITY:
                self._proj.pop(next(iter(self._proj)))
            return hit


class AnswerStore:
    """Bounded LRU cache of PartitionAnswers keyed by `query_key`.

    One exact per-partition evaluation per distinct query text — repeated
    queries (dashboards re-issuing the same panel) hit the cache instead
    of rescanning the table.  Misses in `get_batch` are evaluated together
    through `per_partition_answers_batch`, so a cold batch costs one
    stacked device pass, not Q rescans.

    **Mutations.**  Any table version bump drops every entry; the next
    access re-evaluates.  (The reference folds pure appends and partition
    moves into the held answers instead; its folds are bit-equal to a
    cold evaluation, so the answers are the same either way — only the
    hit/miss counters differ.  The folds come with the streaming slice.)

    **Partial answers (planner escalation rounds).**  `get_subset`
    evaluates one query over an explicit partition-id subset and caches
    the result in a *separate* LRU keyed by ``(query_key,
    subset_fingerprint)`` — the full-answer cache is keyed by query text
    alone, so without the subset half of the key an escalation round's
    partial answer could be served where the full answer (or a larger
    round's) is expected.

    ``ttl`` (seconds on ``clock``, default `time.monotonic`) bounds how long
    an entry may serve; an expired entry is re-evaluated on access and
    counted in ``ttl_expired``.
    """

    def __init__(self, table: Table, capacity: int = 256, *,
                 options: ExecOptions | None = None,
                 ttl: float | None = None, clock=None):
        self.table = table
        self.capacity = int(capacity)
        self.options = options if options is not None else ExecOptions()
        self._cache: dict[str, PartitionAnswers] = {}
        self._partial: dict[tuple[str, str], PartitionAnswers] = {}
        self._eval_cache = EvalCache(table, options=self.options)
        self._version = table.version
        self.ttl = None if ttl is None else float(ttl)
        if self.ttl is not None and self.ttl <= 0:
            raise ValueError(f"AnswerStore ttl must be positive, got {ttl}")
        self._clock = clock if clock is not None else time.monotonic
        self._born: dict[str, float] = {}
        self._partial_born: dict[tuple[str, str], float] = {}
        self.ttl_expired = 0
        # concurrent readers may share a store; the re-entrant lock
        # serializes every mutation path (LRU re-insert, invalidation)
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def _sync(self) -> None:
        # raises on out-of-band mutation (fingerprint, forced at this
        # batch boundary) and keeps the device stack current
        self._eval_cache._sync()
        self._eval_cache.check_fingerprint()
        if self.table.version == self._version:
            return
        self._cache.clear()
        self._partial.clear()
        self._born.clear()
        self._partial_born.clear()
        self._version = self.table.version

    def _expired(self, born: float | None) -> bool:
        if self.ttl is None or born is None:
            return False
        return (self._clock() - born) > self.ttl

    def _drop_expired(self, key: str) -> bool:
        """Evict ``key`` from the full cache if past max-age; True if so."""
        if self._expired(self._born.get(key)):
            self._cache.pop(key, None)
            self._born.pop(key, None)
            self.ttl_expired += 1
            return True
        return False

    def get(self, query: Query) -> PartitionAnswers:
        with self._lock:
            self._sync()
            key = query_key(query)
            self._drop_expired(key)
            hit = self._cache.pop(key, None)
            if hit is not None:
                self.hits += 1
                self._cache[key] = hit  # re-insert = most recently used
                return hit
            self.misses += 1
            ans = per_partition_answers(
                self.table, query, cache=self._eval_cache, options=self.options
            )
            self._insert(key, ans)
            return ans

    def get_subset(self, query: Query, part_ids: np.ndarray) -> PartitionAnswers:
        """Exact answers for one query restricted to ``part_ids`` (raw rows
        in that order) — the planner's escalation-round read path.

        Cached under ``(query_key, subset_fingerprint)`` in a partial-answer
        LRU that is disjoint from the full-answer cache by construction.
        When the full answer happens to be held, the subset is sliced from
        it for free; otherwise the subset's partitions are gathered into a
        table of their own and evaluated.
        """
        with self._lock:
            self._sync()
            ids = np.asarray(part_ids, dtype=np.int64)
            key = (query_key(query), subset_fingerprint(ids))
            if self._expired(self._partial_born.get(key)):
                self._partial.pop(key, None)
                self._partial_born.pop(key, None)
                self.ttl_expired += 1
            hit = self._partial.pop(key, None)
            if hit is not None:
                self.hits += 1
                self._partial[key] = hit  # re-insert = most recently used
                return hit
            self._drop_expired(key[0])
            full = self._cache.get(key[0])
            if full is not None:
                self.hits += 1
                ans = PartitionAnswers(query, full.group_keys, full.raw[ids], full.plans)
            else:
                self.misses += 1
                t = self.table
                with record_function("answers.subset_gather"):
                    cols = {k: v[ids] for k, v in t.columns.items()}
                    view = Table(t.schema, cols, name=f"{t.name}/subset")
                ans = per_partition_answers(
                    view, query, cache=EvalCache(view, options=self.options),
                    options=self.options,
                )
            self._partial[key] = ans
            self._partial_born[key] = self._clock()
            while len(self._partial) > self.capacity:
                old = next(iter(self._partial))
                self._partial.pop(old)
                self._partial_born.pop(old, None)
            return ans

    def get_batch(self, queries: list[Query]) -> list[PartitionAnswers]:
        """Answers for a batch; all misses evaluated in one stacked pass."""
        with self._lock:
            self._sync()
            keys = [query_key(q) for q in queries]
            # snapshot every held answer up front: the re-insertions below
            # may evict an entry before its position in the batch is reached
            held: dict[str, PartitionAnswers] = {}
            missing: dict[str, Query] = {}
            for q, key in zip(queries, keys):
                if key in held or key in missing:
                    continue
                self._drop_expired(key)
                hit = self._cache.get(key)
                if hit is not None:
                    held[key] = hit
                else:
                    missing[key] = q
            fresh: dict[str, PartitionAnswers] = {}
            if missing:
                evaluated = per_partition_answers_batch(
                    self.table, list(missing.values()),
                    cache=self._eval_cache, options=self.options,
                )
                fresh = dict(zip(missing.keys(), evaluated))
            out: list[PartitionAnswers] = []
            for key in keys:
                hit = self._cache.pop(key, None)
                if key in held:
                    hit = held[key]
                if hit is not None:
                    self.hits += 1
                else:
                    self.misses += 1
                    hit = fresh[key]
                self._insert(key, hit)
                out.append(hit)
            return out

    def _insert(self, key: str, ans: PartitionAnswers) -> None:
        self._cache[key] = ans
        self._born.setdefault(key, self._clock())
        while len(self._cache) > self.capacity:
            old = next(iter(self._cache))
            self._cache.pop(old)
            self._born.pop(old, None)

    def __len__(self) -> int:
        return len(self._cache)


def _answers_from_raw(
    query: Query, raw: np.ndarray, plans: list[_AggPlan]
) -> PartitionAnswers:
    """(N, radix, n_raw) dense raw sums → occupied-group PartitionAnswers."""
    occupied = np.flatnonzero(raw[:, :, 0].sum(axis=0) > 0)
    return PartitionAnswers(query, occupied, raw[:, occupied, :], plans)


def _host_answers(table: Table, query: Query, cache: EvalCache) -> PartitionAnswers:
    mask = predicate_mask(table, query.predicate)
    codes, radix = cache.group_codes(query.groupby)
    n, r = mask.shape
    plans, n_raw = plan_aggregates(query.aggregates)

    seg = (codes + np.arange(n, dtype=np.int64)[:, None] * radix).reshape(-1)
    m = mask.reshape(-1)
    raw = np.zeros((n * radix, n_raw), np.float64)
    raw[:, 0] = np.bincount(seg, weights=m.astype(np.float64), minlength=n * radix)
    k = 1
    for agg in query.aggregates:
        if agg.kind == "count":
            continue
        vals = (cache.projection(agg).reshape(-1)) * m
        raw[:, k] = np.bincount(seg, weights=vals, minlength=n * radix)
        k += 1
    raw = raw.reshape(n, radix, n_raw)
    return _answers_from_raw(query, raw, plans)


def per_partition_answers(
    table: Table,
    query: Query,
    cache: EvalCache | None = None,
    *,
    options: ExecOptions | None = None,
) -> PartitionAnswers:
    """Exact A_{g,i} for one query; ``options`` selects host numpy or the
    kernel-layer device path (default: the device backend on CUDA)."""
    return per_partition_answers_batch(table, [query], cache=cache, options=options)[0]


def per_partition_answers_batch(
    table: Table,
    queries: list[Query],
    cache: EvalCache | None = None,
    *,
    options: ExecOptions | None = None,
) -> list[PartitionAnswers]:
    """A_{g,i} for a whole workload — the offline hot path.

    The device backend groups queries by shape-bucket signature and stacks
    each group along the partition axis so a training workload is a
    handful of kernel launches; the host backend shares the `EvalCache`
    intermediates across the loop.  The device backend runs on the
    ``cache``'s device, so a ``cache`` built for another device than
    ``options.device`` is refused.  Answers are per-partition row-local,
    so a grown table's first ``P_old`` answer rows equal the pre-append
    ones.  Pass a long-lived ``cache`` to amortize the device column stack
    and host intermediates across calls; it self-synchronizes against
    table appends (see `EvalCache`).
    """
    options = options if options is not None else ExecOptions()
    cache = cache or EvalCache(table, options=options)
    cache.check_fingerprint()  # batch boundary: force the mutation guard
    if options.backend == "device":
        if torch.device(cache.options.device) != torch.device(options.device):
            raise ValueError(
                f"EvalCache holds its stack on {cache.options.device!r}, "
                f"options ask for {options.device!r}"
            )
        from repro_torch.queries import device

        return device.eval_workload(table, queries, cache=cache)
    return [_host_answers(table, q, cache) for q in queries]


# --------------------------------------------------------------------------
# error metrics (§5.1.4)
# --------------------------------------------------------------------------
def error_metrics(truth: np.ndarray, estimate: np.ndarray) -> dict[str, float]:
    """truth/estimate: (G, n_aggs) with NaN in estimate = missed group."""
    if truth.size == 0:
        return {"missed_groups": 0.0, "avg_rel_err": 0.0, "abs_over_true": 0.0}
    missed = np.isnan(estimate[:, 0])
    rel = np.ones_like(truth)
    present = ~missed
    t, e = truth[present], estimate[present]
    with np.errstate(invalid="ignore", divide="ignore"):
        r = np.abs(e - t) / np.abs(t)
    r = np.where(np.abs(t) < 1e-12, np.where(np.abs(e - t) < 1e-9, 0.0, 1.0), r)
    rel[present] = np.minimum(np.nan_to_num(r, nan=1.0), 1.0)
    abs_err = np.zeros_like(truth)
    abs_err[present] = np.abs(e - t)
    abs_err[missed] = np.abs(truth[missed])
    denom = np.abs(truth).mean(axis=0)
    denom = np.where(denom < 1e-12, 1.0, denom)
    return {
        "missed_groups": float(missed.mean()),
        "avg_rel_err": float(rel.mean()),
        "abs_over_true": float((abs_err.mean(axis=0) / denom).mean()),
    }
