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
per query.  On a partition plane (``ExecOptions.mesh``) the device column
stack is held in shards, one a device, and the driver launches once per
shard; answers are bit-identical to the single-device path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import faults
from repro_torch.backends import ExecOptions
from repro_torch.core.clustering import bucket_size
from repro_torch.data.table import CATEGORICAL, NUMERIC, Table, events_foldable
from repro_torch.distributed import dataplane
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
def stack_partitions(num_partitions: int, plane=None) -> int:
    """Physical partition count of the device column stack: P padded to a
    power-of-two shape bucket (and, on a partition plane, to a plane
    multiple).

    The slack between P and the bucket is the streaming plane's headroom:
    appends write new partition columns into it without changing the
    stack's shape, so the driver's shape-bucket signatures stay the same
    until the bucket overflows and the stack is re-padded (and re-sharded)."""
    pb = bucket_size(num_partitions, minimum=1)
    return plane.padded(pb) if plane is not None else pb


class EvalCache:
    """Per-table cache of the intermediates shared across a workload.

    Group codes depend only on the group-by tuple, float casts only on the
    column, and projections only on the aggregate's term list — a training
    workload of 100 queries re-derives each a handful of times at most.
    The device driver reads the column stack (`device_stack`) and the
    non-finiteness flags that route queries from here.

    ``options.device`` is the torch device the column stack lives on
    (resolved at the first `device_stack` call, so a host-backend cache
    never needs the device).  ``plane`` (``options.plane()``, resolved at
    construction) is the partition plane of the device backend: the stack
    is then held in shards, (n_cols+1, local, R) on each of the plane's
    devices, and every consumer — the query driver, `AnswerStore`, the
    serving `BatchPicker` — runs partition-parallel without changing.

    **Invalidation semantics.**  Every accessor checks the table's data
    version first and folds the pending `Table.mutation_events`.  An
    append keeps the device column stack and *grows* it in place: the new
    partition columns are written into the stack's reserved bucket slack
    (one O(delta) transfer, `stack_partitions`), re-padding only when the
    bucket overflows.  A delete touches nothing (tombstoned rows still
    evaluate; the planner filters them).  A compaction or a rebalance
    rewrites the stack in its bucket (`_rewrite_stack`, counted in
    ``stack_rewrites``).  The cheap host-side caches (codes, casts,
    projections) are dropped and rebuilt lazily.  A chain that
    `data.table.events_foldable` refuses, or an unlogged bump, drops
    everything.  A table whose *contents* changed without a version bump
    (out-of-band mutation of a column array) is detected by a boundary
    fingerprint and raises — a clear error instead of silently stale
    answers.
    """

    def __init__(self, table: Table, *, options: ExecOptions | None = None):
        self.table = table
        self.options = options if options is not None else ExecOptions()
        self.plane = self.options.plane()
        self._version = table.version
        self._fp = table.fingerprint()
        self._fp_tick = 0
        self._codes: dict[tuple[str, ...], tuple[np.ndarray, int]] = {}
        self._f64: dict[str, np.ndarray] = {}
        self._f32: dict[str, np.ndarray] = {}
        self._proj: dict[tuple, np.ndarray] = {}
        self._posinf: dict[str, bool] = {}
        self._nonfinite: dict[str, bool] = {}
        # (n_cols+1, P_bucket, R) on the device, or its shards on the plane
        self._stack: torch.Tensor | dataplane.ShardedTensor | None = None
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
        self.stack_rewrites = 0  # in-bucket rewrites (compaction/rebalance)

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
        foldable = events is not None and events_foldable(events)
        if foldable and events and all(ev[0] == "append" for ev in events):
            # pure append chain: the PRE-append region must still match
            # our snapshot, or an out-of-band mutation hid behind the
            # append's version bump — the grown stack would serve stale
            # data for the mutated rows.  (Chains with lifecycle events
            # skip this check: a delete changes the fingerprint's
            # tombstone component by design, and the refreshed
            # fingerprint below re-arms the guard.)
            if self.table.fingerprint(events[0][1]) != self._fp:
                raise StaleStateError(
                    f"table {self.table.name!r}: pre-append partitions "
                    "changed outside the append API (out-of-band mutation "
                    "before append_partitions?); caches cannot update "
                    "incrementally from this snapshot"
                )
        self._codes.clear()
        self._f64.clear()
        self._f32.clear()
        self._proj.clear()
        if not foldable:
            self._posinf.clear()
            self._nonfinite.clear()
            self._stack = None
            self._stack_p = 0
        else:
            covered = None  # final-P coverage once an append fold ran
            for ev in events:
                if ev[0] == "delete":
                    # tombstones only: columns, flags and the stack stand
                    continue
                if ev[0] == "compact":
                    # survivors may lose the rows that made a column
                    # non-finite: the routing flags recompute lazily
                    self._posinf.clear()
                    self._nonfinite.clear()
                    self._rewrite_stack()
                elif ev[0] == "rebalance":
                    # flags are permutation-invariant; the stack is not
                    self._rewrite_stack()
                else:  # append
                    start = ev[1]
                    if covered is not None and start < covered:
                        continue  # an earlier fold already read past it
                    # the non-finiteness flags route queries between
                    # backends: extend them with a delta-only scan
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
                    covered = self.table.num_partitions
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

    def f32(self, col: str) -> np.ndarray:
        """The column as float32 (the column itself when it already is)."""
        with self._lock:
            self._sync_locked()
            hit = self._f32.get(col)
            if hit is None:
                data = self.table.columns[col]
                hit = self._f32[col] = (
                    data if data.dtype == np.float32 else data.astype(np.float32)
                )
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
        place (one host→device copy of the written region only, split
        across shards on a plane): `dataplane.write_partitions`."""
        self._stack = dataplane.write_partitions(self._stack, host, start, axis=1,
                                                 plane=self.plane)

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

    def _rewrite_stack(self) -> None:
        """Rewrite the device stack in place after a compaction or a
        rebalance: one write of the reorganized host columns through
        `_write_stack` (the path appends use), zero-filling the now-dead
        tail — the ones column included, so a padded slot never adds a
        count.  The stack keeps its shape bucket, so no launch key changes;
        only a table that grew past the bucket drops the stack for a re-pad
        on next access."""
        if self._stack is None:
            return
        n = self.table.num_partitions
        if n > self._stack.shape[1]:
            self._stack = None
            self._stack_p = 0
            return
        cover = max(self._stack_p, n)  # stale tail to zero out
        host = self._host_stack(0, n)
        if cover > n:
            pad = np.zeros((host.shape[0], cover - n, host.shape[2]), np.float32)
            host = np.concatenate([host, pad], axis=1)
        with record_function("lifecycle.stack_rewrite"):
            self._write_stack(host, 0)
        self._stack_p = n
        self.stack_rewrites += 1

    def device_stack(self) -> torch.Tensor | dataplane.ShardedTensor:
        """(n_cols+1, P_bucket, R) float32 column stack on ``options.device``.

        The trailing pseudo-column is all-ones: the count component and
        always-true padding clauses read it, so the device driver's only
        per-query inputs are small descriptors (indices / bounds /
        coefficients) — the table itself ships once per EvalCache.

        The partition axis is zero-padded to `stack_partitions` (the
        power-of-two shape bucket; on a plane also a plane multiple) and,
        on a partition plane, split into a `dataplane.ShardedTensor` of
        (n_cols+1, local, R) shards, one on each of the plane's devices.
        The zero slack beyond the table's real P — including the zeroed
        ones-column, so padded partitions can never contribute a count —
        is the streaming plane's append headroom: `_grow_stack` writes new
        partitions into it in place (across shard boundaries where the
        range crosses one), and the driver slices answers back to the
        real P.
        """
        with self._lock:
            self._sync_locked()
            self._check_fingerprint_locked()  # costliest thing to poison
            if self._stack is None:
                t = self.table
                device = self.options.torch_device()
                target = stack_partitions(t.num_partitions, self.plane)
                with record_function("eval.stack_upload"):
                    host = self._host_stack(0, t.num_partitions)
                    if self.plane is not None:
                        self._stack = self.plane.shard_partitions(host, axis=1, target=target)
                    else:
                        self._stack = torch.zeros(
                            (len(t.schema) + 1, target, t.rows_per_partition),
                            dtype=torch.float32, device=device,
                        )
                        self._write_stack(host, 0)
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

    **Appends.**  Per-partition answers are row-local: appending
    partitions cannot change an existing partition's contribution.  So
    when the table grows through pure partition appends
    (`data.table.append_partitions`), held answers survive: on next access
    only the appended partitions are evaluated (one stacked pass over a
    delta view of the table, counted in ``delta_evals``) and merged into
    each entry's (N, G, n_raw) raw tensor (``carried``), bit-identical to
    a cold evaluation of the grown table.

    **Lifecycle events.**  A delete leaves every entry valid (tombstoned
    rows are filtered at the planner).  A compaction or a rebalance
    gathers each full entry's raw tensor by the event's index map
    (`_fold_move`).  The store drops everything when the chain is one
    that `data.table.events_foldable` refuses or an unlogged bump, or
    when an append brings non-finite values on the device backend (they
    flip per-query host-fallback routing, which would mix fold orders).

    **Partial answers (planner escalation rounds).**  `get_subset`
    evaluates one query over an explicit partition-id subset and caches
    the result in a *separate* LRU keyed by ``(query_key,
    subset_fingerprint)`` — the full-answer cache is keyed by query text
    alone, so without the subset half of the key an escalation round's
    partial answer could be served where the full answer (or a larger
    round's) is expected.  Partial entries are row-local too: they
    survive appends and deletes (their partition ids stay valid) and drop
    on a compaction or a rebalance.

    ``ttl`` (seconds on ``clock``, default `time.monotonic`) bounds how long
    an entry may serve; an expired entry is re-evaluated on access and
    counted in ``ttl_expired``.

    ``plane`` is the partition plane its `EvalCache` resolved; the delta
    views and subset tables of the paths above evaluate on the same plane.
    """

    def __init__(self, table: Table, capacity: int = 256, *,
                 options: ExecOptions | None = None,
                 ttl: float | None = None, clock=None):
        self.table = table
        self.capacity = int(capacity)
        self.options = options if options is not None else ExecOptions()
        # fault-aware exact reads: a miss is a full-table scan, which has
        # no degraded mode — irrecoverable partition reads raise a typed
        # PartitionReadError instead (see `repro_torch.faults`)
        self.injector = faults.injector_for(self.options)
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
        self.carried = 0  # entries brought current across appends
        self.delta_evals = 0  # delta-partition evaluations after appends
        # delta view + EvalCache per pre-append P, shared across entries
        # (and across get() calls) so one append ships one delta stack
        self._delta_caches: dict[int, tuple[Table, EvalCache]] = {}

    @property
    def plane(self):
        """The partition plane the device backend evaluates on (or None)."""
        return self._eval_cache.plane

    def _pinned(self) -> ExecOptions:
        """The options with the plane the store resolved at construction:
        a delta view or a subset table must shard the way the main stack
        does, not whatever ``"auto"`` resolves to now."""
        return self.options.replace(mesh=self._eval_cache.plane)

    def _delta_backend_safe(self, start: int) -> bool:
        """Merging old answers with delta answers is only sound if the
        append cannot flip a query's device/host routing: on the device
        backend, non-finite values arriving in the delta change the
        `EvalCache.has_posinf`/`has_nonfinite` fallback decisions, and the
        two paths differ in f32 fold order."""
        if self.options.backend != "device":
            return True
        for spec in self.table.schema:
            if spec.kind != NUMERIC:
                continue
            delta = self.table.columns[spec.name][start:]
            if delta.size and not np.isfinite(delta).all():
                return False
        return True

    def _sync(self) -> None:
        # raises on out-of-band mutation (fingerprint, forced at this
        # batch boundary) and grows, rewrites or drops the device stack —
        # even on an all-hits batch that never touches the eval cache
        self._eval_cache._sync()
        self._eval_cache.check_fingerprint()
        if self.table.version == self._version:
            return
        events = self.table.mutation_events(self._version)
        foldable = events is not None and events_foldable(events) and all(
            self._delta_backend_safe(ev[1]) for ev in events if ev[0] == "append"
        )
        if not foldable:
            self._cache.clear()
            self._partial.clear()
            self._born.clear()
            self._partial_born.clear()
        else:
            for ev in events:
                # a delete leaves every raw row valid (tombstones filter at
                # the planner); an append merges lazily on access, where
                # each entry's raw partition count says where its delta
                # starts
                if ev[0] in ("compact", "rebalance"):
                    self._fold_move(ev)
        self._version = self.table.version
        self._delta_caches.clear()  # delta views are per-version snapshots

    def _fold_move(self, ev: tuple) -> None:
        """Fold a compaction or a rebalance into the held answers: each
        full entry's raw tensor is gathered by the event's index map, and a
        compaction also re-filters the occupied groups (a group whose only
        mass lived in dropped partitions disappears, as `_answers_from_raw`
        decides on the reorganized table).  Entries stale from an append
        across the move, and every partial answer, are dropped: their
        partition ids no longer name the same data."""
        idx = np.asarray(ev[1], dtype=np.int64)
        parts_before = ev[2]
        kept: dict[str, PartitionAnswers] = {}
        for key, ans in self._cache.items():
            if ans.raw.shape[0] != parts_before:
                continue
            raw = ans.raw[idx]
            if ev[0] == "compact":
                # integer counts in float64: the occupancy sum is exact
                occ = np.flatnonzero(raw[:, :, 0].sum(axis=0) > 0)
                kept[key] = PartitionAnswers(ans.query, ans.group_keys[occ], raw[:, occ, :],
                                             ans.plans)
            else:
                kept[key] = PartitionAnswers(ans.query, ans.group_keys, raw, ans.plans)
        for key in set(self._cache) - set(kept):
            self._born.pop(key, None)
        self._cache = kept
        self._partial.clear()
        self._partial_born.clear()

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

    def _delta_view(self, start: int) -> tuple[Table, EvalCache]:
        """The appended partitions [start, P) as a throwaway table (column
        slices are views, not copies) plus a memoized EvalCache for it.

        The cache's non-finiteness flags are seeded from the *full*
        table's: device/host routing must match what a cold evaluation of
        the grown table decides, or a column whose old partitions hold
        non-finite values would send the delta down the device path the
        cold evaluation avoids (another f32 fold order)."""
        hit = self._delta_caches.get(start)
        if hit is not None:
            return hit
        t = self.table
        cols = {k: v[start:] for k, v in t.columns.items()}
        view = Table(t.schema, cols, name=f"{t.name}/delta@{start}")
        cache = EvalCache(view, options=self._pinned())
        if self.options.backend == "device":
            # only the device driver reads these flags, so the host backend
            # skips the full-column scans the seeding would force
            for spec in t.schema:
                if spec.kind == NUMERIC:
                    cache._posinf[spec.name] = self._eval_cache.has_posinf(spec.name)
                    cache._nonfinite[spec.name] = self._eval_cache.has_nonfinite(spec.name)
        self._delta_caches[start] = (view, cache)
        return view, cache

    def _merge_delta(self, old: PartitionAnswers, delta: PartitionAnswers) -> PartitionAnswers:
        """An entry's pre-append answers merged with the delta partitions':
        the union of the occupied groups, the raw tensors stacked."""
        keys = np.union1d(old.group_keys, delta.group_keys)
        n_old, n_delta = old.raw.shape[0], delta.raw.shape[0]
        raw = np.zeros((n_old + n_delta, keys.shape[0], old.raw.shape[2]))
        raw[:n_old, np.searchsorted(keys, old.group_keys)] = old.raw
        raw[n_old:, np.searchsorted(keys, delta.group_keys)] = delta.raw
        return PartitionAnswers(old.query, keys, raw, old.plans)

    def _refresh(self, entries: list[tuple[str, PartitionAnswers]]) -> dict[str, PartitionAnswers]:
        """Bring append-stale entries up to the current partition count:
        one stacked delta evaluation per distinct pre-append P."""
        n = self.table.num_partitions
        out: dict[str, PartitionAnswers] = {}
        by_start: dict[int, list[tuple[str, PartitionAnswers]]] = {}
        for key, ans in entries:
            by_start.setdefault(ans.raw.shape[0], []).append((key, ans))
        with record_function("stream.answers"):
            for start, group in by_start.items():
                view, cache = self._delta_view(start)
                fresh = per_partition_answers_batch(
                    view, [ans.query for _, ans in group], cache=cache, options=self.options,
                )
                self.delta_evals += len(group)
                self.carried += len(group)
                for (key, ans), d in zip(group, fresh):
                    merged = self._merge_delta(ans, d)
                    assert merged.raw.shape[0] == n
                    out[key] = merged
        return out

    def get(self, query: Query) -> PartitionAnswers:
        with self._lock:
            self._sync()
            key = query_key(query)
            self._drop_expired(key)
            # non-destructive read: if the delta refresh below raises, the
            # stale-but-mergeable entry survives for the retry
            hit = self._cache.get(key)
            if hit is not None and hit.raw.shape[0] != self.table.num_partitions:
                hit = self._refresh([(key, hit)])[key]  # append-stale: merge
            if hit is not None:
                self.hits += 1
                self._cache.pop(key, None)
                self._cache[key] = hit  # re-insert = most recently used
                return hit
            self.misses += 1
            if self.injector is not None:
                self.injector.read_ids_strict(
                    np.arange(self.table.num_partitions), "AnswerStore.get"
                )
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
            if full is not None and full.raw.shape[0] == self.table.num_partitions:
                self.hits += 1
                ans = PartitionAnswers(query, full.group_keys, full.raw[ids], full.plans)
            else:
                self.misses += 1
                t = self.table
                with record_function("answers.subset_gather"):
                    cols = {k: v[ids] for k, v in t.columns.items()}
                    view = Table(t.schema, cols, name=f"{t.name}/subset")
                ans = per_partition_answers(
                    view, query, cache=EvalCache(view, options=self._pinned()),
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
        """Answers for a batch; all misses evaluated in one stacked pass
        (and, after an append, all append-stale hits brought current in
        one stacked delta pass)."""
        with self._lock:
            self._sync()
            n = self.table.num_partitions
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
            stale = [(k, a) for k, a in held.items() if a.raw.shape[0] != n]
            if stale:
                held.update(self._refresh(stale))
            fresh: dict[str, PartitionAnswers] = {}
            if missing:
                if self.injector is not None:
                    self.injector.read_ids_strict(
                        np.arange(n), "AnswerStore.get_batch"
                    )
                evaluated = per_partition_answers_batch(
                    self.table, list(missing.values()),
                    cache=self._eval_cache, options=self.options,
                )
                fresh = dict(zip(missing.keys(), evaluated))
            out: list[PartitionAnswers] = []
            for key in keys:
                hit = self._cache.pop(key, None)
                if key in held:
                    hit = held[key]  # the refreshed object, not the stale one
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
    ``cache``'s device and plane, so a ``cache`` built for another device
    than ``options.device`` is refused.  Answers are per-partition
    row-local, so a grown table's first ``P_old`` answer rows equal the
    pre-append ones, and they are bit-identical on every plane.  Pass a
    long-lived ``cache`` to amortize the device column stack and host
    intermediates across calls; it self-synchronizes against table
    appends (see `EvalCache`).
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
