"""Unified public API: `QuerySpec` + `ExecOptions` + `Session`.

One entry point replaces the constellation of kwargs threaded through
`build_sketches` / `per_partition_answers_batch` / `train_picker` /
`BatchPicker`:

    import repro_torch.api as ps3

    sess = ps3.Session(table)                    # device backend on the card
    sess.prepare(workload)                       # sketches + picker
    sess.register_view(("brand",), query.aggregates)   # optional hot view
    ans = sess.execute(ps3.QuerySpec(query, error_bound=0.05))
    ans.estimate, ans.ci_halfwidth, ans.partitions_read, ans.plan

`QuerySpec` carries the query IR plus exactly one budgeting contract:
``error_bound=`` (relative error the answer must meet — the planner
escalates partition reads until its confidence interval satisfies it),
``latency_bound=`` (seconds; converted to a partition budget through a
per-(backend, chunk) EMA of the session's observed read rate), or
``budget=`` (the classic fixed partition count).

`Session` owns the whole lifecycle — `Table` + `SketchStore` +
`AnswerStore` + `ViewStore` + trained picker + `QueryPlanner` — and
keeps every piece consistent across table mutations: partition appends
(`data.table.append_partitions`) and the lifecycle ops
(`delete_partitions`, `compact`, `rebalance`; `repro_torch.lifecycle`)
fold into the sketches, the device column stack, cached answers and
views, bit-identical to a cold rebuild on the same table; an unlogged
version bump rebuilds them.  The kernel passes and delta evaluations of
an append fold read only the new partitions, but each cached answer's
merge copies its (P, groups) raw tensor and the categorical heavy
hitters are recomputed over (P, cardinality) counts, so a fold still
grows with the table.  `save` / `restore` snapshot the table and its
derived state; with `repro_torch.wal.WriteAheadLog` and `wal.recover` a
crash at any point recovers bit-identically.

Robustness and serving: ``ExecOptions(faults=FaultPolicy(...))`` runs
every partition read through a seeded injector (degraded answers report
``plan.partitions_failed``; exact reads raise `PartitionReadError`), and
`repro_torch.serving.FrontDoor` admits concurrent multi-tenant requests
in front of one or more prepared Sessions (a `VirtualClock` makes it
deterministic).  On the CPU, pass ``ExecOptions(device="cpu")`` (or
``backend="host"``); the default runs on the card or raises.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch import lifecycle, wal
from repro_torch.backends import ExecOptions
from repro_torch.core.features import FeatureBuilder
from repro_torch.errors import (  # noqa: F401  (re-export)
    BudgetExhaustedError,
    DeadlineExceededError,
    InjectedCrash,
    InvalidQueryError,
    OverloadError,
    PartitionReadError,
    ReproError,
    SessionStateError,
    StaleStateError,
    WalCorruptError,
)
from repro_torch.faults import FaultPolicy, VirtualClock  # noqa: F401  (re-export)
from repro_torch.core.picker import PickerConfig, train_picker
from repro_torch.core.sketches import SketchStore
from repro_torch.data.table import Table
from repro_torch.planner import PlannedAnswer, PlannerConfig, QueryPlanner, ViewStore
from repro_torch.queries.engine import AnswerStore
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.queries.ir import Aggregate, Clause, Predicate, Query  # noqa: F401

__all__ = [
    "Aggregate",
    "BudgetExhaustedError",
    "Clause",
    "DeadlineExceededError",
    "ExecOptions",
    "FaultPolicy",
    "InjectedCrash",
    "InvalidQueryError",
    "OverloadError",
    "PartitionReadError",
    "Predicate",
    "Query",
    "QuerySpec",
    "ReproError",
    "Session",
    "SessionStateError",
    "StaleStateError",
    "VirtualClock",
    "WalCorruptError",
]


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """A query plus exactly one budgeting contract."""

    query: Query
    error_bound: float | None = None  # relative error the answer must meet
    latency_bound: float | None = None  # seconds (→ budget via read-rate EMA)
    budget: int | None = None  # fixed partition count (legacy contract)
    strict: bool = False  # raise (BudgetExhaustedError / PartitionReadError)
    # instead of returning a degraded answer

    def __post_init__(self):
        given = [
            k
            for k in ("error_bound", "latency_bound", "budget")
            if getattr(self, k) is not None
        ]
        if len(given) != 1:
            raise InvalidQueryError(
                "QuerySpec needs exactly one of error_bound= / latency_bound= "
                f"/ budget=, got {given or 'none'}"
            )
        if self.error_bound is not None and not 0 < self.error_bound <= 1:
            raise InvalidQueryError(
                f"error_bound must be in (0, 1], got {self.error_bound}"
            )
        if self.latency_bound is not None and self.latency_bound <= 0:
            raise InvalidQueryError(
                f"latency_bound must be positive, got {self.latency_bound}"
            )
        if self.budget is not None and self.budget < 1:
            raise InvalidQueryError(f"budget must be >= 1, got {self.budget}")


class Session:
    """Facade owning the full PS³ lifecycle for one table.

    Construction builds the table's sketches (`SketchStore`); `prepare()`
    trains the picker.  `execute()` answers `QuerySpec`s through the
    error-bounded planner; everything stays consistent across
    `Table` mutations (version-checked sketches, caches and views).
    """

    # bound on the per-(backend, chunk) read-rate EMA map: mixed traffic
    # that sweeps options/planner_config would otherwise grow it without
    # limit in a long-lived serve process (LRU: oldest key evicted)
    MAX_RATE_KEYS = 16

    def __init__(
        self,
        table: Table,
        *,
        options: ExecOptions | None = None,
        planner_config: PlannerConfig | None = None,
        answer_capacity: int = 256,
        answer_ttl: float | None = None,
        clock=None,
    ):
        self.table = table
        self.options = options if options is not None else ExecOptions()
        self.sketches = SketchStore(table, options=self.options)
        # answer_ttl (seconds on `clock`, default time.monotonic) bounds
        # how long cached answers may serve before being recomputed — a
        # long-lived serve process must not pin stale-but-valid answers
        # forever.  Expiries are counted in stats()["answer_ttl_expired"].
        self.answers = AnswerStore(
            table, capacity=answer_capacity, options=self.options,
            ttl=answer_ttl, clock=clock,
        )
        self.views = ViewStore(table, options=self.options)
        self.planner_config = planner_config or PlannerConfig()
        self.picker = None
        self.planner: QueryPlanner | None = None
        self._fb_version = -1
        # partitions/sec EMAs for latency_bound → budget conversion, keyed
        # by (resolved backend, planner chunk): warm device throughput and
        # host throughput differ by >2x, and the chunk size changes the
        # per-read amortization, so one session-wide EMA would thrash when
        # options/planner_config vary across executes.  Each key starts
        # absent: the first latency-bounded query under it measures the rate
        self._rates: dict[tuple[str, int], float] = {}
        self._executed = 0
        self._degraded = 0  # answers returned with plan.degraded
        self._partitions_failed = 0  # failed reads surfaced in answers

    # ---- one-time preparation ---------------------------------------------
    def prepare(
        self,
        workload: WorkloadSpec | None = None,
        num_train_queries: int = 48,
        picker_config: PickerConfig | None = None,
    ) -> "Session":
        """Train the picker (one-time per table/layout/workload)."""
        workload = workload or WorkloadSpec(self.table)
        fb = FeatureBuilder(self.table, self.sketches.sketches())
        art = train_picker(
            self.table,
            workload,
            num_train_queries=num_train_queries,
            config=picker_config,
            fb=fb,
            options=self.options,
        )
        self.picker = art.picker
        self.planner = QueryPlanner(
            self.picker, self.answers, views=self.views, config=self.planner_config
        )
        self._fb_version = self.table.version
        return self

    def register_view(
        self, groupby: tuple[str, ...], aggregates: tuple[Aggregate, ...]
    ):
        """Materialize exact totals for a hot group-by (hybrid mode)."""
        return self.views.register(groupby, aggregates)

    # ---- execution --------------------------------------------------------
    def _require_planner(self) -> QueryPlanner:
        if self.planner is None:
            raise SessionStateError("Session.prepare() must run before execute()")
        if self.table.version != self._fb_version:
            # table grew: refresh features from the (incrementally
            # folded) sketches so selectivity/outliers see new partitions
            fb = FeatureBuilder(self.table, self.sketches.sketches())
            self.picker.fb = fb
            self.planner.fb = fb
            self._fb_version = self.table.version
        return self.planner

    def _rate_key(self) -> tuple[str, int]:
        return (self.options.backend, self.planner_config.chunk)

    def _budget_for_latency(self, seconds: float) -> int:
        rate = self._rates.get(self._rate_key())
        if rate is None:
            # no observation for this (backend, chunk) yet: start
            # conservatively with one chunk
            return self.planner_config.chunk
        return max(1, int(rate * seconds))

    def execute(
        self,
        spec: QuerySpec | Query,
        *,
        deadline: float | None = None,
        clock=None,
        budget_cap: int | None = None,
    ) -> PlannedAnswer:
        """Answer one spec.  The keyword-only serving hooks pass straight
        through to the planner: ``deadline`` (absolute instant on
        ``clock``; strict specs raise `DeadlineExceededError` when it
        expires with the bound unmet, non-strict ones return the best
        answer so far with ``plan.deadline_hit``) and ``budget_cap`` (hard
        clamp on escalation — the front door's brownout control)."""
        if isinstance(spec, Query):
            spec = QuerySpec(spec, error_bound=0.05)
        planner = self._require_planner()
        hooks = dict(deadline=deadline, clock=clock, budget_cap=budget_cap)
        t0 = time.perf_counter()
        if spec.latency_bound is not None:
            ans = planner.answer(
                spec.query,
                budget=self._budget_for_latency(spec.latency_bound),
                strict=spec.strict,
                **hooks,
            )
        elif spec.budget is not None:
            ans = planner.answer(
                spec.query, budget=spec.budget, strict=spec.strict, **hooks
            )
        else:
            ans = planner.answer(
                spec.query, error_bound=spec.error_bound, strict=spec.strict,
                **hooks,
            )
        dt = max(time.perf_counter() - t0, 1e-6)
        if ans.partitions_read:
            rate = ans.partitions_read / dt
            key = self._rate_key()
            old = self._rates.pop(key, None)  # pop+reinsert: LRU recency
            self._rates[key] = rate if old is None else 0.7 * old + 0.3 * rate
            while len(self._rates) > self.MAX_RATE_KEYS:
                del self._rates[next(iter(self._rates))]
        self._executed += 1
        if ans.plan.degraded:
            self._degraded += 1
            self._partitions_failed += ans.plan.partitions_failed
        return ans

    def execute_batch(self, specs: list[QuerySpec | Query]) -> list[PlannedAnswer]:
        return [self.execute(s) for s in specs]

    # ---- partition lifecycle (see repro_torch.lifecycle) ------------------
    def delete_partitions(self, ext_ids) -> list[int]:
        """Soft-delete partitions by external id.  Derived state folds the
        tombstones in on next access (no rebuild); estimates and CI
        halfwidths exclude the deleted mass at once."""
        return lifecycle.delete_partitions(self.table, ext_ids)

    def compact(self):
        """Reclaim tombstoned slots (a survivor gather; O(touched) folds on
        next access) → the surviving physical slots."""
        return lifecycle.compact(self.table)

    def rebalance(self, num_shards: int | None = None, perm=None):
        """Reshard: apply the canonical ``num_shards`` plan or an explicit
        slot permutation.  External ids are unchanged."""
        if (num_shards is None) == (perm is None):
            raise ValueError("pass exactly one of num_shards= / perm=")
        if perm is None:
            perm = lifecycle.rebalance_plan(self.table, num_shards)
        return lifecycle.rebalance(self.table, perm)

    # ---- durability (WAL + snapshot; see repro_torch.wal) -------------------
    def save(self, directory: str) -> str:
        """Snapshot the table and all derived state (sketches, answer
        caches, views, picker) to ``directory`` → the manifest path.
        `Session.restore` round-trips it bit-identically."""
        return wal.save_snapshot(self, directory)

    @classmethod
    def restore(cls, directory: str, *, options: ExecOptions | None = None,
                planner_config: PlannerConfig | None = None) -> "Session":
        """A Session rebuilt from `save`'s snapshot, on ``options`` (the
        card by default); a WAL tail is replayed by `wal.recover`."""
        return wal.restore_snapshot(cls, directory, options=options,
                                    planner_config=planner_config)

    # ---- observability ----------------------------------------------------
    def stats(self) -> dict:
        """Counters of the session's parts.  The answer store's append
        counters carry the names the reference's serving stats give them."""
        planner = self.planner
        injector = None if planner is None else planner.injector
        return {
            "executed": self._executed,
            "answer_hits": self.answers.hits,
            "answer_misses": self.answers.misses,
            "views": len(self.views),
            "view_incremental_updates": self.views.incremental_updates,
            "view_full_rebuilds": self.views.full_rebuilds,
            "chunk_evals": 0 if planner is None else planner.chunk_evals,
            "read_rate_ema": self._rates.get(self._rate_key()),
            "read_rate_emas": dict(self._rates),
            "ema_keys": len(self._rates),
            "answer_ttl_expired": self.answers.ttl_expired,
            "num_partitions": self.table.num_partitions,
            "num_live": self.table.num_live,
            "sketch_incremental_updates": self.sketches.incremental_updates,
            "sketch_full_rebuilds": self.sketches.full_rebuilds,
            "stack_rewrites": self.answers._eval_cache.stack_rewrites,
            "answers_carried": self.answers.carried,
            "answer_delta_evals": self.answers.delta_evals,
            "degraded_answers": self._degraded,
            "partitions_failed": self._partitions_failed,
            "fault_report": None if injector is None else injector.report(),
        }
