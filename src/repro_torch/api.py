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
keeps every piece consistent across table mutations (sketches, cached
answers and views rebuild when the table's version moves).

Not ported yet: the partition lifecycle (`delete_partitions`, `compact`,
`rebalance`), the WAL (`save`, `restore`) and fault injection
(`FaultPolicy`).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.backends import ExecOptions
from repro_torch.core.features import FeatureBuilder
from repro_torch.errors import (  # noqa: F401  (re-export)
    BudgetExhaustedError,
    DeadlineExceededError,
    InvalidQueryError,
    ReproError,
    SessionStateError,
    StaleStateError,
)
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
    "InvalidQueryError",
    "Predicate",
    "Query",
    "QuerySpec",
    "ReproError",
    "Session",
    "SessionStateError",
    "StaleStateError",
]


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """A query plus exactly one budgeting contract."""

    query: Query
    error_bound: float | None = None  # relative error the answer must meet
    latency_bound: float | None = None  # seconds (→ budget via read-rate EMA)
    budget: int | None = None  # fixed partition count (legacy contract)
    strict: bool = False  # raise BudgetExhaustedError instead of returning
    # an answer that misses the bound

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
            # table changed: refresh features from the current sketches
            # so selectivity/outliers see every partition
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
        return ans

    def execute_batch(self, specs: list[QuerySpec | Query]) -> list[PlannedAnswer]:
        return [self.execute(s) for s in specs]

    # ---- observability ----------------------------------------------------
    def stats(self) -> dict:
        """Counters of the session's parts.  Unlike the reference there are
        no keys for what the port lacks yet: ``num_live`` and the stack
        rewrites (lifecycle), the incremental sketch and view folds
        (streaming), ``partitions_failed`` and ``fault_report`` (faults)."""
        planner = self.planner
        return {
            "executed": self._executed,
            "answer_hits": self.answers.hits,
            "answer_misses": self.answers.misses,
            "views": len(self.views),
            "view_full_rebuilds": self.views.full_rebuilds,
            "chunk_evals": 0 if planner is None else planner.chunk_evals,
            "read_rate_ema": self._rates.get(self._rate_key()),
            "read_rate_emas": dict(self._rates),
            "ema_keys": len(self._rates),
            "answer_ttl_expired": self.answers.ttl_expired,
            "num_partitions": self.table.num_partitions,
            "sketch_full_rebuilds": self.sketches.full_rebuilds,
            "degraded_answers": self._degraded,
        }
