"""Error-bounded adaptive partition planner (the tentpole).

Every pre-existing entry point takes a fixed partition budget and leaves
the caller to guess the error they will get.  `QueryPlanner` inverts the
contract (BlinkDB-style): the caller states a *relative error bound* (or
a fixed budget, into which `repro_torch.api.Session` also converts latency
bounds) and the planner chooses how many partitions to read:

  1. **consult the materialized views** (`planner.views.ViewStore`):
     a view that determines the query answers it exactly with zero
     partitions read; a view that covers the group-by supplies per-group
     upper caps used to clip sampled intervals (hybrid mode);
  2. **candidates + must-reads**: the selectivity filter keeps only
     partitions that can contain passing rows (sel_upper > 0, perfect
     recall) and the group-by outlier bitmaps force rare-group
     partitions to be read exactly (weight 1) — both straight from the
     picker's Algorithm 1 machinery;
  3. **escalate**: starting from a sketch-prior budget
     (`planner.variance.prior_budget`), sample each funnel stratum by a
     seeded permutation prefix and grow the total budget in powers of
     two while the measured CLT interval (`stratified_answer`) exceeds
     the bound.  Prefix sampling makes every round's read set a superset
     of the last — partitions already read are never re-evaluated
     (`AnswerStore.get_subset` keys partials by partition-subset
     fingerprint) — and reads are issued in fixed-size partition chunks
     so the device compile census stays flat across rounds: every chunk
     view has exactly ``config.chunk`` partitions, one shape bucket,
     regardless of round or budget.

Returned `PlannedAnswer`s carry ``(estimate, ci_halfwidth,
partitions_read, plan)`` so accuracy and cost claims are auditable.

Reads are fault-aware: under ``ExecOptions(faults=...)`` each chunk's
ids first pass through a seeded `faults.FaultInjector`; partitions that
exhaust their retries are masked inside the same padded chunk shapes,
must-reads and strata members are substituted from the still-readable
candidates, and the survivors' SRSWOR weights re-expand — the answer
reports ``degraded``/``partitions_failed`` instead of raising, unless
``strict=True`` (`PartitionReadError`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
from torch.profiler import record_function

from repro_torch import faults
from repro_torch.core.funnel import allocate
from repro_torch.core.outliers import find_outliers
from repro_torch.errors import (
    BudgetExhaustedError,
    DeadlineExceededError,
    InvalidQueryError,
    PartitionReadError,
)
from repro_torch.planner.variance import StratifiedEstimate, prior_budget, stratified_answer
from repro_torch.queries.engine import (
    AnswerStore,
    group_radix_checked,
    plan_aggregates,
)
from repro_torch.queries.ir import Query


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    z: float = 2.24  # CI multiplier for reported halfwidths
    safety: float = 0.7  # stop at predicted ≤ safety·bound: the stopping
    # metric estimates the MEAN error, so stopping exactly at the bound
    # would leave ~half the queries just above it — the margin buys the
    # ≥90%-of-queries coverage the benchmark gates on
    chunk: int = 16  # partitions per read chunk (one shape bucket)
    min_budget: int = 8  # first escalation rung floor
    growth: float = 1.6  # budget multiplier per round (pow-2 overshoots
    # the stopping point by up to 2×; 1.6 trades a round or two of extra
    # chunk evals — cached partials make them cheap — for tighter stops)
    outlier_frac: float = 0.2  # cap on forced outlier reads (of candidates)
    seed: int = 0  # stratum permutation seed (reads are deterministic)


@dataclasses.dataclass
class QueryPlan:
    """Audit record: how the planner decided what it read."""

    mode: str  # "view" | "sampled" | "hybrid" | "exact" | "empty"
    error_bound: float | None
    budget: int | None
    rounds: int
    schedule: tuple[int, ...]  # total sampled budget per round
    candidates: int
    outliers: int
    strata_sizes: tuple[int, ...]
    predicted_error: float
    # robustness plane: degraded-answer report (defaults = fault-free)
    degraded: bool = False  # failures survived into the answer, the error
    # bound stayed unmet after capped escalation, or a deadline cut it short
    partitions_failed: int = 0
    failed_ids: tuple[int, ...] = ()
    read_report: dict = dataclasses.field(default_factory=dict)
    # serving plane: escalation stopped by a wall-clock deadline (the
    # answer is the best estimate produced before it expired)
    deadline_hit: bool = False


@dataclasses.dataclass
class PlannedAnswer:
    """(estimate, ci_halfwidth, partitions_read, plan) per the contract."""

    query: Query
    group_keys: np.ndarray  # (G,) occupied group codes
    estimate: np.ndarray  # (G, n_aggs)
    ci_halfwidth: np.ndarray  # (G, n_aggs); 0 where exact
    partitions_read: int
    plan: QueryPlan


def _merge_raw(keys_a, raw_a, keys_b, raw_b):
    """Union the occupied groups of two row-disjoint raw tensors.  Rows
    are always preserved (a chunk seeing zero groups still read rows)."""
    keys = np.union1d(keys_a, keys_b)
    raw = np.zeros((raw_a.shape[0] + raw_b.shape[0], keys.shape[0], raw_b.shape[2]))
    if keys_a.size:
        raw[: raw_a.shape[0], np.searchsorted(keys, keys_a)] = raw_a
    if keys_b.size:
        raw[raw_a.shape[0]:, np.searchsorted(keys, keys_b)] = raw_b
    return keys, raw


class QueryPlanner:
    """Error-bounded planner bound to one (picker, answer store, views)."""

    def __init__(
        self,
        picker,
        answers: AnswerStore,
        views=None,
        config: PlannerConfig | None = None,
    ):
        self.picker = picker
        self.fb = picker.fb
        self.funnel = picker.funnel
        self.answers = answers
        self.views = views
        self.config = config or PlannerConfig()
        self.chunk_evals = 0  # telemetry: chunk reads issued
        # fault-aware reads: the injector (None when ExecOptions.faults is
        # unset) gates every chunk read; irrecoverable partitions are
        # masked inside the padded chunk shapes and the answer degrades —
        # the planner never raises for read failures unless strict=True
        self.injector = faults.injector_for(answers.options)

    # ---- read path --------------------------------------------------------
    def _read(self, query, new_ids, state, failed: set | None = None):
        """Evaluate `new_ids` in fixed-`chunk`-size subset views and fold
        them into the accumulated (keys, raw, row_of) state.  Chunks are
        padded by repeating the first id, so every chunk ships exactly
        ``config.chunk`` partitions — one shape bucket, whatever the round
        or budget.

        Under fault injection each chunk's ids first pass through the
        injector (retry/backoff/hedging happen there, in virtual time);
        partitions that exhaust their retries land in ``failed`` and are
        masked *inside* the same padded chunk shape — the survivors pad
        to exactly ``config.chunk`` as before, so failures never add a
        launch key (`queries.device.TRACES` stays flat)."""
        chunk = self.config.chunk
        keys, raw, row_of = state
        for lo in range(0, len(new_ids), chunk):
            ids = np.asarray(new_ids[lo:lo + chunk], dtype=np.int64)
            if self.injector is not None:
                ids, lost = self.injector.read_ids(ids)
                if failed is not None:
                    failed.update(int(i) for i in lost)
                if ids.size == 0:
                    continue  # whole chunk dead: nothing to evaluate
            n_real = ids.size
            if n_real < chunk:
                ids = np.concatenate([ids, np.full(chunk - n_real, ids[0])])
            with record_function("planner.read"):
                ans = self.answers.get_subset(query, ids)
            self.chunk_evals += 1
            keys, raw = _merge_raw(keys, raw, ans.group_keys, ans.raw[:n_real])
            for i in ids[:n_real]:
                row_of[int(i)] = len(row_of)
        return keys, raw, row_of

    # ---- planning ---------------------------------------------------------
    def answer(
        self,
        query: Query,
        error_bound: float | None = None,
        budget: int | None = None,
        strict: bool = False,
        *,
        budget_cap: int | None = None,
        deadline: float | None = None,
        clock=None,
    ) -> PlannedAnswer:
        """``budget_cap``/``deadline``/``clock`` are the serving hooks:

        * ``budget_cap`` clamps how far escalation may grow, whatever the
          error bound asks for (the brownout controller shrinks it in
          steps under load);
        * ``deadline`` is an absolute instant on ``clock`` (defaults to
          ``time.monotonic``; serving and chaos tests pass a
          `faults.VirtualClock` shared with the injector).  Escalation
          checks it between rounds: strict requests whose bound is still
          unmet raise `DeadlineExceededError`, non-strict ones return the
          best answer produced so far with ``plan.deadline_hit`` /
          ``plan.degraded`` set and the honest (wider) interval.
        """
        if (error_bound is None) == (budget is None):
            raise InvalidQueryError("pass exactly one of error_bound= / budget=")
        if budget_cap is not None and budget_cap < 1:
            raise InvalidQueryError(f"budget_cap must be >= 1, got {budget_cap}")
        if deadline is not None and clock is None:
            clock = time.monotonic
        if deadline is not None and strict and clock() >= deadline:
            # expired before any read: shed the whole plan, zero cost
            raise DeadlineExceededError(
                f"deadline expired {clock() - deadline:.3f}s before "
                "planning began",
                predicted_error=None,
                partitions_read=0,
            )
        if budget is not None and budget_cap is not None:
            budget = min(int(budget), int(budget_cap))
        cfg = self.config
        plans, n_raw = plan_aggregates(query.aggregates)
        n_aggs = len(plans)
        radix = group_radix_checked(self.fb.table, query.groupby)

        # 1. view store: exact answer = zero partitions read
        if self.views is not None:
            hit = self.views.answer(query)
            if hit is not None:
                keys, est = hit
                plan = QueryPlan("view", error_bound, budget, 0, (), 0, 0, (), 0.0)
                return PlannedAnswer(
                    query, keys, est, np.zeros_like(est), 0, plan
                )
            caps = self.views.upper_bounds(query)
        else:
            caps = None

        # 2. candidates (perfect-recall selectivity filter) + must-reads
        sel = self.fb.selectivity(query)
        feats = self.fb.features(query)
        # live-mask filter: tombstoned partitions leave the candidate set
        # (and hence every stratum population N_h), so estimates and CI
        # halfwidths stay honest after deletes without a rebuild
        candidates = np.flatnonzero(
            (sel[:, 0] > 0) & self.fb.table.live_mask()
        )
        if candidates.size == 0:
            plan = QueryPlan("empty", error_bound, budget, 0, (), 0, 0, (), 0.0)
            return PlannedAnswer(
                query, np.empty(0, np.int64), np.zeros((0, n_aggs)),
                np.zeros((0, n_aggs)), 0, plan,
            )
        # 3. first rung: the sketch prior forecasts grand-total variance,
        # which is far more pessimistic than the per-group relative metric
        # on easy queries — cap it and let the measured CI (which sees the
        # actual per-group spreads) drive escalation from there.
        if budget is not None:
            rung0 = max(1, min(int(budget), candidates.size))
            rounds_left = 1
        else:
            prior = prior_budget(
                query, self.fb.sk, sel, candidates, error_bound, cfg.z,
                self.fb.table.rows_per_partition, radix,
            )
            cap0 = max(cfg.min_budget, candidates.size // 4)
            total0 = int(min(max(cfg.min_budget, prior), cap0, candidates.size))
            rung0 = total0
            rounds_left = 64  # geometric growth: hits |inliers| well before
        # must-reads: rare-group partitions, capped relative to the rung
        # (not the candidate count — a probably-empty query must not sink
        # 20% of the table into outlier reads before its first estimate)
        outlier_ids = np.empty(0, np.int64)
        max_out = max(1, int(cfg.outlier_frac * rung0))
        if query.groupby:
            bits = self.picker._gb_bitmaps(query, candidates)
            outlier_ids = find_outliers(candidates, bits, max_out)
        failed: set[int] = set()
        state = (np.empty(0, np.int64), np.zeros((0, 0, n_raw)), {})
        if outlier_ids.size:
            state = self._read(query, outlier_ids, state, failed)
            # outlier substitution: a failed must-read is often not the
            # only partition holding its rare groups — recompute the
            # outlier cover over the still-readable candidates and read
            # the substitute holders.  Runs BEFORE strata are built so
            # substitutes join the weight-1 outlier set instead of
            # double-counting inside a stratum's expansion.  Terminates:
            # each pass reads only never-attempted ids.
            while failed:
                alive = candidates[~np.isin(
                    candidates, np.fromiter(failed, np.int64, len(failed))
                )]
                subs = find_outliers(
                    alive, self.picker._gb_bitmaps(query, alive), max_out
                )
                subs = np.setdiff1d(subs, outlier_ids)
                if subs.size == 0:
                    break
                outlier_ids = np.union1d(outlier_ids, subs)
                state = self._read(query, subs, state, failed)
        inliers = np.setdiff1d(candidates, outlier_ids)
        # brownout clamp: escalation may never grow past `limit` sampled
        # partitions, however far the bound would like to go.  Floor of 2
        # keeps sample variances defined (matching total0 below).
        limit = int(inliers.size)
        if budget_cap is not None:
            limit = min(limit, max(2, int(budget_cap) - int(outlier_ids.size)))
        strata = self.funnel.classify(feats, inliers)
        strata = [s for s in strata if s.size]
        if not strata:
            strata = [inliers]
        sizes = [s.size for s in strata]
        rng = np.random.default_rng(cfg.seed)
        perms = [s[rng.permutation(s.size)] for s in strata]
        total0 = max(0 if budget is not None else 2, rung0 - outlier_ids.size)
        total0 = min(total0, limit)
        taken = [0] * len(strata)  # ATTEMPTED prefix per stratum (failed
        # ids stay counted — the pointer only advances, so escalation
        # terminates even when every remaining read fails)
        want = [0] * len(strata)  # surviving-read target per stratum
        schedule: list[int] = []
        total = total0
        est: StratifiedEstimate | None = None
        scales = None
        deadline_hit = False
        while True:
            alloc = self._allocate(sizes, total, scales)
            new_ids: list[int] = []
            for h, n_h in enumerate(alloc):
                n_h = max(taken[h], n_h)  # prefix reuse: never shrink
                if sizes[h] > n_h >= sizes[h] - 1:
                    n_h = sizes[h]  # don't leave a lone unread partition
                want[h] = max(want[h], n_h)
                new_ids.extend(int(i) for i in perms[h][taken[h]:n_h])
                taken[h] = max(taken[h], n_h)
            if new_ids:
                state = self._read(query, new_ids, state, failed)
            # replacement substitution: when reads failed, extend each
            # stratum's attempted prefix until the SURVIVING count reaches
            # its allocation target (or the stratum runs out of ids).
            # Terminates: `taken` strictly advances, bounded by `sizes`.
            while failed:
                repl: list[int] = []
                for h, p in enumerate(perms):
                    lost = sum(1 for i in p[:taken[h]] if int(i) in failed)
                    deficit = min(want[h], sizes[h] - lost) - (taken[h] - lost)
                    if deficit > 0:
                        stop = min(taken[h] + deficit, sizes[h])
                        repl.extend(int(i) for i in p[taken[h]:stop])
                        taken[h] = stop
                if not repl:
                    break
                state = self._read(query, repl, state, failed)
            schedule.append(sum(taken))
            keys, raw, row_of = state
            sampled = [p[:t] for p, t in zip(perms, taken)]
            if failed:
                # degraded weighting: SRSWOR weights re-expand over the
                # surviving sample per stratum — N_h/n_h with n_h the
                # survivors, while N_h keeps the full population
                fail_arr = np.fromiter(failed, np.int64, len(failed))
                sampled = [s[~np.isin(s, fail_arr)] for s in sampled]
            n_survived = sum(s.size for s in sampled)
            frac_unread = 1.0 - n_survived / max(inliers.size, 1)
            outlier_read = outlier_ids
            if failed and outlier_ids.size:
                outlier_read = outlier_ids[~np.isin(outlier_ids, fail_arr)]
            est = stratified_answer(
                query, plans, keys, raw, row_of, outlier_read,
                strata, sampled, cfg.z, frac_unread, n_failed=len(failed),
            )
            scales = est.stratum_scales
            estimate, hw, predicted = self._apply_caps(
                query, caps, est, n_aggs
            )
            rounds_left -= 1
            done_all = all(t >= s for t, s in zip(taken, sizes))
            if deadline is not None and clock() >= deadline:
                # the answer in hand is the best one the deadline allows
                deadline_hit = True
                break
            if budget is not None or rounds_left <= 0:
                break
            if (predicted <= cfg.safety * error_bound or done_all
                    or sum(taken) >= limit):
                break
            total = int(min(np.ceil(total * cfg.growth), limit))
        partitions_read = int(outlier_read.size + n_survived)
        # degraded contract: failures survived into the answer, or the
        # error bound stayed unmet after escalating to every readable
        # candidate / the rounds cap.  Default: report, never raise.
        bound_unmet = (
            error_bound is not None and predicted > cfg.safety * error_bound
        )
        degraded = bool(failed) or bound_unmet or deadline_hit
        if strict and bound_unmet and deadline_hit:
            raise DeadlineExceededError(
                f"deadline expired with error bound {error_bound} unmet "
                f"after {len(schedule)} round(s): predicted error "
                f"{predicted:.4f} exceeds the stopping margin",
                predicted_error=float(predicted),
                partitions_read=int(outlier_read.size + n_survived),
            )
        if strict and bound_unmet:
            # the stronger contract violation: even reading everything
            # readable could not meet the bound (unachievable bound, or
            # failures darkened too much of the table)
            raise BudgetExhaustedError(
                f"error bound {error_bound} unmet after reading "
                f"{partitions_read} partition(s) "
                f"({len(failed)} failed): predicted error "
                f"{predicted:.4f} exceeds the stopping margin",
                predicted_error=float(predicted),
                partitions_read=partitions_read,
            )
        if strict and failed:
            raise PartitionReadError(
                f"planner: {len(failed)} partition read(s) failed past the "
                f"retry budget under strict=True",
                failed_ids=sorted(failed),
                report=self.injector.report() if self.injector else {},
            )
        if (done_all and not failed
                and outlier_ids.size + inliers.size == candidates.size):
            mode = "exact"
            hw = np.zeros_like(hw)
        elif caps is not None:
            mode = "hybrid"
        else:
            mode = "sampled"
        plan = QueryPlan(
            mode, error_bound, budget, len(schedule), tuple(schedule),
            int(candidates.size), int(outlier_ids.size), tuple(sizes),
            float(predicted),
            degraded=degraded,
            partitions_failed=len(failed),
            failed_ids=tuple(sorted(failed)),
            read_report=self.injector.report() if self.injector else {},
            deadline_hit=deadline_hit,
        )
        return PlannedAnswer(
            query, est.group_keys if mode != "hybrid" else self._cap_keys(est, caps),
            estimate, hw, int(partitions_read), plan,
        )

    # ---- helpers ----------------------------------------------------------
    def _allocate(self, sizes, total, scales):
        """Per-stratum sample counts: Neyman (∝ N_h·σ_h) once measured
        spreads exist, the funnel's α-decay split before that; at least 2
        per non-empty stratum so sample variances are defined."""
        sizes_a = np.asarray(sizes, np.float64)
        total = int(min(total, int(sizes_a.sum())))
        if scales is not None and np.any(np.asarray(scales) > 0):
            s = np.asarray(scales, np.float64)
            # smooth toward proportional: a stratum whose sampled reads
            # happened to look empty must keep growing, or the groups it
            # hides never surface and escalation stalls below the bound
            w = sizes_a * (s + 0.25 * s.mean() + 1e-12)
            alloc = np.floor(total * w / w.sum()).astype(int)
        else:
            w = sizes_a
            alloc = np.asarray(allocate(list(sizes), total, self.picker.config.alpha))
        alloc = np.minimum(np.maximum(alloc, 2), np.asarray(sizes))
        # repair to sum exactly `total` where headroom allows, so that
        # total == Σ sizes ⇒ alloc == sizes (escalation terminates)
        diff = total - int(alloc.sum())
        order = np.argsort(-w)
        while diff != 0:
            moved = False
            for i in order:
                if diff > 0 and alloc[i] < sizes[i]:
                    alloc[i] += 1
                    diff -= 1
                    moved = True
                elif diff < 0 and alloc[i] > 2:
                    alloc[i] -= 1
                    diff += 1
                    moved = True
                if diff == 0:
                    break
            if not moved:
                break
        return [int(a) for a in alloc]

    def _apply_caps(self, query, caps, est: StratifiedEstimate, n_aggs):
        """Clipping hybrid: intersect sampled CIs with the view's
        per-group caps; groups absent from the caps are known-empty."""
        estimate = est.estimate.copy()
        hw = np.nan_to_num(est.ci_halfwidth.copy(), nan=0.0)
        if caps is None:
            return estimate, hw, est.predicted_error
        cap_keys, cap_vals = caps
        # known-empty elimination: sampled groups outside the capped key
        # set have zero rows under the view-column conjuncts
        known = np.isin(est.group_keys, cap_keys)
        idx = np.searchsorted(cap_keys, est.group_keys[known])
        cap = np.full((est.group_keys.shape[0], n_aggs), np.inf)
        cap[known] = cap_vals[idx]
        cap[~known] = 0.0
        finite = np.isfinite(cap)
        lo = np.maximum(estimate - hw, 0.0)
        hi = np.minimum(estimate + hw, np.where(finite, cap, np.inf))
        hi = np.maximum(hi, lo)
        mid = np.where(finite, (lo + hi) / 2.0, estimate)
        hw2 = np.where(finite, (hi - lo) / 2.0, hw)
        present = est.raw_estimate[:, 0] > 0 if est.raw_estimate.size else np.zeros(0, bool)
        estimate[present] = mid[present]
        hw[present] = hw2[present]
        exp_abs = np.sqrt(2.0 / np.pi) / self.config.z  # hw → expected |err|
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = exp_abs * np.abs(hw[present]) / np.maximum(
                np.abs(estimate[present]), 1e-12
            )
        rel = np.minimum(np.nan_to_num(rel, nan=1.0), 1.0)
        g_seen = int(present.sum())
        predicted = float(rel.sum()) / max(n_aggs, 1) / max(g_seen, 1)
        return estimate, hw, predicted

    def _cap_keys(self, est: StratifiedEstimate, caps):
        return est.group_keys
