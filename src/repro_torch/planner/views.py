"""Materialized exact aggregates over hot group-by keys (hybrid mode).

Liang et al. (PAPERS.md) combine precomputed aggregation with sampling:
exact aggregates absorb the hot group-bys so sampling only pays for the
residual.  `ViewStore` holds a small set of materialized views — exact
per-group *raw* aggregate totals (count + value sums) for a registered
``(groupby, aggregates)`` pair with no predicate — and serves three
planner-facing capabilities:

  * **exact answers** (`answer`) for queries whose group-by is a subset
    of the view's and whose predicate clauses all reference view group-by
    columns: such a predicate is *group-determined* — every view group's
    rows pass or fail together — so the answer is an exact roll-up of
    the view totals, zero partitions read;
  * **upper bounds** (`upper_bounds`) for queries the view cannot answer
    exactly but whose group-by + aggregates it covers: dropping the
    predicate clauses on non-view columns only enlarges the row set, so
    the roll-up bounds COUNT and positive-column SUM aggregates from
    above per group.  The planner clips sampled confidence intervals
    against these caps, and groups absent from the capped roll-up are
    *known empty* — their truth is exactly zero;
  * **incremental maintenance** through the append log: totals are
    per-partition sums, so a pure partition append (`Table.append_range`)
    is folded in by evaluating only the delta partitions — O(new
    partitions), same discipline as `SketchStore` — while non-append
    mutations trigger a full rebuild.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.backends import ExecOptions
from repro_torch.data.table import NUMERIC, Table
from repro_torch.queries.engine import (
    per_partition_answers,
    plan_aggregates,
)
from repro_torch.queries.ir import Aggregate, Predicate, Query


@dataclasses.dataclass
class MaterializedView:
    """Exact raw totals per group for one (groupby, aggregates) pair.

    ``part_raw`` keeps the totals in their per-partition form — (P, Gv,
    n_raw) over *every physical* partition, tombstoned ones included.
    ``totals`` is always *derived* from it (`ViewStore._derive_totals`:
    sum over the live partitions in ascending physical order), never
    accumulated incrementally: the derivation's float fold order is
    exactly the cold build's, so view answers stay bit-identical to a
    from-scratch oracle across any interleaving of appends, deletes,
    compactions and rebalances — and a soft-delete updates the view by
    re-deriving, with the deleted mass genuinely gone from the totals.
    """

    groupby: tuple[str, ...]
    aggregates: tuple[Aggregate, ...]
    group_keys: np.ndarray  # (Gv,) mixed-radix codes over `groupby`
    totals: np.ndarray  # (Gv, n_raw); [:, 0] = exact LIVE row count
    plans: list  # _AggPlan per aggregate (raw component mapping)
    part_raw: np.ndarray | None = None  # (P, Gv, n_raw) physical partitions

    def raw_index(self, agg: Aggregate) -> int | None:
        """Raw-component index holding ``agg``'s value sum (0 for count)."""
        for a, p in zip(self.aggregates, self.plans):
            if agg.kind == "count" and p.kind == "count":
                return 0
            if a.kind != "count" and agg.kind != "count" and a.terms == agg.terms:
                return p.raw_index
        return None

    def covers_aggregates(self, query: Query) -> bool:
        return all(self.raw_index(a) is not None for a in query.aggregates)


def _decode_columns(
    keys: np.ndarray, groupby: tuple[str, ...], cards: dict[str, int]
) -> dict[str, np.ndarray]:
    """Mixed-radix view codes → per-column category values, (Gv,) each."""
    out: dict[str, np.ndarray] = {}
    rem = keys.astype(np.int64)
    for col in reversed(groupby):
        card = cards[col]
        out[col] = rem % card
        rem = rem // card
    return out


class ViewStore:
    """Version-tracked materialized views for one table.

    ``incremental_updates`` / ``full_rebuilds`` count the maintenance
    paths, mirroring `SketchStore`; `bench_planner` reads them.
    """

    def __init__(self, table: Table, options: ExecOptions | None = None):
        self.table = table
        self.options = options if options is not None else ExecOptions()
        self._views: list[MaterializedView] = []
        self._version = table.version
        self._cards = {
            s.name: s.cardinality for s in table.schema if s.kind != NUMERIC
        }
        self.incremental_updates = 0
        self.full_rebuilds = 0
        # serving front door: register/refresh/answer race between the
        # flush loop and admission threads — serialize every path that
        # reads or rewrites self._views / self._version
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._views)

    # ---- registration / maintenance ---------------------------------------
    def _view_query(self, groupby, aggregates) -> Query:
        return Query(tuple(aggregates), Predicate(), tuple(groupby))

    def _materialize(self, groupby, aggregates, table: Table):
        """(group_keys, per-partition raw) over ``table``'s partitions."""
        ans = per_partition_answers(
            table, self._view_query(groupby, aggregates), options=self.options
        )
        return ans.group_keys, ans.raw

    def _derive_totals(self, part_raw: np.ndarray) -> np.ndarray:
        """Live totals from per-partition raw: sum over non-tombstoned
        partitions in ascending physical order — the exact float fold a
        cold materialization over the same table performs."""
        live = np.flatnonzero(self.table.live_mask())
        return part_raw[live].sum(axis=0)

    def register(
        self, groupby: tuple[str, ...], aggregates: tuple[Aggregate, ...]
    ) -> MaterializedView:
        """Materialize exact totals for a hot group-by; O(P) once."""
        groupby = tuple(groupby)
        for col in groupby:
            if col not in self._cards:
                raise ValueError(f"view group-by on non-categorical column {col!r}")
        aggregates = tuple(aggregates)
        with self._lock:
            self.refresh()
            plans, _ = plan_aggregates(aggregates)
            keys, part_raw = self._materialize(groupby, aggregates, self.table)
            view = MaterializedView(
                groupby, aggregates, keys, self._derive_totals(part_raw),
                plans, part_raw=part_raw,
            )
            self._views.append(view)
            return view

    def refresh(self) -> None:
        """Fold table mutations into every view: O(delta) for appends
        (evaluate only the appended partitions), O(touched) gathers for
        compaction/rebalance, a totals re-derivation for soft-deletes;
        full rebuild only for unfoldable chains."""
        with self._lock:
            self._refresh_locked()

    def _refresh_locked(self) -> None:
        from repro_torch.data.table import events_foldable

        if self.table.version == self._version or not self._views:
            self._version = self.table.version
            return
        events = self.table.mutation_events(self._version)
        foldable = events is not None and events_foldable(events)
        for i, v in enumerate(self._views):
            if not foldable or v.part_raw is None:
                self.full_rebuilds += 1
                keys, part_raw = self._materialize(
                    v.groupby, v.aggregates, self.table
                )
            else:
                self.incremental_updates += 1
                keys, part_raw = v.group_keys, v.part_raw
                for ev in events:
                    if ev[0] == "delete":
                        continue  # totals re-derive below; raw rows stand
                    if ev[0] == "append":
                        if ev[1] != part_raw.shape[0]:
                            continue  # earlier fold already read past it
                        t = self.table
                        cols = {k: c[ev[1]:] for k, c in t.columns.items()}
                        delta = Table(
                            t.schema, cols, name=f"{t.name}/viewdelta"
                        )
                        dk, draw = self._materialize(
                            v.groupby, v.aggregates, delta
                        )
                        merged = np.union1d(keys, dk)
                        pr = np.zeros(
                            (t.num_partitions, merged.shape[0],
                             part_raw.shape[2])
                        )
                        pr[: part_raw.shape[0],
                           np.searchsorted(merged, keys)] = part_raw
                        pr[part_raw.shape[0]:,
                           np.searchsorted(merged, dk)] = draw
                        keys, part_raw = merged, pr
                    elif ev[0] == "compact":
                        pr = part_raw[np.asarray(ev[1])]
                        # survivors-only occupancy: a group whose mass
                        # lived only in dropped slots disappears, as the
                        # cold materialization would decide (counts are
                        # integers in float64 — the sum test is exact)
                        occ = np.flatnonzero(pr[:, :, 0].sum(axis=0) > 0)
                        keys, part_raw = keys[occ], pr[:, occ, :]
                    else:  # rebalance: pure gather, occupancy unchanged
                        part_raw = part_raw[np.asarray(ev[1])]
            self._views[i] = dataclasses.replace(
                v, group_keys=keys, totals=self._derive_totals(part_raw),
                part_raw=part_raw,
            )
        self._version = self.table.version

    # ---- query matching ---------------------------------------------------
    def _find(self, query: Query, need_exact: bool) -> MaterializedView | None:
        qset = set(query.groupby)
        pcols = set(query.predicate.columns)
        for v in self._views:
            vset = set(v.groupby)
            if not qset <= vset or not v.covers_aggregates(query):
                continue
            if need_exact and not pcols <= vset:
                continue
            return v
        return None

    def _rollup(self, view: MaterializedView, query: Query):
        """Evaluate ``query`` against the view totals, keeping only the
        predicate clauses on view columns (all of them, in the exact case).
        Returns (q_keys, raw (Gq, n_raw_q)) in the query's raw layout."""
        vals = _decode_columns(view.group_keys, view.groupby, self._cards)
        mask = np.ones(view.group_keys.shape[0], dtype=bool)
        for group in query.predicate.groups:
            clauses = [c for c in group.clauses if c.col in vals]
            if len(clauses) != len(group.clauses):
                continue  # conjunct on non-view columns: drop (upper bound)
            gmask = np.zeros_like(mask)
            for c in clauses:
                x, op, v = vals[c.col], c.op, c.value
                if op == "<":
                    gmask |= x < v
                elif op == "<=":
                    gmask |= x <= v
                elif op == ">":
                    gmask |= x > v
                elif op == ">=":
                    gmask |= x >= v
                elif op == "==":
                    gmask |= x == v
                elif op == "!=":
                    gmask |= x != v
                else:  # in
                    gmask |= np.isin(x, np.asarray(v))
            mask &= gmask
        keys = view.group_keys[mask]
        if keys.size == 0:
            plans, n_raw = plan_aggregates(query.aggregates)
            return np.empty(0, np.int64), np.zeros((0, n_raw))
        # roll view groups up to the query's group-by codes
        q_codes = np.zeros(keys.shape[0], np.int64)
        for col in query.groupby:
            q_codes = q_codes * self._cards[col] + vals[col][mask]
        plans, n_raw = plan_aggregates(query.aggregates)
        q_keys = np.unique(q_codes)
        seg = np.searchsorted(q_keys, q_codes)
        raw = np.zeros((q_keys.shape[0], n_raw))
        src = view.totals[mask]
        raw[:, 0] = np.bincount(seg, weights=src[:, 0], minlength=q_keys.shape[0])
        k = 1
        for agg in query.aggregates:
            if agg.kind == "count":
                continue
            j = view.raw_index(agg)
            raw[:, k] = np.bincount(seg, weights=src[:, j], minlength=q_keys.shape[0])
            k += 1
        return q_keys, raw

    def _finalize(self, query: Query, raw: np.ndarray) -> np.ndarray:
        plans, _ = plan_aggregates(query.aggregates)
        cnt = raw[:, 0]
        out = np.zeros((raw.shape[0], len(plans)))
        for j, p in enumerate(plans):
            if p.kind == "count":
                out[:, j] = cnt
            elif p.kind == "sum":
                out[:, j] = raw[:, p.raw_index]
            else:
                with np.errstate(invalid="ignore", divide="ignore"):
                    out[:, j] = raw[:, p.raw_index] / cnt
        out[cnt <= 0] = np.nan
        return out

    def answer(self, query: Query):
        """Exact ``(group_keys, estimate)`` when a view determines the
        query (group-by ⊆ view, predicate on view columns, aggregates
        covered); None otherwise.  Zero partitions read."""
        with self._lock:
            self._refresh_locked()
            view = self._find(query, need_exact=True)
            if view is None:
                return None
            keys, raw = self._rollup(view, query)
            present = raw[:, 0] > 0
            return keys[present], self._finalize(query, raw[present])

    def upper_bounds(self, query: Query):
        """Per-group caps ``(q_keys, caps (Gq, n_aggs))`` for the clipping
        hybrid, or None.  ``caps[g, j]`` is a true upper bound for COUNT
        and positive-sum aggregates (inf where not boundable); groups NOT
        in ``q_keys`` are known-empty under the predicate's view-column
        conjuncts — their true answer is exactly zero."""
        with self._lock:
            return self._upper_bounds_locked(query)

    def _upper_bounds_locked(self, query: Query):
        self._refresh_locked()
        view = self._find(query, need_exact=False)
        if view is None:
            return None
        keys, raw = self._rollup(view, query)
        present = raw[:, 0] > 0
        keys, raw = keys[present], raw[present]
        caps = np.full((keys.shape[0], len(query.aggregates)), np.inf)
        plans, _ = plan_aggregates(query.aggregates)
        positive = {
            s.name for s in self.table.schema
            if s.kind == NUMERIC and getattr(s, "positive", False)
        }
        for j, (agg, p) in enumerate(zip(query.aggregates, plans)):
            if p.kind == "count":
                caps[:, j] = raw[:, 0]
            elif p.kind == "sum" and all(
                coef > 0 and col in positive for coef, col in agg.terms
            ):
                caps[:, j] = raw[:, p.raw_index]
        return keys, caps
