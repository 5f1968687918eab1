"""Random workload generator (paper §5.1.2).

A workload sample draws at random:
  * 0–8 group-by columns (from the groupable low-cardinality set; combined
    radix capped, mirroring the paper's moderate-distinctiveness scope),
  * 0–5 predicate clauses (column, op, constant); constants are drawn from
    data quantiles / observed codes so predicates have non-trivial and
    well-spread selectivity.  A fraction of multi-clause predicates use an
    OR-group to exercise disjunctions.
  * 1–3 aggregates: COUNT(*), SUM/AVG over a column or a 2-term linear
    projection (+/- combinations, e.g. extendedprice*(1-discount)-style
    surrogates are covered by coefficient -1 terms).
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.table import CATEGORICAL, NUMERIC, Table
from repro_torch.queries.engine import MAX_GROUPS
from repro_torch.queries.ir import Aggregate, Clause, OrGroup, Predicate, Query


class WorkloadSpec:
    """The picker's preparation input: aggregate columns + group-by sets."""

    def __init__(self, table: Table, seed: int = 0, max_radix: int | None = None):
        self.table = table
        self.numeric = [s.name for s in table.schema if s.kind == NUMERIC]
        self.categorical = [s.name for s in table.schema if s.kind == CATEGORICAL]
        self.groupable = list(table.groupable_columns)
        self.rng = np.random.default_rng(seed)
        # "moderate distinctiveness" scope (§2.2): cap the combined group
        # radix relative to partition size so partitions can cover groups.
        self.max_radix = max_radix or min(MAX_GROUPS, table.rows_per_partition)
        # quantile tables for realistic constants
        self._quantiles = {
            c: np.quantile(table.flat(c), np.linspace(0.02, 0.98, 25))
            for c in self.numeric
        }

    # ---- pieces ---------------------------------------------------------
    def sample_groupby(self) -> tuple[str, ...]:
        k = int(self.rng.integers(0, 9))
        if k == 0 or not self.groupable:
            return ()
        cols = list(self.rng.permutation(self.groupable))
        chosen: list[str] = []
        radix = 1
        for c in cols[:k]:
            card = self.table.spec(c).cardinality
            if radix * card > self.max_radix:
                continue
            chosen.append(c)
            radix *= card
        return tuple(sorted(chosen))

    def sample_clause(self) -> Clause:
        if self.rng.random() < 0.55 and self.numeric:
            col = str(self.rng.choice(self.numeric))
            op = str(self.rng.choice(["<", "<=", ">", ">=",]))
            val = float(self.rng.choice(self._quantiles[col]))
            return Clause(col, op, val)
        col = str(self.rng.choice(self.categorical))
        card = self.table.spec(col).cardinality
        if self.rng.random() < 0.3 and card > 3:
            k = int(self.rng.integers(2, min(6, card)))
            vals = tuple(int(v) for v in self.rng.choice(card, size=k, replace=False))
            return Clause(col, "in", vals)
        op = "==" if self.rng.random() < 0.8 else "!="
        return Clause(col, op, int(self.rng.integers(0, card)))

    def sample_predicate(self) -> Predicate:
        k = int(self.rng.integers(0, 6))
        clauses = [self.sample_clause() for _ in range(k)]
        if len(clauses) >= 3 and self.rng.random() < 0.3:
            # fold the first few clauses into a disjunction
            j = int(self.rng.integers(2, len(clauses) + 1))
            return Predicate(
                (OrGroup(tuple(clauses[:j])),)
                + tuple(OrGroup((c,)) for c in clauses[j:])
            )
        return Predicate.conjunction(clauses)

    def sample_aggregate(self) -> Aggregate:
        r = self.rng.random()
        if r < 0.25:
            return Aggregate("count")
        kind = "sum" if r < 0.75 else "avg"
        n_terms = 1 if self.rng.random() < 0.7 else 2
        cols = self.rng.choice(self.numeric, size=n_terms, replace=False)
        terms = tuple(
            (float(self.rng.choice([1.0, 1.0, -1.0])), str(c)) for c in cols
        )
        return Aggregate(kind, terms)

    def sample_query(self) -> Query:
        n_aggs = int(self.rng.integers(1, 4))
        aggs = tuple(self.sample_aggregate() for _ in range(n_aggs))
        return Query(aggs, self.sample_predicate(), self.sample_groupby())

    def sample_workload(self, n: int, reject_empty: bool = True) -> list[Query]:
        """n distinct queries; optionally reject all-empty predicates."""
        out: list[Query] = []
        seen: set[str] = set()
        while len(out) < n:
            q = self.sample_query()
            key = q.describe()
            if key in seen:
                continue
            seen.add(key)
            out.append(q)
        return out
