"""Query IR for the paper's supported scope (§2.2).

- Aggregates: SUM / COUNT(*) / AVG over columns or linear projections
  (+, - over one or more columns, constant coefficients).
- Predicates: conjunctions / disjunctions / negations over single-column
  clauses ``c op v`` (numeric comparisons; equality / IN for categoricals).
  We canonicalize to CNF-lite: an AND over OR-groups of clauses, which
  covers the paper's scope (negations fold into the ops).
- GROUP BY: zero or more low-cardinality stored attributes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

OPS = ("<", "<=", ">", ">=", "==", "!=", "in")
AGGS = ("sum", "count", "avg")


@dataclasses.dataclass(frozen=True)
class Clause:
    col: str
    op: str
    value: float | int | tuple[int, ...]

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"bad op {self.op!r}")

    def negated(self) -> "Clause":
        flip = {"<": ">=", "<=": ">", ">": "<=", ">=": "<", "==": "!=", "!=": "=="}
        if self.op in flip:
            return Clause(self.col, flip[self.op], self.value)
        raise ValueError("cannot negate IN directly; expand it")


@dataclasses.dataclass(frozen=True)
class OrGroup:
    """Disjunction of clauses."""

    clauses: tuple[Clause, ...]

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(c.col for c in self.clauses))


@dataclasses.dataclass(frozen=True)
class Predicate:
    """Conjunction of OR-groups.  Empty groups tuple = always-true."""

    groups: tuple[OrGroup, ...] = ()

    @property
    def num_clauses(self) -> int:
        return sum(len(g.clauses) for g in self.groups)

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(c for g in self.groups for c in g.columns))

    @staticmethod
    def conjunction(clauses: Sequence[Clause]) -> "Predicate":
        return Predicate(tuple(OrGroup((c,)) for c in clauses))

    @staticmethod
    def disjunction(clauses: Sequence[Clause]) -> "Predicate":
        return Predicate((OrGroup(tuple(clauses)),))


@dataclasses.dataclass(frozen=True)
class Aggregate:
    """agg over a linear projection Σ coef_i * col_i (count ignores terms)."""

    kind: str  # sum | count | avg
    terms: tuple[tuple[float, str], ...] = ()

    def __post_init__(self):
        if self.kind not in AGGS:
            raise ValueError(f"bad aggregate {self.kind!r}")
        if self.kind != "count" and not self.terms:
            raise ValueError(f"{self.kind} needs at least one term")

    @property
    def columns(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(c for _, c in self.terms))


@dataclasses.dataclass(frozen=True)
class Query:
    aggregates: tuple[Aggregate, ...]
    predicate: Predicate = Predicate()
    groupby: tuple[str, ...] = ()

    @property
    def columns(self) -> tuple[str, ...]:
        cols: list[str] = []
        for a in self.aggregates:
            cols.extend(a.columns)
        cols.extend(self.predicate.columns)
        cols.extend(self.groupby)
        return tuple(dict.fromkeys(cols))

    def describe(self) -> str:
        aggs = ", ".join(
            a.kind.upper()
            + "("
            + ("*" if a.kind == "count" else "+".join(f"{w:g}*{c}" for w, c in a.terms))
            + ")"
            for a in self.aggregates
        )
        pred = " AND ".join(
            "(" + " OR ".join(f"{c.col}{c.op}{c.value}" for c in g.clauses) + ")"
            for g in self.predicate.groups
        )
        gb = ",".join(self.groupby)
        return f"SELECT {aggs}" + (f" WHERE {pred}" if pred else "") + (
            f" GROUP BY {gb}" if gb else ""
        )
