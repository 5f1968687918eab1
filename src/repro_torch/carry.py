"""Carry state from the JAX reference package into the port.

The port never imports the reference, so these helpers read reference
objects by their attributes (duck typing): a ``Table`` from its schema
fields and numpy columns, a ``Query`` from its aggregates, predicate
groups and group-by.  Data takes the place of weights here: tests make
a table once with numpy from a seed and hand the same bytes to both.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.table import ColumnSpec, Table
from repro_torch.queries.ir import Aggregate, Clause, OrGroup, Predicate, Query


def column_spec(spec) -> ColumnSpec:
    return ColumnSpec(spec.name, spec.kind, int(spec.cardinality), bool(spec.positive),
                      bool(spec.groupable))


def table(ref) -> Table:
    """A port `Table` with the reference table's schema, name and a copy
    of its columns (fresh version, no mutation history)."""
    return Table(
        tuple(column_spec(s) for s in ref.schema),
        {name: np.array(col, copy=True) for name, col in ref.columns.items()},
        name=ref.name,
    )


def _value(v):
    return tuple(v) if isinstance(v, (tuple, list)) else v


def query(ref) -> Query:
    """A port `Query` equal, field by field, to the reference query."""
    aggs = tuple(
        Aggregate(a.kind, tuple((float(c), str(col)) for c, col in a.terms))
        for a in ref.aggregates
    )
    groups = tuple(
        OrGroup(tuple(Clause(c.col, c.op, _value(c.value)) for c in g.clauses))
        for g in ref.predicate.groups
    )
    return Query(aggs, Predicate(groups), tuple(ref.groupby))


def queries(refs) -> list[Query]:
    return [query(q) for q in refs]
