"""Carry state from the JAX reference package into the port.

The port never imports the reference, so these helpers read reference
objects by their attributes (duck typing): a ``Table`` from its schema
fields and numpy columns, a ``Query`` from its aggregates, predicate
groups and group-by, ``TableSketches`` from their numpy fields, and a
trained picker from its funnel (forest arrays, bin edges, pass and label
thresholds) and clustering mask — the system's weights.  Tests make a
table once with numpy from a seed and hand the same bytes to both.
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


# --------------------------------------------------------------------------
# derived state: sketches and the trained picker (the system's weights)
# --------------------------------------------------------------------------
def _copy(a):
    return None if a is None else np.array(a, copy=True)


def sketches(ref):
    """A port `TableSketches` with copies of the reference sketches' fields."""
    from repro_torch.core.sketches import ColumnSketch, TableSketches

    cols = {}
    for name, cs in ref.columns.items():
        cols[name] = ColumnSketch(
            cs.name, cs.kind, _copy(cs.measures), _copy(cs.hist_edges), _copy(cs.cat_counts),
            _copy(cs.ndv), _copy(cs.dv_freq), _copy(cs.hh_stats),
            None if cs.hh_items is None else [dict(d) for d in cs.hh_items],
            _copy(cs.global_hh), _copy(cs.bitmap),
            discrete_span=None if cs.discrete_span is None else tuple(cs.discrete_span),
            part_spans=_copy(getattr(cs, "part_spans", None)),
        )
    return TableSketches(ref.table_name, int(ref.num_partitions),
                         int(ref.rows_per_partition), cols)


def forest(ref):
    """A port `Forest` with the reference forest's exported arrays and edges."""
    from repro_torch.core.gbdt import Binner, Forest

    return Forest(int(ref.depth), float(ref.learning_rate), float(ref.base),
                  _copy(ref.feat), _copy(ref.thr), _copy(ref.leaf),
                  Binner(_copy(ref.binner.edges)))


def funnel(ref):
    """A port `ImportanceFunnel`: the carried forests, pass thresholds (taus)
    and label thresholds."""
    from repro_torch.core.funnel import ImportanceFunnel

    return ImportanceFunnel([forest(f) for f in ref.forests], _copy(ref.taus),
                            _copy(ref.thresholds))


def picker(ref, port_table, port_fb, *, options=None):
    """A port `PS3Picker` over ``port_table`` / ``port_fb`` with the reference
    picker's funnel, clustering mask and config."""
    from repro_torch.core.picker import PickerConfig, PS3Picker

    cfg = PickerConfig(**{k: getattr(ref.config, k)
                          for k in PickerConfig.__dataclass_fields__})
    return PS3Picker(port_table, port_fb, funnel(ref.funnel), _copy(ref.cluster_mask), cfg,
                     options=options)
