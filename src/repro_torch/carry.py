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


def fault_policy(ref):
    """A port `FaultPolicy` with the reference policy's fields (the same
    seed, rates, virtual-time model, retry policy and crash points)."""
    import dataclasses

    from repro_torch.faults import FaultPolicy

    return FaultPolicy(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(FaultPolicy)})


def lss(ref, port_fb):
    """A port `LSSSampler` over ``port_fb`` with the reference sampler's
    model (forest) and strata count."""
    from repro_torch.core.baselines import LSSSampler

    return LSSSampler(port_fb, forest(ref.model), int(ref.num_strata))


# --------------------------------------------------------------------------
# the LM substrate: the reference's param and cache pytrees
# --------------------------------------------------------------------------
def lm_tensor(a, device=None):
    """A torch tensor with ``a``'s bits.  JAX's bf16 arrives from
    `np.asarray` as ``ml_dtypes.bfloat16``, which `torch.from_numpy`
    rejects: it goes over as int16 and is viewed as bf16, never through
    an f32 rounding."""
    import torch

    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def _flat(tree, prefix=""):
    """(dotted name, leaf) over nested dicts and lists (the reference's
    ``params["lead"]`` is a list of layer dicts)."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _split_stacked(tree: dict, cfg) -> tuple[dict, dict]:
    """(``tree`` without ``slots`` and whisper's trees stacked along a
    leading layer axis, {the port's dotted name: (stacked subtree, its
    layer count)}): ``encoder.layers`` and ``cross``."""
    rest = {k: v for k, v in tree.items() if k not in ("slots", "cross")}
    stacked = {}
    if "encoder" in tree:
        rest["encoder"] = {k: v for k, v in tree["encoder"].items() if k != "layers"}
        stacked["encoder.layers"] = (tree["encoder"]["layers"], cfg.n_enc_layers)
    if "cross" in tree:
        stacked["cross"] = (tree["cross"], cfg.n_layers)
    return rest, stacked


def lm_params(ref_params, cfg, device=None):
    """The port's `LM` with the reference's weights, bit for bit (the f32
    leaves too: the router, and the recurrent blocks' ``lam``, ``a_log``,
    ``d_skip`` and ``dt_bias``).  The reference stacks pattern slot j's blocks along
    a unit axis (``params["slots"][j]``); unit u's slot j is the port's
    block ``u·period + j``.  Its ``params["lead"][i]`` is the port's
    ``lead.i``; whisper's stacked ``encoder.layers`` and ``cross`` trees
    unstack into ``encoder.layers.i`` and ``cross.i``."""
    from repro_torch.models import lm

    model = lm.LM(cfg, device=device)
    period = len(cfg.block_pattern)
    rest, stacked = _split_stacked(ref_params, cfg)
    state = {name: lm_tensor(a, device) for name, a in _flat(rest)}
    for j, slot in enumerate(ref_params["slots"]):
        for name, a in _flat(slot):
            a = np.asarray(a)
            for u in range(a.shape[0]):
                state[f"blocks.{u * period + j}.{name}"] = lm_tensor(a[u], device)
    for prefix, (tree, n) in stacked.items():
        for name, a in _flat(tree):
            for i in range(n):
                state[f"{prefix}.{i}.{name}"] = lm_tensor(np.asarray(a)[i], device)
    model.load_state_dict(state, strict=True)
    return model


def lm_cache(ref_cache, cfg, device=None):
    """The port's per-layer cache list from the reference's: the leading
    dense layers' (``cache["lead"]``) first, then the per-slot stacked
    ones (``cache["slots"][j][name][u]``, a ragged tail's padded slots
    included), each layer's dict with the reference's names and dtypes
    (``k``/``v``, MLA's ``ckv``/``kpe``, or the recurrent blocks' bf16
    ``conv`` ring and f32 ``rec``/``ssm`` state); whisper's decoder
    layer i also takes ``cross_k[i]``/``cross_v[i]`` of the reference's
    (n_layers, B, S_enc, K, hd) pair."""
    period = len(cfg.block_pattern)
    slots = ref_cache["slots"]
    n_units = np.asarray(next(iter(slots[0].values()))).shape[0]
    lead = [{name: lm_tensor(a, device) for name, a in c.items()}
            for c in ref_cache.get("lead", [])]
    out = lead + [{name: lm_tensor(np.asarray(a)[u], device) for name, a in slots[j].items()}
                  for u in range(n_units) for j in range(period)]
    for name in ("cross_k", "cross_v"):
        if name in ref_cache:
            for i, a in enumerate(np.asarray(ref_cache[name])):
                out[i][name] = lm_tensor(a, device)
    return out


def _map_arrays(tree, fn):
    """``fn`` over the arrays of a nested dict / tuple / list tree, the
    containers kept (an int8 state's ``(q, scale)`` pair stays a pair)."""
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_arrays(v, fn) for v in tree)
    return fn(np.asarray(tree))


def _lm_tree(ref_tree, cfg, device):
    """A tree over the reference's params structure (``slots`` stacked
    along the unit axis, whisper's ``encoder.layers`` and ``cross`` along
    the layer axis) in the port's `lm.param_tree` structure (a ``blocks``
    list in layer order, ``encoder.layers`` and ``cross`` lists)."""
    from repro_torch.models import lm

    period, n_units, _ = lm._units(cfg)

    def unstacked(tree, n):
        return [_map_arrays(tree, lambda a, i=i: lm_tensor(a[i], device)) for i in range(n)]

    rest, stacked = _split_stacked(ref_tree, cfg)
    out = {k: _map_arrays(v, lambda a: lm_tensor(a, device)) for k, v in rest.items()}
    slots = ref_tree["slots"]
    out["blocks"] = [_map_arrays(slots[j], lambda a, u=u: lm_tensor(a[u], device))
                     for u in range(n_units) for j in range(period)]
    for prefix, (tree, n) in stacked.items():
        parent, _, name = prefix.rpartition(".")
        (out[parent] if parent else out)[name] = unstacked(tree, n)
    return out


def train_state(ref_params, ref_opt_state, cfg, device=None):
    """The port's AdamW state (`repro_torch.train.optimizer`) from the
    reference's: the ``m``/``v`` trees, int8 ``(q, scale)`` pairs included,
    unstacked per block as `lm_params` unstacks ``params["slots"]``, and
    the int32 ``step``.  The trees follow `lm.param_tree` of
    ``lm_params(ref_params, cfg)``."""
    if set(ref_opt_state["m"]) != set(ref_params):
        raise ValueError(f"state keys {sorted(ref_opt_state['m'])} are not the params' "
                         f"{sorted(ref_params)}")
    return {"m": _lm_tree(ref_opt_state["m"], cfg, device),
            "v": _lm_tree(ref_opt_state["v"], cfg, device),
            "step": lm_tensor(np.asarray(ref_opt_state["step"]), device)}
