"""Multi-pod dry run: every (arch × applicable shape × mesh) cell traced
once with the production shardings, nothing allocated.

The reference's `repro.launch.dryrun` for the port.  Where the reference
lowers and compiles each cell for 256 or 512 fake XLA devices, the port
runs its own step function once (`train.steps.make_train_step`,
``make_prefill_step`` or ``make_serve_step``) over `DTensor`s on a
`DeviceMesh` of a fake process group of that size (`launch.mesh`), under
a `FakeTensorMode`: tensors have shapes and no memory, collectives return
at once.  `launch.op_stats` counts what rank 0 executes — its local
shards — and each cell becomes one JSON row for `launch.roofline`, with
the reference's keys:

  * ``memory``: ``argument_bytes`` (the local shards of the parameters,
    the optimizer state, the batch or the cache and tokens that the step
    reads or writes: one it never touches, such as whisper's encoder in a
    decode step, is left out, as ``jax.jit`` prunes an unused argument),
    ``output_bytes`` (the step's outputs), ``alias_bytes`` (outputs in
    the arguments' storage: the port updates the parameters, the state
    and the cache in place, where the reference donates them),
    ``temp_bytes`` and ``per_device_total`` = arguments + outputs + temp
    − aliases.  ``temp_bytes`` comes from the eager trace: the peak of
    live bytes beyond the arguments, less the outputs that are not
    aliases — so that the total is the arguments plus that peak.  It is
    the eager peak of this trace, not XLA's buffer assignment;
  * ``cost``: ``flops``, ``bytes_accessed``; ``collectives``:
    ``num_collectives`` (calls), ``link_bytes_total``, ``by_kind``;
    ``collective_ops_sample``; ``lower_s``, the trace's seconds;
  * ``microbatches`` (a train step): ``{"n": n, "traced": t}``.  A step
    of n > 2 microbatches runs two of them and counts the second n − 1
    times (`_scaled_microbatches`), as the reference's `hlo_stats`
    counts its microbatch scan's body by its trip count.

The reference's ``cost_analysis_raw`` (XLA's own cost analysis, which
counts a loop body once) and ``compile_s`` (XLA's compile) have no
counterpart and are not written.

Where `DTensor`'s rules cannot partition an op of the step, the trace
steers it (`_strategy_gaps`, `_LocalGaps`; `ROADMAP.md` § 3, "Two
partitioners"): the model modules run as they run on one card, the
optimizer slicing a leaf by the elements one device holds of it.

Each cell runs in a subprocess of its own (its fake process group never
meets another group), under ``--cell-timeout``; a failing or timed-out
cell is an ``error`` row and `main` exits 1.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape decode_32k --mesh single --device cpu

``--device`` is ``cuda`` by default (fake CUDA tensors on the card's
machine); ``cpu`` for the tests and a machine without a card.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import all_archs, get_config
from repro_torch.distributed import axes, sharding
from repro_torch.launch import op_stats
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import (fake_group, make_mesh, make_production_mesh,
                                     production_mesh_shape)
from repro_torch.models import lm
from repro_torch.models.config import SHAPES, applicable_shapes
from repro_torch.train import optimizer as opt
from repro_torch.train import steps as steps_mod
from repro_torch.train import tree


def mesh_label(shape: dict) -> str:
    return "x".join(str(v) for v in shape.values())


def _place(t: torch.Tensor, ns):
    """``t`` as a `DTensor` under ``ns`` (a `sharding.NamedSharding`); a
    dimension sharded over a mesh dimension of one rank is replicated
    there, which is the same layout.  On a mesh of one rank ``t`` stays a
    plain tensor: the rank holds and runs everything, and `DTensor` would
    only add its propagation (whose strategies some torch releases lack)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    if ns.mesh.size() == 1:
        return t
    placements = [Replicate() if ns.mesh.size(i) == 1 else p
                  for i, p in enumerate(ns.placements)]
    return distribute_tensor(t, ns.mesh, placements, src_data_rank=None)


def _place_tree(values, shardings):
    return tree.tree_map(lambda t, ns: _place(t, ns), values, shardings)


def _place_model(model: nn.Module, mesh) -> None:
    """Every parameter of ``model`` replaced by its `DTensor` under the
    parameter rules (`distributed.sharding.param_shardings`)."""
    shard = tree.flatten(sharding.param_shardings(lm.param_tree(model), mesh))
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(_place(p.detach(), shard[name.replace(".", "/")]),
                                        requires_grad=False))


def _locals(tree_) -> list:
    from torch.distributed.tensor import DTensor

    out = []
    for t in op_stats._tensors(tree_):
        out.append(t.to_local() if isinstance(t, DTensor) else t)
    return out


def _bytes_of(tensors, skip=()) -> int:
    """Bytes of the distinct storages of ``tensors``, those in ``skip``
    (a set of storage ids) left out."""
    seen = set(skip)
    total = 0
    for t in tensors:
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _select_reduces_masked(original):
    """`DTensor`'s ``select`` strategy, but an input that is a masked
    partial (a ``gather`` along a sharded dim: the CE's gold logit over
    vocab-sharded logits) is reduced first: `DTensor` would carry the
    partial through the select with the mask of the unselected shape,
    which its reduction then fails to apply."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy

    try:  # where torch 2.13 keeps it
        from torch.distributed.tensor.placement_types import _MaskPartial
    except ImportError:  # and earlier releases
        from torch.distributed.tensor._ops._embedding_ops import _MaskPartial

    def strategy(op_schema):
        out = OpStrategy([])
        for s in original(op_schema).strategies:
            spec_in = s.input_specs[0]
            masked = [isinstance(p, _MaskPartial) for p in spec_in.placements]
            if any(masked):
                spec_in = DTensorSpec(spec_in.mesh, tuple(
                    Replicate() if m else p for p, m in zip(spec_in.placements, masked)))
                spec_out = DTensorSpec(s.output_spec.mesh, tuple(
                    Replicate() if m else p
                    for p, m in zip(s.output_spec.placements, masked)))
                s = OpSpec(output_specs=spec_out, input_specs=(spec_in,))
            out.strategies.append(s)
        return out

    return strategy


def _rank0_shape(shape, placements, mesh) -> list:
    """Rank 0's shape of a tensor of global ``shape`` under ``placements``
    (each `Shard` splits its dim, the first ranks taking the ceiling);
    its offset in the global tensor is 0 on every dim."""
    from torch.distributed.tensor import Shard

    local = list(shape)
    for i, p in enumerate(placements):
        if type(p) is Shard:
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    return local


def _from_rank0(local, mesh, placements, shape):
    """``local`` as rank 0's shard of a contiguous `DTensor` of global
    ``shape`` under ``placements`` (no check, no collective)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=stride)


def _rank0_numel(shape, placements, mesh) -> int:
    """Rank 0's element count (`_rank0_shape`)."""
    return math.prod(_rank0_shape(shape, placements, mesh))


TP_AXIS = "model"  # the tensor-parallel mesh axis of `distributed.sharding`'s rules


def _fold(shape, target):
    """(i, j) where the view ``shape`` → ``target`` merges ``shape[i:j]``
    into ``target[i]`` (j − i ≥ 2), every other dim kept; else None."""
    shape, target = tuple(shape), tuple(target)
    if len(target) >= len(shape):
        return None
    i = next((k for k, (a, b) in enumerate(zip(shape, target)) if a != b), len(target))
    j = i + len(shape) - len(target) + 1
    if i >= len(target) or math.prod(shape[i:j]) != target[i] or shape[j:] != target[i + 1:]:
        return None
    return i, j


def _merged_placements(shape, placements, mesh, i, j):
    """The placements of the view that merges ``shape[i:j]`` into one dim,
    where two mesh dimensions or more shard those dims outer to inner in
    mesh order (batch over ``pod``/``data``, heads over ``model``: the
    attention's fold of (B, H) before its batched products), each dim
    evenly: the merged dim sharded over the same mesh dimensions, in the
    same order.  Rank 0 holds the same elements before and after, its
    local view, as XLA's partitioner keeps both shards through a dot's
    batch dims; `DTensor` would gather the inner shard (torch 2.11) or
    shard the merged dim strided (2.13).  What the placements claim rank 0
    holds is a relabelling of those rows: the counts (every op's local
    shape, every collective) are the same.  None where the case is
    another (`DTensor`'s own rule applies)."""
    from torch.distributed.tensor import Shard

    sharded = [(p.dim, k) for k, p in enumerate(placements)
               if type(p) is Shard and i <= p.dim < j]
    if len({d for d, _ in sharded}) < 2 and not any(d > i for d, _ in sharded):
        return None
    if [k for _, k in sorted(sharded)] != sorted(k for _, k in sharded):
        return None
    for d in {d for d, _ in sharded}:
        if shape[d] % math.prod(mesh.size(k) for dd, k in sharded if dd == d):
            return None
    if any(not (type(p) is Shard or p.is_replicate() or p.is_partial()) for p in placements):
        return None
    return tuple(Shard(i) if type(p) is Shard and i <= p.dim < j
                 else Shard(p.dim - (j - i - 1)) if type(p) is Shard and p.dim >= j else p
                 for p in placements)


def _split_placements(shape, placements, mesh, i, j):
    """The inverse of `_merged_placements`: a view that splits dim ``i``,
    which two mesh dimensions or more shard, into ``shape[i:j]``, each
    such mesh dimension given a factor it divides evenly — `TP_AXIS` the
    innermost (heads), every other the outermost (batch over ``pod`` and
    ``data``) — so that rank 0 keeps its elements.  None where no such
    assignment exists."""
    from torch.distributed.tensor import Shard

    ks = [k for k, p in enumerate(placements) if type(p) is Shard and p.dim == i]
    if len(ks) < 2:
        return None
    rem, to = list(shape[i:j]), {}
    for k in ks:
        inner = mesh.mesh_dim_names[k] == TP_AXIS
        order = range(len(rem) - 1, -1, -1) if inner else range(len(rem))
        f = next((f for f in order if rem[f] % mesh.size(k) == 0), None)
        if f is None:
            return None
        rem[f] //= mesh.size(k)
        to[k] = i + f
    return tuple(Shard(to[k]) if k in to
                 else Shard(p.dim + (j - i - 1)) if type(p) is Shard and p.dim > i else p
                 for k, p in enumerate(placements))


def _view_strategy(original):
    """``view``'s strategy (``original``), but a merge of dims that two
    mesh dimensions shard keeps both shards (`_merged_placements`), and
    the split back restores them (`_split_placements`): no collective,
    rank 0's local view.  Elsewhere the strategy is `DTensor`'s own."""
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy

    def kept(src, target):
        """The strategies that keep rank 0's elements in place, or None."""
        shape = tuple(src.shape)
        merge, split = _fold(shape, target), _fold(target, shape)
        out = OpStrategy([])
        for s in src.strategies:
            spec = s.output_spec
            if merge:
                placements = _merged_placements(shape, spec.placements, spec.mesh, *merge)
            elif split:
                placements = _split_placements(target, spec.placements, spec.mesh, *split)
            else:
                return None
            if placements is None or (_rank0_numel(shape, spec.placements, spec.mesh)
                                      != _rank0_numel(target, placements, spec.mesh)):
                return None
            out.strategies.append(OpSpec(
                output_specs=DTensorSpec(spec.mesh, placements),
                input_specs=(spec,),
                redistribute_cost=[[0.0 if t is s else math.inf for t in src.strategies]]))
        return out

    def strategy(op_schema):
        src = op_schema.args_schema[0]
        target = list(op_schema.args_schema[1])
        if -1 in target:
            target[target.index(-1)] = math.prod(src.shape) // -math.prod(target)
        own = kept(src, target)
        return own if own is not None else original(op_schema)

    return strategy


def _flip_strategy(op_schema):
    """``flip(x, dims)``: a mesh dimension that shards one of ``dims``
    replicates it first (a collective, counted); every other placement
    passes through, `Partial` (flip is linear) included.  torch 2.11 has
    no strategy for ``flip``, which autograd runs in ``cumsum``'s
    backward; 2.13's own shards only the unflipped dims too."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs
    from torch.distributed.tensor.placement_types import Partial, _StridedShard

    src = op_schema.args_schema[0]
    ndim = len(src.strategies[0].output_spec.shape)
    dims = {d % ndim for d in op_schema.args_schema[1]}

    def through(p):
        if isinstance(p, (Shard, _StridedShard)):
            return p.dim not in dims
        return not p.is_partial() or type(p) is Partial

    out = OpStrategy([])
    for s in src.strategies:
        spec = s.output_spec
        target = DTensorSpec(spec.mesh, tuple(p if through(p) else Replicate()
                                              for p in spec.placements))
        out.strategies.append(OpSpec(output_specs=target, input_specs=(target,),
                                     redistribute_cost=[generate_redistribute_costs(src, target)]))
    return out


# torch 2.13's single-dimension rules (`torch/distributed/tensor/_ops/
# _matrix_ops.py`, ``constant_pad_nd``; `_tensor_ops.py`, ``index.Tensor``
# and ``index_put``), which `_strategy_gaps` registers on every release:
# 2.11's own fail on the production meshes.  Each lists, for one mesh
# dimension, the placements [output, inputs...] the op computes under (a
# `_ShardingPlaceholder` a shard in the inputs' own kind; all-replicate is
# implied), and `DTensor` expands them over the mesh at the least
# redistribution cost.


def _pad_rule(op, args, kwargs):
    """``constant_pad_nd(x, pad, value)``: shards on unpadded dims pass
    through; a partial passes where the pad writes what its reduction
    keeps (sum only for a zero pad)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor._ops.single_dim_strategy import _ShardingPlaceholder as S

    ndim = len(args[0].shape)
    pad = args[1]
    padded = {ndim - 1 - i for i in range(len(pad) // 2) if pad[2 * i] or pad[2 * i + 1]}
    value = args[2] if len(args) > 2 else 0
    reduce_ops = ("sum", "avg", "max", "min") if not padded or value == 0 else ("avg", "max",
                                                                              "min")
    return ([[S(d), S(d)] for d in range(ndim) if d not in padded]
            + [[Partial(r), Partial(r)] for r in reduce_ops])


def _index_rule(op, args, kwargs):
    """``values[indices]``: the values sharded on a dim no index reads,
    the indices replicated; or the indices sharded alike on one dim of
    their broadcast shape, the values replicated; or a linear partial of
    the values, passed through."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._ops.single_dim_strategy import _ShardingPlaceholder as S

    values, indices = args
    indexed = [i for i, t in enumerate(indices) if t is not None]
    metas = [t for t in indices if t is not None]
    bdim = max(len(m.shape) for m in metas)
    consecutive = all(b - a == 1 for a, b in zip(indexed, indexed[1:]))
    insert = indexed[0] if consecutive else 0

    def out_dim(d):
        return d if d < insert else d + bdim - sum(1 for i in indexed if d > i)

    rules = [[S(out_dim(d)), S(d)] + [Replicate()] * len(indexed)
             for d in range(len(values.shape)) if d not in indexed]
    for bd in range(bdim):
        per = [(bd - (bdim - len(m.shape)), m.shape[bd - (bdim - len(m.shape))])
               if bd >= bdim - len(m.shape) else (-1, 1) for m in metas]
        if any(size > 1 for _, size in per):
            rules.append([S(bd + insert), Replicate()]
                         + [S(td) if size > 1 else Replicate() for td, size in per])
    return rules + [[Partial(r), Partial(r)] + [Replicate()] * len(indexed)
                    for r in ("sum", "avg")]


def _index_put_rule(op, args, kwargs):
    """``index_put(x, indices, values)``: ``x`` and ``values`` sharded
    alike on a dim no index reads (a size-1 broadcast dim of ``values``
    replicated), the indices replicated; or ``x``, ``values`` and the
    output partial sums.  (2.11's own strategy shards ``x`` on dim -1
    where ``values`` has more dims than ``x``: the embedding's backward.)"""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._ops.single_dim_strategy import _ShardingPlaceholder as S

    x, indices, values = args[:3]
    indexed = sorted(i for i, t in enumerate(indices) if t is not None)
    free = [d for d in range(len(x.shape)) if d not in indexed]
    shapes = [t.shape for t in indices if t is not None]
    bdim = len(torch.broadcast_shapes(*shapes)) if shapes else 0
    consecutive = len(indexed) <= 1 or indexed[-1] - indexed[0] + 1 == len(indexed)
    result_ndim = bdim + len(free)
    rules = []
    for i, d in enumerate(free):
        if consecutive and indexed:
            vd = d if d < indexed[0] else d - len(indexed) + bdim
        else:
            vd = bdim + i
        vd -= result_ndim - len(values.shape)
        vp = S(vd) if vd >= 0 and values.shape[vd] != 1 else Replicate()
        rules.append([S(d), S(d)] + [Replicate()] * len(indexed) + [vp])
    return rules + [[Partial(), Partial()] + [Replicate()] * len(indexed) + [Partial()]]


def _shard_to_partial_in_two(redistribute):
    """``redistribute`` (`DTensor`'s ``redistribute_local_tensor``), with
    a move of a shard to a partial sum on a mesh dimension made in two
    steps: the shard gathered first (an all-gather, counted), then
    ``redistribute`` on.  torch 2.11's propagator prices such a move and
    picks it (a residual gradient's ``add`` in llama3-405b's backward on
    2 × 16 × 16), and neither release's redistribution runs it; 2.13
    prices it out of reach, so there this never runs."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    def run(local, current, target, *args, **kwargs):
        whole = tuple(Replicate() if t.is_partial() and not (c.is_partial() or c.is_replicate())
                      else c for c, t in zip(current.placements, target.placements))
        if whole != tuple(current.placements):
            gathered = DTensorSpec(current.mesh, whole, tensor_meta=current.tensor_meta)
            local = redistribute(local, current, gathered, *args, **kwargs)
            current = gathered
        return redistribute(local, current, target, *args, **kwargs)

    return run


@contextlib.contextmanager
def _strategy_gaps():
    """The sharding strategies the step needs where `DTensor`'s own fail,
    registered for the trace and restored after it (the propagator's
    cache cleared on the way in and out):

    * ``view`` and ``_unsafe_view`` (the folds of a batched matmul):
      `DTensor`'s rule refuses a merge of dims whose inner one is sharded
      (torch 2.11), or shards the merged dim strided (2.13), which its
      planner then searches on a graph; here a merge of dims two mesh
      dimensions shard keeps both shards and its split back restores
      them (`_view_strategy`), and any other such view redistributes its
      input first, as ``reshape``'s rule does;
    * ``select`` of a masked partial: `_select_reduces_masked`;
    * ``flip``: `_flip_strategy`, in place of 2.13's single-dimension
      strategy (which 2.11 lacks, and which the propagator would consult
      first);
    * ``constant_pad_nd`` (the attention's pad to whole chunks), ``index``
      (the embedding's lookup) and ``index_put`` (its backward): 2.13's
      single-dimension rules (`_pad_rule`, `_index_rule`,
      `_index_put_rule`), the same as its own there.  2.11's strategy for
      the pad returns one placement on a mesh of two or three dimensions
      (its planner then indexes past it), its rule for ``index`` refuses
      an index whose dim two mesh dimensions shard (the batch over
      ``pod`` and ``data``), and its ``index_put`` shards on dim -1;
    * a redistribution's move of a shard to a partial sum:
      `_shard_to_partial_in_two`;
    * ``detach_``, which an autograd function's output meets when the dry
      run redistributes below autograd (`_LocalGaps`): torch 2.13's own
      strategy (the input's placements kept), which 2.11 lacks."""
    from torch.distributed.tensor import DTensor, _dispatch, _redistribute
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops
    from torch.distributed.tensor._ops._tensor_ops import propagate_single_input_strategy
    from torch.distributed.tensor._ops.single_dim_strategy import _SingleDimStrategyInfo

    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    views = (aten.view.default, aten._unsafe_view.default)
    rules = {aten.constant_pad_nd.default: (_pad_rule, RuntimeSchemaInfo(1)),
             aten.index.Tensor: (_index_rule, RuntimeSchemaInfo(needs_pytree=True)),
             **{op: (_index_put_rule, RuntimeSchemaInfo(needs_pytree=True))
                for op in (aten.index_put.default, aten.index_put_.default,
                           aten._index_put_impl_.default)}}
    tables = (prop.op_strategy_funcs, prop.op_to_schema_info,
              prop.op_single_dim_strategy_funcs, prop.op_to_schema_info_for_single_dim_strategy)
    saved = {op: [t.get(op) for t in tables]
             for op in (*views, aten.select.int, aten.flip.default, aten.detach_.default, *rules)}
    prop.propagate_op_sharding.cache.cache_clear()  # no sharding from before the trace
    runs = (_dispatch, _redistribute)  # each binds its own name of the function
    redistribute = _redistribute.redistribute_local_tensor
    try:
        for module in runs:
            module.redistribute_local_tensor = _shard_to_partial_in_two(redistribute)
        for op in views:
            _view_ops.register_op_strategy_map(op, torch.Tensor.view,
                                               schema_info=RuntimeSchemaInfo(1),
                                               strict_view=False)
            prop.op_strategy_funcs[op] = _view_strategy(prop.op_strategy_funcs[op])
        prop.register_op_strategy(aten.select.int,
                                  _select_reduces_masked(saved[aten.select.int][0]),
                                  saved[aten.select.int][1])
        if aten.detach_.default not in prop.op_strategy_funcs:
            prop.register_op_strategy(aten.detach_.default, propagate_single_input_strategy)
        prop.op_single_dim_strategy_funcs.pop(aten.flip.default, None)
        prop.register_op_strategy(aten.flip.default, _flip_strategy, RuntimeSchemaInfo(1))
        for op, (rule, info) in rules.items():
            prop.op_strategy_funcs.pop(op, None)
            prop.register_single_dim_op_strategy(op, _SingleDimStrategyInfo(rule), info)
        yield
    finally:
        for op, entries in saved.items():
            for table, entry in zip(tables, entries):
                if entry is None:
                    table.pop(op, None)
                else:
                    table[op] = entry
        for module in runs:
            module.redistribute_local_tensor = redistribute
        prop.propagate_op_sharding.cache.cache_clear()


_DOT_DIMS = {  # (lhs batch, lhs free, lhs contracted, rhs batch, rhs contracted, rhs free)
    2: (None, 0, 1, None, 0, 1),
    3: (0, 1, 2, 0, 1, 2),
}


def _dot_placements(a, b):
    """The placements a matmul-family product's operands ``a`` and ``b``
    (`DTensor`s of 2 or 3 dims) are brought to before it runs: on each
    mesh dimension the operands' own shards are kept where they pair, as
    XLA's dot partitioner keeps them — batch with batch, contracted with
    contracted (a partial sum out), a free dim with the other operand
    replicated — and a replicated operand is sliced to pair with the
    other's shard (no collective).  Where the two disagree, one is moved:
    off `TP_AXIS` a free dim's shard is kept, the left operand's where
    both are sharded, and the other operand gathered (an FSDP weight: the
    activation's rows stay where they are); over `TP_AXIS` the right
    operand's free shard where both are sharded (the activation's sequence
    shard gathered before a column-parallel weight, as Megatron's sequence
    parallelism does), else the smaller operand moves; a batch dim's shard
    is kept but where the operand it shards is the smaller (a decode
    step's query beside its cache's head-dim shard: the query moves, the
    cache stays).  A product both operands hold whole over a mesh
    dimension is split there only as `split` says, and only evenly: a
    dim the mesh dimension does not divide (a weight width, as mamba2's
    in-projection's 3352; heads, as whisper's 12) stays whole, as XLA
    leaves it.  A partial-sum operand is reduced to the shard its partner
    pairs with (a reduce-scatter; an all-reduce where the partner shards
    its free dim, or where the mesh dimension does not divide the dim a
    reduce-scatter would shard).  `DTensor`'s own choice is the cheapest
    redistribution with compute free, and so runs a product whole on
    every rank rather than move an activation (a partial gradient times
    a replicated weight, or both gathered)."""
    from torch.distributed.tensor import Replicate, Shard

    ab, af, ac, bb, bc, bf = _DOT_DIMS[a.ndim]
    mesh = a.device_mesh
    roles_a = {ab: "batch", af: "free", ac: "contract"}
    roles_b = {bb: "batch", bc: "contract", bf: "free"}
    dim_a = {v: k for k, v in roles_a.items()}
    dim_b = {v: k for k, v in roles_b.items()}
    # the elements each operand holds: a weight broadcast over a batch
    # holds one matrix
    a_bytes, b_bytes = (math.prod(n for n, st in zip(t.shape, t.stride()) if st)
                        for t in (a, b))

    def role(p, roles):
        if type(p) is Shard:
            return roles.get(p.dim, "other")
        if p.is_replicate():
            return "R"
        return "P" if p.is_partial() else "other"

    def pair(ra, rb, k):
        if ra == "other":
            ra = "P" if a.placements[k].is_partial() else "R"
        if rb == "other":
            rb = "P" if b.placements[k].is_partial() else "R"
        if ra == "P" and rb == "P":
            if ab is not None and even(a, ab, k) and even(b, bb, k):
                return "batch", "batch"
            return ("free" if ab is None and even(a, af, k) else "R"), "R"
        if ra == "P":
            return {"batch": "batch", "contract": "contract", "free": "R",
                    "R": own(a, ab, af, k)}[rb], rb
        if rb == "P":
            return ra, {"batch": "batch", "contract": "contract", "free": "R",
                        "R": own(b, bb, bf, k)}[ra]
        if "batch" in (ra, rb):
            other, small = (rb, a_bytes < b_bytes) if ra == "batch" else (ra, b_bytes < a_bytes)
            if other in ("contract", "free") and small:  # the smaller operand moves
                return (("contract", "contract") if other == "contract"
                        else ("R", "free") if ra == "batch" else ("free", "R"))
            return "batch", "batch"
        if ra == rb == "R":
            return split(k)
        if ra == rb != "free":
            return ra, rb  # contracted with contracted
        if "R" in (ra, rb):
            if ra == "contract" or rb == "contract":
                return "contract", "contract"
            return ra, rb  # a free dim beside a replicated operand
        if mesh.mesh_dim_names[k] != TP_AXIS and "free" in (ra, rb):
            return ("free", "R") if ra == "free" else ("R", "free")
        if ra == "free" and rb == "free":
            return "R", "free"
        if a_bytes >= b_bytes:
            return ra, "R" if ra == "free" else "contract"
        return "R" if rb == "free" else "contract", rb

    def even(t, d, k):
        """Whether mesh dimension ``k`` divides dim ``d`` of ``t`` evenly,
        beside the other mesh dimensions that shard it."""
        rest = math.prod(mesh.size(j) for j, p in enumerate(t.placements)
                         if j != k and type(p) is Shard and p.dim == d)
        return t.shape[d] % (rest * mesh.size(k)) == 0

    def split(k):
        """A product both operands hold whole over ``k``: over `TP_AXIS`,
        split over the right operand's columns, else the left operand's
        rows, where ``k`` divides them evenly (XLA shards such a product's
        output as its consumers are sharded: the SSD's in-projection, whose
        weight the rules leave whole, or a head whose vocab 16 does not
        divide); whole where ``k`` divides neither, off `TP_AXIS` (a batch
        the data axes do not divide stays whole there, as XLA keeps
        llama3-405b's 16-row microbatch over ``pod``), and for a batched
        product of two activations, whose batch folds dims the product
        cannot see (heads that ``k`` does not divide keep the attention
        whole).  A batched product whose right operand is one matrix
        broadcast over the batch (a 3-dim activation times a weight) is a
        2-dim one."""
        if mesh.mesh_dim_names[k] != TP_AXIS or (ab is not None and b.stride(bb) != 0):
            return "R", "R"
        sides = [("R", "free", b, bf), ("free", "R", a, af)]
        return next(((ta, tb) for ta, tb, t, d in sides if even(t, d, k)), ("R", "R"))

    def own(t, batch, free, k):
        """The shard a partial sum beside a replicated partner is reduced
        to: its batch, else its free dim, where ``k`` divides it; else
        whole (an all-reduce)."""
        d = batch if batch is not None else free
        return ("batch" if batch is not None else "free") if even(t, d, k) else "R"

    def place(r, dims):
        return Replicate() if r == "R" else Shard(dims[r])

    ta, tb = [], []
    for k in range(mesh.ndim):
        ra, rb = pair(role(a.placements[k], roles_a), role(b.placements[k], roles_b), k)
        ta.append(place(ra, dim_a))
        tb.append(place(rb, dim_b))
    return tuple(ta), tuple(tb)


_NEW_FACTORIES = {torch.ops.aten.new_empty.default, torch.ops.aten.new_zeros.default,
                  torch.ops.aten.new_ones.default, torch.ops.aten.new_full.default}


class _LocalGaps(TorchDispatchMode):
    """The ops of the step that the dry run runs its own way, each
    computing what the op computes:

    * a matmul-family product over `DTensor`s (``mm``, ``bmm`` and their
      ``add`` forms): its operands redistributed first to
      `_dot_placements`, so that `DTensor` runs it where it then needs no
      collective;
    * the backward of a ``gather`` along a dim its input shards (the CE's
      gold logit over vocab-sharded logits): autograd's ``new_zeros`` of
      the input's shape takes the input's placements (`DTensor` gives a
      new shape replicated: the whole-vocab logits on every rank; any
      other ``new_*`` factory of a new shape keeps its input's shards of
      the dims it keeps, `_new_factory`), and the ``scatter_add`` into it
      runs on each rank's shard, the indices outside it masked (`DTensor`
      would gather the shards first), as XLA partitions the gather's
      transpose;
    * the embedding's lookup (``index`` of a table whose vocab is
      sharded) on each rank's rows (`_lookup`), and its backward likewise:
      its ``new_zeros`` takes the table's placements and the accumulating
      ``index_put`` runs on each rank's rows (`_index_put`);
    * ``logsumexp`` over a `DTensor` as its parts (a max, an exp, a sum
      and a log), each on the shards: `DTensor`'s own gathers a sharded
      reduced dim (the CE's vocab) first, where XLA reduces the max and
      the sum across the shards;
    * ``select`` of one index of a sharded dim on the rank that holds it
      (`_select`);
    * ``bincount(ids, minlength=n)`` as a scatter-add into ``n`` zeros.
      A fake tensor cannot know a length that depends on the data, and
      the step's ids (experts) are all below ``n``, so the counts are
      the same.  `DTensor` has no strategy for ``bincount``: over a
      `DTensor` the ids are gathered (an all-gather, counted) and every
      rank counts them all;
    * an in-place ``scatter_`` into a sharded `DTensor` (the MoE's
      position scatter into an ``empty_like`` of the sharded ids), which
      `DTensor` refuses since its strategy must change the target's
      placement: the out-of-place ``scatter``, its result redistributed
      to the target's placement and copied into it.

    Every other op passes through."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        aten = torch.ops.aten
        if func in op_stats._DOTS:
            return func(*self._dot_operands(func, args), **kwargs)
        from torch.distributed.tensor import DTensor

        if func is aten.logsumexp.default and isinstance(args[0], DTensor):
            return self._logsumexp(*args, **kwargs)
        if func in (aten.gather.default, aten.index.Tensor) and isinstance(args[0], DTensor):
            self._gathered[tuple(args[0].shape)] = args[0].placements
            if func is aten.index.Tensor:
                out = self._lookup(*args)
                if out is not None:
                    return out
        elif (func is aten.index_put.default and isinstance(args[0], DTensor)
              and (args[3] if len(args) > 3 else kwargs.get("accumulate", False))):
            out = self._index_put(*args[:3])
            if out is not None:
                return out
        elif func in _NEW_FACTORIES and isinstance(args[0], DTensor):
            out = self._new_factory(func, args, kwargs)
            if out is not None:
                return out
        elif func is aten.scatter_add.default and isinstance(args[0], DTensor):
            out = self._scatter_add(*args)
            if out is not None:
                return out
        elif func is aten.select.int and isinstance(args[0], DTensor):
            out = self._select(*args)
            if out is not None:
                return out
        if func is aten.bincount.default:
            ids, weights, n = (list(args) + [None, 0])[:3]
            if weights is None and n:
                return self._bincount(ids, n)
        elif func is aten.scatter_.src and not kwargs and isinstance(args[0], DTensor):
            return self._scatter_(*args)
        return func(*args, **kwargs)

    def __init__(self):
        super().__init__()
        self._gathered: dict[tuple, tuple] = {}  # a gather input's shape → its placements
        self.factory_bytes = 0  # rank 0's bytes `_new_factory` kept off: whole less shard

    def _new_factory(self, func, args, kwargs):
        """``like.new_zeros(shape)`` (``new_empty``, ``new_ones``,
        ``new_full``) of another shape than ``like``: the placements of the
        ``gather`` or lookup input of that shape (autograd's zeros for its
        backward), else, where ``shape`` is ``like``'s with dims resized or
        trailing dims dropped, ``like``'s shards of the dims whose size it
        keeps (`rglru._interleave`'s doubled sequence, the attention's
        accumulators made from its query block); `DTensor` replicates a
        new shape whole on every rank.  None where the shape is ``like``'s
        (`DTensor`'s own rule keeps its placements) or no shard is kept.
        Rank 0's bytes so kept off count in ``factory_bytes``."""
        from torch.distributed.tensor import Replicate, Shard

        like, shape = args[0], tuple(args[1])
        if shape == tuple(like.shape):
            return None
        mesh = like.device_mesh
        placements = self._gathered.get(shape) if func is torch.ops.aten.new_zeros.default \
            else None
        if placements is None:
            if len(shape) > like.ndim:
                return None
            placements = tuple(p if type(p) is Shard and p.dim < len(shape)
                               and shape[p.dim] == like.shape[p.dim]
                               else Replicate() for p in like.placements)
        if all(p.is_replicate() for p in placements):
            return None
        local = func(like.to_local(), _rank0_shape(shape, placements, mesh), *args[2:],
                     **kwargs)
        self.factory_bytes += (math.prod(shape) - local.numel()) * local.element_size()
        return _from_rank0(local, mesh, placements, shape)

    @staticmethod
    def _lookup(table, indices):
        """``table[ids]`` where ``ids`` index dim 0 alone (the embedding's
        lookup): where mesh dimensions shard dim 0, each rank looks its ids
        up in its rows, those outside masked to zeros, and the partial sums
        are all-reduced there; the ids keep their batch shard, and a table
        dim sharded where the ids are (a feature dim over ``data``) is
        gathered first (FSDP), as XLA partitions the gather; None
        elsewhere.  `DTensor`'s rule
        gathers the sharded vocab instead (every rank holds the whole
        table), or gathers the ids to keep the table's feature shard (the
        activations then sharded over their features)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh, placements = table.device_mesh, table.placements
        if (len(indices) != 1 or not isinstance(indices[0], DTensor)
                or not all(type(p) is Shard or p.is_replicate() for p in placements)
                or not all(type(p) is Shard or p.is_replicate()
                           for p in indices[0].placements)):
            return None
        ids = indices[0]
        lead = ids.ndim
        vocab = [type(p) is Shard and p.dim == 0 for p in placements]
        id_pl = tuple(Replicate() if v else p for v, p in zip(vocab, ids.placements))
        tab_pl = tuple(p if v or type(q) is not Shard else Replicate()
                       for v, p, q in zip(vocab, placements, id_pl))
        out_pl = tuple(Partial() if v else q if type(q) is Shard
                       else Shard(p.dim - 1 + lead) if type(p) is Shard else Replicate()
                       for v, p, q in zip(vocab, tab_pl, id_pl))
        local_ids = ids.redistribute(mesh, id_pl).to_local()
        rows = table.redistribute(mesh, tab_pl).to_local()
        inside = (local_ids >= 0) & (local_ids < rows.shape[0])  # rank 0's rows start at 0
        got = rows[local_ids.clamp(0, max(rows.shape[0] - 1, 0))]
        got = torch.where(inside.view(*inside.shape, *[1] * (got.ndim - lead)), got,
                          torch.zeros_like(got))
        got = _from_rank0(got, mesh, out_pl, (*ids.shape, *table.shape[1:]))
        return got.redistribute(mesh, tuple(Replicate() if v else p
                                            for v, p in zip(vocab, out_pl)))

    @staticmethod
    def _index_put(target, indices, values):
        """``target.index_put(indices, values, accumulate=True)`` where
        ``indices`` index dim 0 alone (the embedding's backward) and mesh
        dimensions shard it: each rank scatters into its shard of dim 0,
        the ids outside it masked, keeping the ids' batch shard (a partial
        sum there, reduced to ``target``'s placements after); None
        elsewhere."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh, placements = target.device_mesh, target.placements
        if (len(indices) != 1 or not isinstance(indices[0], DTensor)
                or not any(type(p) is Shard and p.dim == 0 for p in placements)
                or not all(type(p) is Shard or p.is_replicate() for p in placements)):
            return None
        ids = indices[0]
        lead = ids.ndim
        batch = [type(p) is Shard and p.dim == 0 and not (type(t) is Shard and t.dim == 0)
                 for p, t in zip(ids.placements, placements)]
        id_pl = tuple(Shard(0) if b else Replicate() for b in batch)
        val_pl = tuple(Shard(0) if b else Shard(t.dim - 1 + lead) if type(t) is Shard
                       and t.dim > 0 else Replicate() for b, t in zip(batch, placements))
        out_pl = tuple(Partial() if b else t for b, t in zip(batch, placements))
        ids = ids.redistribute(mesh, id_pl).to_local()
        vals = values.redistribute(mesh, val_pl).to_local()
        shape = _rank0_shape(target.shape, out_pl, mesh)
        inside = (ids >= 0) & (ids < shape[0])  # rank 0's shard of dim 0 starts at 0
        local = vals.new_zeros(shape).index_put(
            (ids.clamp(0, max(shape[0] - 1, 0)),),
            torch.where(inside.view(*inside.shape, *[1] * (vals.ndim - lead)), vals,
                        torch.zeros_like(vals)), True)
        return target + _from_rank0(local, mesh, out_pl, target.shape).redistribute(
            mesh, placements)

    @staticmethod
    def _select(x, dim, index):
        """``x.select(dim, index)`` where mesh dimensions shard ``dim`` (the
        prefill's last position of sequence-sharded logits): the rank that
        holds ``index`` selects it, the others give zeros, and the partial
        sums are all-reduced there; None elsewhere.  `DTensor` gathers the
        whole dim first."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        dim %= x.ndim
        mesh, placements = x.device_mesh, x.placements
        if not any(type(p) is Shard and p.dim == dim for p in placements) or not all(
                type(p) is Shard or p.is_replicate() for p in placements):
            return None
        local = x.to_local()
        index %= x.shape[dim]
        got = local.select(dim, min(index, local.shape[dim] - 1))  # rank 0's rows start at 0
        if index >= local.shape[dim]:
            got = torch.zeros_like(got)
        held = tuple(Partial() if type(p) is Shard and p.dim == dim
                     else Shard(p.dim - (p.dim > dim)) if type(p) is Shard else p
                     for p in placements)
        got = _from_rank0(got, mesh, held, x.shape[:dim] + x.shape[dim + 1:])
        return got.redistribute(mesh, tuple(Replicate() if p.is_partial() else p for p in held))

    @staticmethod
    def _logsumexp(x, dim, keepdim=False):
        """``logsumexp(x, dim, keepdim)`` as torch computes it: the max
        taken out (0 where it is infinite), its exps summed."""
        m = torch.amax(x, dim, keepdim=True)
        m = torch.where(m.isinf(), torch.zeros_like(m), m)
        out = torch.log(torch.sum(torch.exp(x - m), dim, keepdim=True)) + m
        if not keepdim:  # one dim at a time: torch 2.11 has no strategy for squeeze.dims
            for d in sorted((d % x.ndim for d in dim), reverse=True):
                out = out.squeeze(d)
        return out

    @staticmethod
    def _scatter_add(target, dim, index, src):
        """``target.scatter_add(dim, index, src)`` on each rank's shard of
        ``target`` where mesh dimensions shard ``dim``; None elsewhere."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        dim %= target.ndim
        mesh, placements = target.device_mesh, target.placements
        if not any(type(p) is Shard and p.dim == dim for p in placements):
            return None
        if not all(type(p) is Shard or p.is_replicate() for p in placements):
            return None
        pair = tuple(Replicate() if type(p) is Shard and p.dim == dim else p
                     for p in placements)
        index, src = (t.redistribute(mesh, pair).to_local() if isinstance(t, DTensor) else t
                      for t in (index, src))
        local = target.to_local()
        inside = (index >= 0) & (index < local.shape[dim])  # rank 0's shard starts at 0
        out = local.scatter_add(dim, index.clamp(0, max(local.shape[dim] - 1, 0)),
                                torch.where(inside, src, torch.zeros_like(src)))
        return _from_rank0(out, mesh, placements, target.shape)

    @staticmethod
    def _dot_operands(func, args):
        from torch.distributed.tensor import DTensor

        at = 1 if func in (torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default) else 0
        a, b = args[at:at + 2]
        if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
            return args
        ta, tb = _dot_placements(a, b)
        a, b = (t if tuple(t.placements) == p else _LocalGaps._moved(t, p)
                for t, p in ((a, ta), (b, tb)))
        return (*args[:at], a, b, *args[at + 2:])

    @staticmethod
    def _moved(t, placements):
        """``t`` redistributed to ``placements``; a matrix ``t`` broadcasts
        over its batch (dim 0 of stride 0: a weight ``matmul`` expanded
        beside a 3-dim activation) moves as the matrix, then broadcast
        again and sliced (`DTensor` would move, and so materialize, every
        copy)."""
        from torch.distributed.tensor import Replicate, Shard

        if t.ndim != 3 or t.stride(0) != 0:
            return t.redistribute(t.device_mesh, placements)
        whole = tuple(Replicate() if type(p) is Shard and p.dim == 0
                      else Shard(p.dim - 1) if type(p) is Shard else p for p in placements)
        matrix = t.select(0, 0).redistribute(t.device_mesh, whole)
        return matrix.unsqueeze(0).expand(t.shape).redistribute(t.device_mesh, placements)

    @staticmethod
    def _bincount(ids, n):
        from torch.distributed.tensor import DTensor, Replicate

        def count(local):
            return torch.zeros((n,), dtype=torch.int64, device=local.device).scatter_add_(
                0, local, torch.ones_like(local))

        if not isinstance(ids, DTensor):
            return count(ids)
        mesh = ids.device_mesh
        whole = [Replicate()] * mesh.ndim
        local = ids.redistribute(mesh, whole).to_local()
        return DTensor.from_local(count(local), mesh, whole, run_check=False)

    @staticmethod
    def _scatter_(target, *rest):
        out = torch.scatter(target, *rest)
        out = out.redistribute(target.device_mesh, target.placements)
        target.to_local().copy_(out.to_local())
        return target


def _scaled_microbatches(*counters):
    """A train step's ``microbatches`` (`train.steps.make_grad_fn`) that
    runs the first two of ``n``: the first counted once, the second
    ``n − 1`` times by ``counters`` (`op_stats.scaled`).  Every later
    microbatch runs as the second does, at the same shapes and with the
    same carry: the first differs by its carry's first layout (the loss
    sum's zeros, a plain tensor, become a partial sum there: a ``div``),
    where XLA's scan holds the carry to one layout from the first trip.
    The accumulators' allocation before them and the division and the
    update after them count once; the peak of live bytes is the most of
    the two, which the later trips repeat."""

    def microbatches(n):
        yield 0
        with op_stats.scaled(n - 1, *counters):
            yield 1

    return microbatches


def _run_step(cfg, shape, mesh, device, audit, topts=None, scale_microbatches=True):
    """Builds the cell's inputs (``shape``, a `ShapeSpec`) on ``mesh`` and
    runs its step once under `op_stats.OpStats` and ``audit``, an
    `op_stats.DotAudit` above it → (stats, arguments, outputs, seconds,
    microbatches, the bytes `_LocalGaps` kept off rank 0's factories).  ``topts`` replaces a train step's
    `TrainOptions` (`train.steps.dryrun_train_options`'s by default);
    with ``scale_microbatches`` a step of n > 2 microbatches runs two of
    them, the second counted n − 1 times (`_scaled_microbatches`).
    ``microbatches`` is
    ``{"n": n, "traced": the microbatches run}`` for a train step, else
    None."""
    from torch.distributed.tensor.experimental import implicit_replication

    kind = shape.kind
    model = lm.LM(cfg, device=device)  # no generator: nothing is drawn
    ins = specs_mod.input_specs(cfg, shape, device)
    micro = None
    if kind == "train":
        state_dtype, default_topts = steps_mod.dryrun_train_options(cfg)
        topts = topts or default_topts
        n = topts.num_microbatches
        micro = {"n": n, "traced": min(n, 2) if scale_microbatches else n}
        ocfg = opt.AdamWConfig(state_dtype=state_dtype)
        ostate = opt.init_state(ocfg, lm.param_tree(model))
        ostate = _place_tree(ostate, sharding.param_shardings(ostate, mesh))
    _place_model(model, mesh)
    params = lm.param_tree(model)
    if kind == "decode":
        cache = _place_tree(ins["cache"], sharding.cache_shardings(ins["cache"], cfg, mesh))
        tokens = _place_tree(ins["tokens"], sharding.data_shardings(ins["tokens"], mesh))
        args = (params, cache, tokens)
    else:
        batch = _place_tree(ins["batch"], sharding.data_shardings(ins["batch"], mesh))
        args = (params, ostate, batch) if kind == "train" else (params, batch)
    stats = op_stats.OpStats(arguments=_locals(args))
    gaps = _LocalGaps()
    t0 = time.time()
    with contextlib.ExitStack() as modes:
        for ctx in (implicit_replication(), _strategy_gaps(), stats, audit, gaps):
            modes.enter_context(ctx)
        if kind == "train":
            loop = _scaled_microbatches(stats, audit) if micro["traced"] < n else range
            step = steps_mod.make_train_step(cfg, ocfg, topts, loop)
            _, ostate, metrics = step(model, ostate, batch)
            outs = (params, ostate, metrics)
        elif kind == "prefill":
            with torch.no_grad():
                outs = steps_mod.make_prefill_step(cfg)(model, batch)
        else:
            with torch.no_grad():
                outs = steps_mod.make_serve_step(cfg)(model, cache, tokens, ins["pos"])
    return stats, args, outs, time.time() - t0, micro, gaps.factory_bytes


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *, mesh=None,
               device: str = "cuda", verbose: bool = True, spec=None, cfg=None,
               topts=None, audit: bool = False, scale_microbatches: bool = True) -> dict:
    """One cell's row.  ``mesh`` is an ``{axis: size}`` mapping (the
    production mesh of ``multi_pod`` by default); the cell runs on a fake
    process group of its size, made and destroyed here.  ``spec``, a
    `ShapeSpec`, replaces ``SHAPES[shape_name]`` (a step at another
    batch or length, named ``shape_name``); ``cfg`` replaces
    ``get_config(arch)`` and ``topts`` a train step's `TrainOptions`.
    ``cost["step_flops"]`` is the whole step's FLOPs, from global shapes
    (`op_stats.DotAudit`'s ``global_flops``: one rank's count of a
    one-rank mesh); ``audit`` adds the audit's summary under ``"audit"``.
    ``factory_bytes`` is what `_LocalGaps` kept off rank 0's new
    buffers, each made on its shard rather than whole.  ``torch`` is the version that traced it: `DTensor`
    partitions apart from one release to the next.  A train step of n > 2
    microbatches traces two and counts the second n − 1 times, as the
    reference's `hlo_stats` counts its scan's body by the trip count
    (`_scaled_microbatches`; ``scale_microbatches=False`` traces all n);
    a train row records ``"microbatches": {"n": n, "traced": ...}``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    cfg = cfg or get_config(arch)
    sizes = dict(mesh) if mesh is not None else production_mesh_shape(multi_pod)
    shape = spec or SHAPES[shape_name]
    n = math.prod(sizes.values())
    cell = {
        "arch": arch, "shape": shape_name, "kind": shape.kind, "mesh": mesh_label(sizes),
        "devices": n, "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "torch": torch.__version__,
    }
    dots = op_stats.DotAudit()
    with fake_group(n):
        dmesh = (make_mesh(sizes, device) if mesh is not None
                 else make_production_mesh(multi_pod, device))
        axes.set_logical_axes(dmesh.mesh_dim_names)
        try:
            with FakeTensorMode(shape_env=ShapeEnv()):
                stats, args, outs, secs, micro, factory_bytes = _run_step(
                    cfg, shape, dmesh, device, dots, topts, scale_microbatches)
                arg_locals, out_locals = _locals(args), _locals(outs)
                arg_ids = {id(t.untyped_storage()) for t in arg_locals}
                argument_bytes = _bytes_of(
                    [t for t in arg_locals if id(t.untyped_storage()) in stats.touched])
                output_bytes = _bytes_of(out_locals)
                fresh = _bytes_of(out_locals, skip=arg_ids)
                alias_bytes = output_bytes - fresh
                temp_bytes = stats.peak_live_bytes - fresh
                full = stats.summary()
        finally:
            axes.set_logical_axes(())
    cell["lower_s"] = round(secs, 2)
    if micro is not None:
        cell["microbatches"] = micro
    cell["memory"] = {
        "argument_bytes": argument_bytes, "output_bytes": output_bytes,
        "temp_bytes": temp_bytes, "alias_bytes": alias_bytes,
        "per_device_total": argument_bytes + output_bytes + temp_bytes - alias_bytes,
    }
    cell["cost"] = {"flops": full["flops"], "bytes_accessed": full["hbm_bytes"],
                    "step_flops": dots.global_flops}
    cell["factory_bytes"] = factory_bytes
    cell["collectives"] = {k: full[k] for k in ("num_collectives", "link_bytes_total",
                                                "by_kind")}
    ops_sorted = sorted(full["ops"], key=lambda o: -o["link_bytes"])
    cell["collective_ops_sample"] = [
        {k: o[k] for k in ("op", "bytes", "group", "mult", "link_bytes")}
        for o in ops_sorted[:10]
    ]
    if audit:
        cell["audit"] = dots.summary()
    if verbose:
        print(f"[{cell['arch']} × {cell['shape']} × {cell['mesh']}] "
              f"trace={cell['lower_s']}s flops/dev={cell['cost']['flops']:.3g} "
              f"mem/dev={cell['memory']['per_device_total'] / 2**30:.2f}GiB "
              f"coll_bytes/dev={cell['collectives']['link_bytes_total']:.3g}", flush=True)
    return cell


# The reference's own grid (`tools/dryrun_reference.py`: `repro.launch.
# dryrun.lower_cell` of every cell, lowered for 256 or 512 fake XLA
# devices), read as data: the port never imports JAX.
REFERENCE_ROWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                              os.pardir, os.pardir, "results", "dryrun_reference.json")


def reference_rows(path: str = REFERENCE_ROWS) -> dict:
    """{(arch, shape, mesh): the reference's row} of a reference grid."""
    with open(path) as f:
        return {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}


def against_reference(row: dict, ref: dict) -> dict:
    """The port's row over the reference's: FLOPs, link bytes and memory a
    device."""

    def ratio(a, b):
        return a / b if b else (1.0 if a == b else math.inf)

    return {"flops": ratio(row["cost"]["flops"], ref["cost"]["flops"]),
            "link_bytes": ratio(row["collectives"]["link_bytes_total"],
                                ref["collectives"]["link_bytes_total"]),
            "memory": ratio(row["memory"]["per_device_total"],
                            ref["memory"]["per_device_total"])}


def _one(argv) -> int:
    """``--cell ARCH SHAPE MESH``: one cell in this process; its row (or
    its error) is the last line of the output."""
    arch, shape_name, mesh_name = argv.cell
    try:
        row = lower_cell(arch, shape_name, mesh_name == "2x16x16", device=argv.device)
    except Exception as e:  # a failing cell is a bug — record it
        traceback.print_exc()
        row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"{type(e).__name__}: {e}"}
    print(json.dumps(row), flush=True)
    return 1 if "error" in row else 0


def _subprocess_cell(key, device: str, timeout: float) -> dict:
    arch, shape_name, mesh_name = key
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell", arch, shape_name,
           mesh_name, "--device", device]
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "error": f"TimeoutError: no row within {timeout:.0f} s",
                "wall_s": round(time.time() - t0, 2)}
    lines = r.stdout.strip().splitlines()
    try:
        row = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "error": f"exit {r.returncode}: {r.stderr.strip()[-400:]}"}
    row.setdefault("wall_s", round(time.time() - t0, 2))
    for line in lines[:-1]:
        print(line, flush=True)
    if "error" in row:
        sys.stderr.write(r.stderr[-4000:])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda by default; cpu for the tests)")
    ap.add_argument("--cell-timeout", type=float, default=1800.0,
                    help="seconds a cell may take before it is an error row")
    ap.add_argument("--jobs", type=int, default=1, help="cells traced at once")
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cell:
        return _one(args)

    archs = (list(all_archs()) if args.arch == "all"
             else [args.arch.replace("-", "_").replace(".", "_")])
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    rows = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in rows if "error" not in r}
    rows = [r for r in rows if (r["arch"], r["shape"], r["mesh"]) in done]
    keys = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = applicable_shapes(cfg) if args.shape == "all" else [args.shape]
        for shape_name in shapes:
            for mp in meshes:
                key = (arch, shape_name, mesh_label(production_mesh_shape(mp)))
                if key not in done:
                    keys.append(key)

    def save():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)

    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        futures = [pool.submit(_subprocess_cell, k, args.device, args.cell_timeout)
                   for k in keys]
        for fut in futures:
            rows.append(fut.result())
            save()
    save()
    bad = [r for r in rows if "error" in r]
    print(f"\n{len(rows) - len(bad)}/{len(rows)} cells OK; {len(bad)} failed")
    for r in bad:
        print("  FAIL", r["arch"], r["shape"], r["mesh"], "—", r["error"][:120])
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
