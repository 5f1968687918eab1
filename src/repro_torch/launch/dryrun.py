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
partitioners"): the model modules run as they run on one card.

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


def _rank0_numel(shape, placements, mesh) -> int:
    """Rank 0's element count of a tensor of global ``shape`` under
    ``placements`` (each `Shard` splits its dim, the first ranks taking
    the ceiling)."""
    from torch.distributed.tensor import Shard

    local = list(shape)
    for i, p in enumerate(placements):
        if type(p) is Shard:
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    return math.prod(local)


def _views_keep_numel(original):
    """``view``'s strategy (``original``), but where the output it gives
    holds on rank 0 another number of elements than the input it asks
    for, the input first replicates the inner of two mesh dimensions that
    shard one tensor dim, until the two agree: `DTensor`'s rule hands
    every shard of a dim two mesh dimensions split (a merged batch ×
    heads, over ``pod`` and ``model``) to the first factor of a split,
    which a factor smaller than the two cannot hold (a microbatch of 2
    over 4 ranks).  Where the two agree, the strategy is `DTensor`'s
    own."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSchema, OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    def strategy(op_schema):
        src = op_schema.args_schema[0]
        shape = tuple(src.shape)
        target = list(op_schema.args_schema[1])
        if -1 in target:
            target[target.index(-1)] = math.prod(shape) // -math.prod(target)

        def agree(s):
            return (_rank0_numel(shape, s.input_specs[0].placements, s.output_spec.mesh)
                    == _rank0_numel(target, s.output_spec.placements, s.output_spec.mesh))

        out = OpStrategy([])
        for s in original(op_schema).strategies:
            fixed = s
            while not agree(fixed):
                placements = list(fixed.input_specs[0].placements)
                dims = [p.dim if type(p) is Shard else None for p in placements]
                inner = [i for i, d in enumerate(dims) if d is not None and dims.index(d) < i]
                if not inner:
                    raise RuntimeError(f"{op_schema}: no layout the view rule holds")
                placements[inner[-1]] = Replicate()
                spec = DTensorSpec(s.output_spec.mesh, tuple(placements),
                                   tensor_meta=s.input_specs[0].tensor_meta)
                fixed = original(OpSchema(op_schema.op, (OpStrategy([OpSpec(spec)]),
                                                         *op_schema.args_schema[1:]),
                                          op_schema.kwargs_schema)).strategies[0]
            if fixed is not s:
                fixed = OpSpec(output_specs=fixed.output_spec, input_specs=fixed.input_specs,
                               redistribute_cost=[generate_redistribute_costs(
                                   src, fixed.input_specs[0])])
            out.strategies.append(fixed)
        return out

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
      planner then searches on a graph; here such a view redistributes
      its input first, as ``reshape``'s rule does (`_views_keep_numel`
      where the rule would split a dim two mesh dimensions shard wrong);
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
      `_shard_to_partial_in_two`."""
    from torch.distributed.tensor import DTensor, _dispatch, _redistribute
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops
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
             for op in (*views, aten.select.int, aten.flip.default, *rules)}
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
            prop.op_strategy_funcs[op] = _views_keep_numel(prop.op_strategy_funcs[op])
        prop.register_op_strategy(aten.select.int,
                                  _select_reduces_masked(saved[aten.select.int][0]),
                                  saved[aten.select.int][1])
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


class _LocalGaps(TorchDispatchMode):
    """Two ops of the step that the dry run runs its own way, each
    computing what the op computes:

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
        if func is aten.bincount.default:
            ids, weights, n = (list(args) + [None, 0])[:3]
            if weights is None and n:
                return self._bincount(ids, n)
        elif func is aten.scatter_.src and not kwargs:
            from torch.distributed.tensor import DTensor

            if isinstance(args[0], DTensor):
                return self._scatter_(*args)
        return func(*args, **kwargs)

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


def _run_step(cfg, shape, mesh, device, topts=None, audit=None, scale_microbatches=True):
    """Builds the cell's inputs (``shape``, a `ShapeSpec`) on ``mesh`` and
    runs its step once under `op_stats.OpStats` (and ``audit``, an
    `op_stats.DotAudit`, above it where given) → (stats, arguments,
    outputs, seconds, microbatches).  ``topts`` replaces a train step's
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
    counters = (stats, *([audit] if audit is not None else []))
    t0 = time.time()
    with contextlib.ExitStack() as modes:
        for ctx in (implicit_replication(), _strategy_gaps(), stats, _LocalGaps(),
                    *counters[1:]):
            modes.enter_context(ctx)
        if kind == "train":
            loop = _scaled_microbatches(*counters) if micro["traced"] < n else range
            step = steps_mod.make_train_step(cfg, ocfg, topts, loop)
            _, ostate, metrics = step(model, ostate, batch)
            outs = (params, ostate, metrics)
        elif kind == "prefill":
            with torch.no_grad():
                outs = steps_mod.make_prefill_step(cfg)(model, batch)
        else:
            with torch.no_grad():
                outs = steps_mod.make_serve_step(cfg)(model, cache, tokens, ins["pos"])
    return stats, args, outs, time.time() - t0, micro


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *, mesh=None,
               device: str = "cuda", verbose: bool = True, spec=None, cfg=None,
               topts=None, audit: bool = False, scale_microbatches: bool = True) -> dict:
    """One cell's row.  ``mesh`` is an ``{axis: size}`` mapping (the
    production mesh of ``multi_pod`` by default); the cell runs on a fake
    process group of its size, made and destroyed here.  ``spec``, a
    `ShapeSpec`, replaces ``SHAPES[shape_name]`` (a step at another
    batch or length, named ``shape_name``); ``cfg`` replaces
    ``get_config(arch)`` and ``topts`` a train step's `TrainOptions`.
    ``audit`` adds the row's `op_stats.DotAudit` summary under
    ``"audit"``.  ``torch`` is the version that traced it: `DTensor`
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
    dots = op_stats.DotAudit() if audit else None
    with fake_group(n):
        dmesh = (make_mesh(sizes, device) if mesh is not None
                 else make_production_mesh(multi_pod, device))
        axes.set_logical_axes(dmesh.mesh_dim_names)
        try:
            with FakeTensorMode(shape_env=ShapeEnv()):
                stats, args, outs, secs, micro = _run_step(cfg, shape, dmesh, device, topts,
                                                           dots, scale_microbatches)
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
    cell["cost"] = {"flops": full["flops"], "bytes_accessed": full["hbm_bytes"]}
    cell["collectives"] = {k: full[k] for k in ("num_collectives", "link_bytes_total",
                                                "by_kind")}
    ops_sorted = sorted(full["ops"], key=lambda o: -o["link_bytes"])
    cell["collective_ops_sample"] = [
        {k: o[k] for k in ("op", "bytes", "group", "mult", "link_bytes")}
        for o in ops_sorted[:10]
    ]
    if dots is not None:
        cell["audit"] = dots.summary()
    if verbose:
        print(f"[{cell['arch']} × {cell['shape']} × {cell['mesh']}] "
              f"trace={cell['lower_s']}s flops/dev={cell['cost']['flops']:.3g} "
              f"mem/dev={cell['memory']['per_device_total'] / 2**30:.2f}GiB "
              f"coll_bytes/dev={cell['collectives']['link_bytes_total']:.3g}", flush=True)
    return cell


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
