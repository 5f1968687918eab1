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
    ``collective_ops_sample``; ``lower_s``, the trace's seconds.

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


@contextlib.contextmanager
def _strategy_gaps():
    """The sharding strategies the step needs where `DTensor`'s own fail,
    registered for the trace and restored after it (the propagator's
    cache cleared on the way out):

    * ``view`` and ``_unsafe_view`` (the folds of a batched matmul):
      `DTensor`'s rule refuses a merge of dims whose inner one is sharded
      (torch 2.11), or shards the merged dim strided (2.13), which its
      planner then searches on a graph; here such a view redistributes
      its input first, as ``reshape``'s rule does;
    * ``select`` of a masked partial: `_select_reduces_masked`."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops

    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    views = (aten.view.default, aten._unsafe_view.default)
    ops = (*views, aten.select.int)
    saved = {op: (prop.op_strategy_funcs.get(op), prop.op_to_schema_info.get(op))
             for op in ops}
    try:
        for op in views:
            _view_ops.register_op_strategy_map(op, torch.Tensor.view,
                                               schema_info=RuntimeSchemaInfo(1),
                                               strict_view=False)
        prop.register_op_strategy(aten.select.int,
                                  _select_reduces_masked(saved[aten.select.int][0]),
                                  saved[aten.select.int][1])
        yield
    finally:
        for op, (fn, info) in saved.items():
            prop.op_strategy_funcs[op] = fn
            prop.op_to_schema_info[op] = info
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


def _run_step(cfg, shape, mesh, device, topts=None, audit=None):
    """Builds the cell's inputs (``shape``, a `ShapeSpec`) on ``mesh`` and
    runs its step once under `op_stats.OpStats` (and ``audit``, an
    `op_stats.DotAudit`, above it where given) → (stats, arguments,
    outputs, seconds).  ``topts`` replaces a train step's
    `TrainOptions` (`train.steps.dryrun_train_options`'s by default)."""
    from torch.distributed.tensor.experimental import implicit_replication

    kind = shape.kind
    model = lm.LM(cfg, device=device)  # no generator: nothing is drawn
    ins = specs_mod.input_specs(cfg, shape, device)
    if kind == "train":
        state_dtype, default_topts = steps_mod.dryrun_train_options(cfg)
        topts = topts or default_topts
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
    t0 = time.time()
    with contextlib.ExitStack() as modes:
        for ctx in (implicit_replication(), _strategy_gaps(), stats, _LocalGaps(),
                    *([audit] if audit is not None else [])):
            modes.enter_context(ctx)
        if kind == "train":
            step = steps_mod.make_train_step(cfg, ocfg, topts)
            _, ostate, metrics = step(model, ostate, batch)
            outs = (params, ostate, metrics)
        elif kind == "prefill":
            with torch.no_grad():
                outs = steps_mod.make_prefill_step(cfg)(model, batch)
        else:
            with torch.no_grad():
                outs = steps_mod.make_serve_step(cfg)(model, cache, tokens, ins["pos"])
    return stats, args, outs, time.time() - t0


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *, mesh=None,
               device: str = "cuda", verbose: bool = True, spec=None, cfg=None,
               topts=None, audit: bool = False) -> dict:
    """One cell's row.  ``mesh`` is an ``{axis: size}`` mapping (the
    production mesh of ``multi_pod`` by default); the cell runs on a fake
    process group of its size, made and destroyed here.  ``spec``, a
    `ShapeSpec`, replaces ``SHAPES[shape_name]`` (a step at another
    batch or length, named ``shape_name``); ``cfg`` replaces
    ``get_config(arch)`` and ``topts`` a train step's `TrainOptions`.
    ``audit`` adds the row's `op_stats.DotAudit` summary under
    ``"audit"``.  ``torch`` is the version that traced it: `DTensor`
    partitions apart from one release to the next."""
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
                stats, args, outs, secs = _run_step(cfg, shape, dmesh, device, topts, dots)
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
