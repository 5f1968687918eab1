"""Per-device op statistics of one traced step: FLOPs, HBM bytes,
collective link bytes and the peak of live bytes.

The counterpart of the reference's `repro.launch.hlo_stats`, which reads
them from XLA's partitioned HLO.  The port has no HLO: `OpStats` is a
`TorchDispatchMode` that counts each ATen op as it runs, with the
reference's rules:

  * FLOPs        — 2 · |out| · contraction for every matmul-family op
                   (``mm``, ``addmm``, ``bmm``, ``baddbmm``; einsums and
                   ``@`` reach them), the `dot` rule;
  * HBM bytes    — Σ (operands + result) of every op that makes a buffer,
                   skipping views, layout copies and allocations (the
                   ``_SKIP_BYTES_OPS`` counterparts), with the window rule
                   of ``_SLICELIKE`` for index, gather, scatter, slice
                   writes and pad: 3 × the smallest operand, at most the
                   result;
  * collectives  — every ``_c10d_functional`` op, with the same ring
                   factors over the group size N:
                     all-gather: out·(N−1)/N   reduce-scatter: out·N·(N−1)/N
                     all-reduce: 2·out·(N−1)/N all-to-all: out·(N−1)/N
                     collective-permute: out.

What a device executes is its *local* shards.  A `DTensor` op reaches a
dispatch mode first with the global tensors; the mode hands it back
(``NotImplemented``), `DTensor` runs its redistributions and the op on
the local tensors, and those calls reach the mode again: that is where
it counts.  The global-shape ops `DTensor` runs to propagate output
metadata are not counted (`_propagation_unseen`).  The port runs no
loop in a graph, so every op is counted where it runs: a collective's
``mult`` is the number of identical calls.  The one loop the dry run
does not run whole is a train step's microbatches: it runs two, the
second under `scaled`, which counts each op of it as the n − 1 identical
ops of the later trips, as `hlo_stats` counts a ``while`` body by its
``known_trip_count``.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}
_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.int32: "s32",
    torch.float32: "f32", torch.int64: "s64", torch.float64: "f64",
    torch.complex64: "c64", torch.complex128: "c128",
}

aten = torch.ops.aten
_DOTS = {aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default}
# no traffic of their own: allocations, aliases, metadata and layout copies
# (XLA's parameter/constant/bitcast/copy)
_SKIP_BYTES_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "clone", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
}
# touch a window of their operands, not the whole: 3 × the smaller side
_SLICELIKE = {
    "index", "_unsafe_index", "index_select", "gather", "embedding",
    "scatter", "scatter_add", "scatter_reduce", "index_put", "_index_put_impl",
    "index_copy", "index_add", "index_fill", "slice_scatter", "select_scatter",
    "narrow_copy", "slice_copy", "constant_pad_nd", "pad",
}
# write their first operand without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "index_put_", "index_copy_", "scatter_"}
_COLLECTIVE_KIND = {
    "all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
    "all_reduce": "all-reduce", "all_to_all": "all-to-all",
    "broadcast": "collective-permute",
}


def dtype_bytes(dtype: torch.dtype) -> int:
    return _DTYPE_BYTES[_HLO_DTYPE[dtype]]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * dtype_bytes(t.dtype)


def link_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Bytes a device sends over its link for one collective of ``kind``
    (the HLO names) whose result is ``out_bytes``, over ``group`` ranks."""
    if group <= 1:
        return 0.0
    ring = (group - 1) / group
    if kind == "all-reduce":
        return 2 * out_bytes * ring
    if kind in ("all-gather", "all-to-all"):
        return out_bytes * ring
    if kind == "reduce-scatter":
        return out_bytes * group * ring
    return float(out_bytes)


def dot_flops(func, args, out) -> float:
    """2 · |out| · contraction of a matmul-family op (the lhs's last dim)."""
    lhs = args[1] if func in (aten.addmm.default, aten.baddbmm.default) else args[0]
    return 2.0 * out.numel() * lhs.shape[-1]


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _unseen(fn):
    from torch.utils._python_dispatch import _disable_current_modes

    def call(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    return call


def _cheapest_strategy_search():
    """Where `DTensor` has both, its priority-queue search for an op's
    cheapest strategy in place of the exhaustive expansion of the
    single-dimension strategies (S^N candidates for N mesh dimensions,
    each with a redistribution plan per input), falling back to it where
    the search declines (a strided shard among the inputs) and for an
    in-place op, whose output must keep its input's placement (the search
    does not hold it to that: an in-place add then met shards of two
    layouts): the same lowest-cost choice, found in milliseconds on three
    mesh dimensions where the expansion takes minutes.  → (module, name,
    replacement) or None."""
    from torch.distributed.tensor import _sharding_prop
    from torch.distributed.tensor._ops import single_dim_strategy as sds

    search = getattr(sds, "_dijkstra_expand_single_dim_strategy_to_mesh", None)
    full = getattr(_sharding_prop, "_expand_single_dim_strategy_to_mesh", None)
    if search is None or full is None:
        return None

    def expand(mesh, op_schema, info, out_meta):
        exhaustive = full(mesh, op_schema, info, out_meta)

        def strategy(op, args_schema, kwargs_schema):
            if op.name().split("::")[-1].split(".")[0].endswith("_"):
                return exhaustive(op, args_schema, kwargs_schema)  # in place
            found = search(mesh, op_schema, info, out_meta)
            return found if found is not None else exhaustive(op, args_schema, kwargs_schema)

        return strategy

    return _sharding_prop, "_expand_single_dim_strategy_to_mesh", expand


@contextlib.contextmanager
def _propagation_unseen():
    """Runs `DTensor`'s sharding propagation and redistribution planning
    with every dispatch mode off, and cached.

    The ops they run (an output's shape and stride on global tensors, the
    index arithmetic of the cost model) are bookkeeping on the host, not
    work of a device; under a `FakeTensorMode` the index arithmetic would
    turn symbolic and slow.  `DTensor` takes an active `FakeTensorMode`
    for a compiler's trace, whose shapes may be symbolic, and then caches
    neither its shardings nor its plans, and searches every op's
    strategies anew.  The dry run's shapes are plain ints, so both are
    cached, keyed as `DTensor` keys them outside a trace (the op's schema;
    the source and target specs)."""
    import functools

    from torch.distributed.tensor import DTensor, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    cached_sharding = _unseen(prop.propagate_op_sharding)
    cached_plan = _unseen(functools.cache(_redistribute._gen_transform_infos_non_cached))
    patched = [(prop, "propagate_op_sharding", cached_sharding),
               (prop, "propagate_op_sharding_non_cached", cached_sharding),
               (_redistribute, "_gen_transform_infos", cached_plan),
               (_redistribute, "_gen_transform_infos_non_cached", cached_plan)]
    fast = _cheapest_strategy_search()
    if fast is not None:
        patched.append(fast)
    saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in patched]
    for obj, name, fn in patched:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, old in saved:
            if old is None:
                delattr(obj, name)
            else:
                setattr(obj, name, old)


@contextlib.contextmanager
def scaled(n: int, *counters):
    """Inside the block every op that ``counters`` (`OpStats`,
    `DotAudit`) count counts as ``n`` identical ops: the ops of one trip
    of a loop that runs ``n`` alike.  Live bytes are not scaled: a trip's
    buffers are freed before the next."""
    for c in counters:
        c.scale = n
    try:
        yield
    finally:
        for c in counters:
            c.scale = 1


class OpStats(TorchDispatchMode):
    """Counts the ops run inside it (see the module's docstring) into
    ``flops``, ``bytes_accessed``, ``collectives`` (one dict a call: kind,
    result bytes, group size, link bytes), ``peak_live_bytes``: the
    most bytes of storage made inside it alive at once, those of
    ``arguments`` (tensors alive before it) excluded, and ``touched``: the
    storages (by id) that some op took as an operand.  An op counts
    ``scale`` times (`scaled`)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.scale = 1
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: list[dict] = []
        self.peak_live_bytes = 0
        self.live_bytes = 0
        self.touched: set[int] = set()  # storage ids an op took as an operand
        self._seen = {id(_storage(t)) for t in _tensors(arguments)}
        self._keep = [_storage(t) for t in _tensors(arguments)]  # ids stay unique
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        self._stack.enter_context(_propagation_unseen())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    # ---- live storage -----------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = _storage(t)
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        size = st.nbytes()
        self.live_bytes += size
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key, size)

    def _release(self, key, size) -> None:
        self._seen.discard(key)
        self.live_bytes -= size

    # ---- counting -----------------------------------------------------------
    def _collective(self, func, args, out) -> None:
        name = func._opname
        kind = next((v for k, v in _COLLECTIVE_KIND.items() if name.startswith(k)), None)
        if kind is None:  # wait_tensor and the like
            return
        from torch.distributed.distributed_c10d import _resolve_process_group

        group_name = [a for a in args if isinstance(a, str)][-1]
        n = _resolve_process_group(group_name).size()
        for o in _tensors(out):
            b = nbytes(o)
            self.collectives.extend([{"op": kind, "bytes": b, "group": n,
                                      "link_bytes": link_bytes(kind, b, n)}] * self.scale)

    def _bytes(self, func, args, kwargs, out) -> float:
        name = func._opname
        if func.is_view or name in _SKIP_BYTES_OPS:
            return 0.0
        ins = {id(t): t for t in _tensors((args, kwargs))}
        if name in _WRITE_ONLY and args and isinstance(args[0], torch.Tensor):
            ins.pop(id(args[0]), None)
        in_sizes = [nbytes(t) for t in ins.values()]
        result = sum(nbytes(o) for o in _tensors(out))
        if name in _SLICELIKE or (name == "copy_" and _is_window(args[0])):
            if name == "copy_":  # a write into part of a buffer
                result = _storage(args[0]).nbytes()
            small = [s for s in in_sizes if 0 < s < result] or [result]
            return float(min(result, 3 * min(small)))
        return float(result + sum(in_sizes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(isinstance(t, DTensor) for t in _tensors((args, kwargs))):
            return NotImplemented  # DTensor runs it on the local shards
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out
        for t in _tensors((args, kwargs)):
            self.touched.add(id(_storage(t)))
        if func in _DOTS:
            self.flops += self.scale * dot_flops(func, args, out)
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            self._collective(func, args, out)
        self.bytes_accessed += self.scale * self._bytes(func, args, kwargs, out)
        for o in _tensors(out):
            self._track(o)
        return out

    def summary(self) -> dict:
        by_kind: dict[str, float] = {}
        for c in self.collectives:
            by_kind[c["op"]] = by_kind.get(c["op"], 0.0) + c["link_bytes"]
        return {
            "flops": self.flops,
            "hbm_bytes": self.bytes_accessed,
            "num_collectives": len(self.collectives),
            "link_bytes_total": sum(c["link_bytes"] for c in self.collectives),
            "by_kind": by_kind,
            "ops": grouped_collectives(self.collectives),
        }


def _split(size: int, parts: int) -> int:
    """Rank 0's share of ``size`` split ``parts`` ways (`DTensor`'s
    `Shard`: the first ranks take the ceiling)."""
    return -(-size // parts)


def _local_shape(spec) -> list:
    """Rank 0's shape of a tensor laid out as ``spec`` (a `DTensorSpec`)."""
    from torch.distributed.tensor import Shard

    shape = list(spec.shape)
    for i, p in enumerate(spec.placements):
        if isinstance(p, Shard):
            shape[p.dim] = _split(shape[p.dim], spec.mesh.size(i))
    return shape


def expected_dot_flops(func, args, kwargs, out) -> tuple[float, float]:
    """(G, the FLOPs rank 0 executes) of a matmul-family op seen above
    `DTensor`, from shapes and placements alone: G by the dot rule on the
    global shapes; rank 0's share by the same rule on the shapes that the
    placements `DTensor` runs the op under (its operands' after their
    redistribution, as its sharding propagation chose them) give rank 0:
    a `Shard` splits its dim, `Partial` and `Replicate` split nothing."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    g = dot_flops(func, args, out)
    if not isinstance(out, DTensor):
        return g, g

    def chosen():
        dispatcher = DTensor._op_dispatcher
        info = dispatcher.unwrap_to_op_info(func, args, kwargs)
        dispatcher.sharding_propagator.propagate(info)
        sharding = info.output_sharding
        schema = (sharding.redistribute_schema if sharding.needs_redistribute
                  and sharding.redistribute_schema is not None else info.schema)
        return [a for a in schema.args_schema if isinstance(a, DTensorSpec)]

    specs = _unseen(chosen)()
    lhs, rhs = specs[-2:]  # addmm's and baddbmm's first operand is the bias
    lhs, rhs = _local_shape(lhs), _local_shape(rhs)
    local = 2.0 * rhs[-1]
    for d in lhs:
        local *= d
    return g, local


class DotAudit(TorchDispatchMode):
    """A second count of the FLOPs `OpStats` must find, from above
    `DTensor`: each matmul-family op of the step from its global shapes
    and placements (`expected_dot_flops`), where `OpStats` reads the local
    tensors below `DTensor`.  Entered above `OpStats`, and so
    never reached by the local calls that `DTensor` makes below it.
    ``expected_flops`` sums rank 0's shares and must equal `OpStats`'s
    ``flops``; ``global_flops`` sums G, the step's FLOPs on one rank;
    ``dots`` groups the ops by (op, global output shape, placements, the
    share of G rank 0 executes: 1 where the op is replicated over the
    whole mesh) with their count and their summed global and local FLOPs,
    largest rank-0 FLOPs first.  An op counts ``scale`` times
    (`scaled`)."""

    def __init__(self):
        super().__init__()
        self.scale = 1
        self.expected_flops = 0.0
        self.global_flops = 0.0
        self._dots: dict[tuple, dict] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _DOTS:
            g, local = expected_dot_flops(func, args, kwargs, out)
            placements = tuple(str(p) for p in getattr(out, "placements", ()))
            key = (func._opname, tuple(out.shape), placements, local / g)
            e = self._dots.setdefault(key, {"op": key[0], "shape": list(key[1]),
                                            "placements": list(placements),
                                            "share": key[3], "count": 0,
                                            "global_flops": 0.0, "local_flops": 0.0})
            e["count"] += self.scale
            e["global_flops"] += self.scale * g
            e["local_flops"] += self.scale * local
            self.expected_flops += self.scale * local
            self.global_flops += self.scale * g
        return out

    def summary(self) -> dict:
        return {"expected_flops": self.expected_flops, "global_flops": self.global_flops,
                "dots": sorted(self._dots.values(), key=lambda e: -e["local_flops"])}


def _is_window(t: torch.Tensor) -> bool:
    """A tensor that covers only part of its storage."""
    return nbytes(t) < _storage(t).nbytes()


def grouped_collectives(calls: list[dict]) -> list[dict]:
    """Identical calls (kind, bytes, group) as one entry with their count
    (``mult``) and summed link bytes, the reference's per-op form."""
    out: dict[tuple, dict] = {}
    for c in calls:
        key = (c["op"], c["bytes"], c["group"])
        e = out.setdefault(key, {**c, "mult": 0, "link_bytes": 0.0})
        e["mult"] += 1
        e["link_bytes"] += c["link_bytes"]
    return list(out.values())
