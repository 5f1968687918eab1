"""Device (kernel-layer) execution of per-partition query answers.

Routes `per_partition_answers` through the fused predicate + group
aggregation kernel (`kernels/fused.py`, CUDA source `csrc/eval.cu`) and,
for queries without a predicate, the group-aggregate kernel
(`kernels/groupagg.py`) — on a CUDA device the hand-written kernels, on a
CPU device their plain PyTorch versions, through the same driver.

**Canonical interval form.**  Every clause the kernel evaluates is a
half-open test ``lo <= x < hi`` on the float32 image of the column.  The
bounds are chosen so the float32 row set matches the host comparison
*bit-exactly* (`_f32_interval`): a float64 constant is snapped to the
nearest float32 boundary on the correct side, numeric equality becomes
``[v, nextafter(v))``, and coded-categorical equality ``[v, v+1)``.
``in``-lists expand to one interval clause per value in the same OR-group
and ``!=`` to the two-interval complement, so the only remaining host
fallbacks are genuinely inexpressible rows: non-finite columns under
``!=`` (NaN ≠ v is True; no interval says so), ``+inf`` under equality,
non-integer constants against coded categoricals, and clause blowups past
``MAX_CANON_CLAUSES``.

**Stacked batching.**  Queries sharing a shape signature
``(C_b, G_b, radix_b, V_b)`` are stacked along the partition axis —
Q queries × N partitions become one (Q·N, ...) kernel launch — and the
stack depth is itself bucketed to a power of two.  Padding is masked,
never observed: padded clause slots are always-false members of a real
OR-group, padded OR-groups get one always-true clause, padded group
buckets receive no codes, padded value rows are zero, and padded queries
are sliced off before unpacking.

The column stack (`EvalCache.device_stack`) is the only bulk tensor and
ships to the device once; everything per query is a small descriptor.
`TRACES` counts launches per shape-bucket key, so tests can hold the
launch keys to `workload_census`.  The driver's phases are labelled
``eval.*`` for `torch.profiler` (no cost when no profiler is active).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.clustering import bucket_size
from repro_torch.data.table import CATEGORICAL, Table
from repro_torch.kernels import ops
from repro_torch.kernels.telemetry import TraceRegistry
from repro_torch.queries import engine
from repro_torch.queries.ir import Predicate, Query

TRACES = TraceRegistry("query_eval")

# cap on stacked f32 elements per launch (Q_b · N · max(C_b, V_b) · R)
MAX_STACK_ELEMS = 1 << 25
MAX_STACK_QUERIES = 64

# in-list / != expansion stops here: a wider predicate would blow the
# clause shape bucket (and the census) for one query — host fallback
MAX_CANON_CLAUSES = 24

_F32_INF = np.float32(np.inf)
_F32_TINY = np.float32(np.finfo(np.float32).tiny)  # smallest normal


# --------------------------------------------------------------------------
# canonical interval form
# --------------------------------------------------------------------------
def _f32_interval(op: str, v: float) -> tuple[np.float32, np.float32] | None:
    """Float32 (lo, hi) with {x ∈ f32 : lo <= x < hi} == {x : x op v}.

    Exactness argument: numpy compares a float32 column against a Python
    float constant under weak scalar promotion — the constant is cast to
    float32 first — so the half-open interval only has to shift the
    boundary one ulp past ``vf = float32(v)`` on the inclusive side.
    """
    vf = np.float32(v)
    up = np.nextafter(vf, _F32_INF)
    if op == "<":
        return (-_F32_INF, vf)
    if op == "<=":
        return (-_F32_INF, up)
    if op == ">":
        return (up, _F32_INF)
    if op == ">=":
        return (vf, _F32_INF)
    if op == "==":
        return (vf, up)
    return None  # "!=", "in": complement / multi-interval — host fallback


@dataclasses.dataclass(frozen=True)
class CanonicalPredicate:
    """AND-of-OR-groups lowered to per-clause interval tests."""

    cols: tuple[str, ...]  # per-clause source column
    lo: np.ndarray  # (C,) float32 inclusive lower bounds
    hi: np.ndarray  # (C,) float32 exclusive upper bounds
    group_of: tuple[int, ...]  # per-clause OR-group index
    num_groups: int


def _is_code(v) -> bool:
    """True when v is an exact integer code value ([v, v+1) is sound)."""
    try:
        return float(v) == int(v)
    except (OverflowError, ValueError):
        return False


def _clause_intervals(
    table: Table, clause, cache: engine.EvalCache
) -> list[tuple[np.float32, np.float32]] | None:
    """Interval expansion of one clause (OR over the list), or None.

    Categorical ``in``/``!=`` expand per code value; numeric ``in``
    expands to per-value equality intervals and numeric ``!=`` to the
    two-sided complement — the latter only on all-finite columns, since
    the host's ``NaN != v`` is True and no interval pair can say so.
    """
    if table.spec(clause.col).kind == CATEGORICAL:
        if clause.op == "==" :
            return [(np.float32(clause.value), np.float32(clause.value + 1))]
        if clause.op == "in":
            if not all(_is_code(v) for v in clause.value):
                return None  # [v, v+1) would admit code ceil(v): host isin won't
            return [(np.float32(v), np.float32(v + 1)) for v in clause.value]
        if clause.op == "!=":
            if not _is_code(clause.value):
                return None
            v = int(clause.value)
            return [(-_F32_INF, np.float32(v)), (np.float32(v + 1), _F32_INF)]
        return None  # range ops on codes: host fallback
    if cache.has_posinf(clause.col):
        return None  # +inf breaks the half-open equality image
    if clause.op == "in":
        # host isin compares in float64 (the list is asarray'd, not a weak
        # scalar) — the f32 equality interval only matches when the value
        # IS its own float32 image, and never for non-finite values
        if not all(
            np.isfinite(np.float32(v)) and float(np.float32(v)) == float(v)
            for v in clause.value
        ):
            return None
        return [_f32_interval("==", float(v)) for v in clause.value]
    if clause.op == "!=":
        if cache.has_nonfinite(clause.col):
            return None  # host: NaN != v is True; intervals would say False
        vf = np.float32(clause.value)
        return [(-_F32_INF, vf), (np.nextafter(vf, _F32_INF), _F32_INF)]
    iv = _f32_interval(clause.op, float(clause.value))
    return None if iv is None else [iv]


def canonicalize_predicate(
    table: Table, predicate: Predicate, cache: engine.EvalCache | None = None
) -> CanonicalPredicate | None:
    """Interval form of the predicate, or None if it needs the host path."""
    cache = cache or engine.EvalCache(table)
    cols: list[str] = []
    lo: list[np.float32] = []
    hi: list[np.float32] = []
    group_of: list[int] = []
    for g, group in enumerate(predicate.groups):
        for clause in group.clauses:
            ivs = _clause_intervals(table, clause, cache)
            if ivs is None:
                return None
            # a nonzero-subnormal boundary (e.g. nextafter(0) from
            # ``<= 0.0``) takes the host path, as in the reference (whose
            # XLA-on-CPU lowering flushes subnormals): the same queries
            # then route the same way on both, and the census agrees
            if any(
                b != 0 and np.isfinite(b) and abs(b) < _F32_TINY
                for iv in ivs for b in iv
            ):
                return None
            for ivl, ivh in ivs:
                cols.append(clause.col)
                lo.append(ivl)
                hi.append(ivh)
                group_of.append(g)
    if len(cols) > MAX_CANON_CLAUSES:
        return None
    return CanonicalPredicate(
        tuple(cols),
        np.asarray(lo, np.float32),
        np.asarray(hi, np.float32),
        tuple(group_of),
        len(predicate.groups),
    )


# --------------------------------------------------------------------------
# shape-bucket signatures
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Signature:
    """Shape bucket of one driver launch (the launch key, minus Q_b)."""

    num_clauses: int  # C_b (0 = no-predicate driver)
    num_groups: int  # G_b
    radix: int  # radix_b
    n_raw: int  # V_b

    @property
    def has_predicate(self) -> bool:
        return self.num_clauses > 0


@dataclasses.dataclass
class _QueryPlan:
    query: Query
    canon: CanonicalPredicate
    radix: int
    n_raw: int
    plans: list
    sig: Signature


# coarse radix levels: fine power-of-two buckets fragment a workload into
# one-query signatures (26 signatures for 48 queries in the reference),
# defeating the batching.  Radix only sizes the output block, so
# over-padding is cheap relative to the row pass.
_RADIX_LEVELS = (8, 128, 512, 2048)


def _radix_bucket(radix: int) -> int:
    for lvl in _RADIX_LEVELS:
        if radix <= lvl:
            return lvl
    return bucket_size(radix)  # generator caps radix at MAX_GROUPS = 4096


def _signature(canon: CanonicalPredicate, radix: int, n_raw: int) -> Signature:
    vb = max(4, bucket_size(n_raw, minimum=1))  # generator emits n_raw <= 4
    if len(canon.cols) == 0:
        return Signature(0, 0, _radix_bucket(radix), vb)
    gb = bucket_size(canon.num_groups, minimum=2)
    extra = gb - canon.num_groups  # padded OR-groups need an always-true clause each
    cb = bucket_size(len(canon.cols) + extra, minimum=4)
    return Signature(cb, gb, _radix_bucket(radix), vb)


def _max_stack(table: Table, sig: Signature) -> int:
    """Largest power-of-two query stack that fits the element budget
    (clause gather and segment-sum output are the two bulk tensors)."""
    n_local = engine.stack_partitions(table.num_partitions)
    per_query = n_local * (
        table.rows_per_partition * max(sig.num_clauses, sig.n_raw, 1)
        + sig.radix * sig.n_raw
    )
    q = MAX_STACK_QUERIES
    while q > 1 and q * per_query > MAX_STACK_ELEMS:
        q //= 2
    return q


def _chunks(items: list, size: int):
    for i in range(0, len(items), size):
        yield items[i : i + size]


# --------------------------------------------------------------------------
# kernel operands (the stack stays on device; descriptors are small)
# --------------------------------------------------------------------------
def _device_inputs(stack, col_idx, coefs, mults):
    """Gather clause columns and derive values/codes from the table stack.

    → (x (Q_b·P, C_b, R) or None when ``col_idx`` is None,
       values (Q_b·P, V_b, R) f32, codes (Q_b·P, R) int32).
    """
    ncols1, p, r = stack.shape
    qb, vb = coefs.shape[0], coefs.shape[1]
    # the projections below run as f32 matmuls; the mixed-radix codes are
    # integer-valued f32, exact only in IEEE f32 (TF32 keeps 10 mantissa
    # bits and would corrupt the group keys), so TF32 is switched off here
    torch.backends.cuda.matmul.allow_tf32 = False
    # the matmuls contract zero coefficients against EVERY column, and
    # 0·inf = NaN — sanitize the contraction image (queries whose own
    # aggregates touch a non-finite column fall back to the host path, so
    # zeroing here only silences unreferenced columns); clause gathers
    # below read the raw stack, where non-finite rows compare exactly
    flat = stack.reshape(ncols1, p * r)
    flat = torch.where(torch.isfinite(flat), flat, 0.0)
    # aggregate components: linear projections = coefficient matmul
    values = torch.einsum("qvc,cs->qvs", coefs, flat).reshape(qb, vb, p, r)
    values = values.transpose(1, 2).contiguous().view(qb * p, vb, r)
    # mixed-radix group codes: integer-valued f32 matvec (exact below 2^24);
    # torch.round rounds half to even, as jnp.round does
    codes = torch.einsum("qc,cs->qs", mults, flat)
    codes = torch.round(codes).to(torch.int32).reshape(qb * p, r)
    if col_idx is None:
        return None, values, codes
    x = stack[col_idx]  # (Q_b, C_b, P, R) clause columns, gathered on device
    x = x.transpose(1, 2).contiguous().view(qb * p, col_idx.shape[1], r)
    return x, values, codes


def _descriptor(plan: _QueryPlan, cache: engine.EvalCache):
    """(col_idx (C_b,), lo, hi, gmap (C_b,G_b), coefs (V_b,n_cols+1),
    mults (n_cols+1,)) — everything the driver needs besides the stack."""
    sig, canon, table = plan.sig, plan.canon, cache.table
    cb, gb, vb = sig.num_clauses, sig.num_groups, sig.n_raw
    c, g = len(canon.cols), canon.num_groups
    ncols1 = cache.ones_index + 1

    col_idx = np.zeros(max(cb, 1), np.int64)
    lo = np.full(max(cb, 1), np.float32(1.0), np.float32)  # always-false slot
    hi = np.full(max(cb, 1), np.float32(-1.0), np.float32)
    gmap = np.zeros((max(cb, 1), max(gb, 1)), np.float32)
    for j, col in enumerate(canon.cols):
        col_idx[j] = cache.col_index[col]
        lo[j] = canon.lo[j]
        hi[j] = canon.hi[j]
        gmap[j, canon.group_of[j]] = 1.0
    # padded OR-groups: one always-true clause each (ones column ∈ [0.5, 1.5))
    for k in range(gb - g):
        col_idx[c + k] = cache.ones_index
        lo[c + k] = np.float32(0.5)
        hi[c + k] = np.float32(1.5)
        gmap[c + k, g + k] = 1.0
    # remaining padded clause slots stay always-false, parked in group 0
    gmap[c + (gb - g) :, 0] = 1.0

    coefs = np.zeros((vb, ncols1), np.float32)
    coefs[0, cache.ones_index] = 1.0  # raw component 0 = passing-row count
    k = 1
    for agg in plan.query.aggregates:
        if agg.kind == "count":
            continue
        for coef, col in agg.terms:
            coefs[k, cache.col_index[col]] += np.float32(coef)
        k += 1

    mults = np.zeros(ncols1, np.float32)
    mult = 1
    for name in reversed(plan.query.groupby):
        mults[cache.col_index[name]] = np.float32(mult)
        mult *= table.spec(name).cardinality
    return col_idx, lo, hi, gmap, coefs, mults


def kernel_call(chunk: list[_QueryPlan], cache: engine.EvalCache) -> tuple[str, tuple]:
    """The kernel one stacked chunk launches and its operands:
    ``("fused_eval", (x, lo, hi, gmap, values, codes, radix))`` or
    ``("group_aggregate", (values, mask, codes, radix))`` — the `ops`
    entry point of that name takes exactly these arguments."""
    sig = chunk[0].sig
    qb = bucket_size(len(chunk), minimum=1)
    ncols1 = cache.ones_index + 1
    stack = cache.device_stack()
    cw = max(sig.num_clauses, 1)

    col_idx = np.zeros((qb, cw), np.int64)
    lo = np.full((qb, cw), np.float32(1.0), np.float32)
    hi = np.full((qb, cw), np.float32(-1.0), np.float32)
    gmap = np.zeros((qb, cw, max(sig.num_groups, 1)), np.float32)
    coefs = np.zeros((qb, sig.n_raw, ncols1), np.float32)
    mults = np.zeros((qb, ncols1), np.float32)
    for i, plan in enumerate(chunk):
        col_idx[i], lo[i], hi[i], gmap[i], coefs[i], mults[i] = _descriptor(plan, cache)

    def dev(a):
        return torch.from_numpy(a).to(stack.device)

    p = stack.shape[1]
    if not sig.has_predicate:
        _, values, codes = _device_inputs(stack, None, dev(coefs), dev(mults))
        mask = torch.ones(codes.shape, dtype=torch.float32, device=stack.device)
        return "group_aggregate", (values, mask, codes, sig.radix)
    x, values, codes = _device_inputs(stack, dev(col_idx), dev(coefs), dev(mults))
    # per-query descriptors repeated over the query's P stack rows
    lo_b = dev(lo).repeat_interleave(p, dim=0)  # (Q_b·P, C_b)
    hi_b = dev(hi).repeat_interleave(p, dim=0)
    gmap_b = dev(gmap).repeat_interleave(p, dim=0)  # (Q_b·P, C_b, G_b)
    return "fused_eval", (x, lo_b, hi_b, gmap_b, values, codes, sig.radix)


def _run_chunk(
    chunk: list[_QueryPlan], cache: engine.EvalCache
) -> list[engine.PartitionAnswers]:
    sig = chunk[0].sig
    n = cache.table.num_partitions
    qb = bucket_size(len(chunk), minimum=1)
    with record_function("eval.device_inputs"):
        name, args = kernel_call(chunk, cache)
    rows = args[0].shape[0]  # Q_b · P_bucket
    with record_function("eval.kernel"):
        if name == "fused_eval":
            TRACES.note("eval", rows, sig.num_clauses, sig.num_groups, sig.radix, sig.n_raw)
            out = ops.fused_eval_op(*args)
        else:
            TRACES.note("eval_nopred", rows, sig.radix, sig.n_raw)
            out = ops.group_aggregate_op(*args)
    with record_function("eval.unpack"):
        out = out.reshape(qb, rows // qb, sig.n_raw, sig.radix)
        # [:, :n] slices off the stack's zero pad partitions
        out = out[:, :n].cpu().numpy().astype(np.float64)
        answers = []
        for i, plan in enumerate(chunk):
            raw = out[i, :, : plan.n_raw, : plan.radix].transpose(0, 2, 1)
            answers.append(engine._answers_from_raw(plan.query, raw, plan.plans))
    return answers


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------
def _plan_workload(table: Table, queries: list[Query], cache: engine.EvalCache):
    """→ ({signature: [(index, plan)]}, [(index, query)] host fallbacks)."""
    grouped: dict[Signature, list[tuple[int, _QueryPlan]]] = {}
    fallback: list[tuple[int, Query]] = []
    for i, q in enumerate(queries):
        canon = canonicalize_predicate(table, q.predicate, cache)
        if canon is None or any(
            cache.has_nonfinite(col) for agg in q.aggregates for _, col in agg.terms
        ):
            fallback.append((i, q))
            continue
        radix = engine.group_radix_checked(table, q.groupby)
        plans, n_raw = engine.plan_aggregates(q.aggregates)
        sig = _signature(canon, radix, n_raw)
        grouped.setdefault(sig, []).append(
            (i, _QueryPlan(q, canon, radix, n_raw, plans, sig))
        )
    return grouped, fallback


def plan_launches(table: Table, queries: list[Query], cache: engine.EvalCache):
    """→ (chunks, fallback): the stacked chunks in launch order, each a
    list of (query index, plan) sharing one signature, and the
    (index, query) pairs that take the host path."""
    grouped, fallback = _plan_workload(table, queries, cache)
    chunks = [
        chunk
        for sig, entries in grouped.items()
        for chunk in _chunks(entries, _max_stack(table, sig))
    ]
    return chunks, fallback


def eval_workload(
    table: Table,
    queries: list[Query],
    cache: engine.EvalCache | None = None,
) -> list[engine.PartitionAnswers]:
    """Kernel-backed A_{g,i} for a workload; order matches the input.

    Runs on the device of ``cache.options`` (a fresh cache takes the
    default options: CUDA)."""
    cache = cache or engine.EvalCache(table)
    with record_function("eval.plan"):
        chunks, fallback = plan_launches(table, queries, cache)
    out: list[engine.PartitionAnswers | None] = [None] * len(queries)
    with record_function("eval.host_fallback"):
        for i, q in fallback:  # inexpressible predicates: exact-parity host path
            out[i] = engine._host_answers(table, q, cache)
    for chunk in chunks:
        with record_function("eval.chunk"):
            answers = _run_chunk([p for _, p in chunk], cache)
        for (i, _), ans in zip(chunk, answers):
            out[i] = ans
    return out


def workload_census(
    table: Table, queries: list[Query], cache: engine.EvalCache | None = None
) -> set[tuple]:
    """Launch keys a workload produces — the same keys the reference's
    compile census holds: one per (stack depth, signature) bucket."""
    cache = cache or engine.EvalCache(table)
    chunks, _ = plan_launches(table, queries, cache)
    n_local = engine.stack_partitions(table.num_partitions)
    keys: set[tuple] = set()
    for chunk in chunks:
        sig = chunk[0][1].sig
        b = bucket_size(len(chunk), minimum=1) * n_local
        if sig.has_predicate:
            keys.add(("eval", b, sig.num_clauses, sig.num_groups, sig.radix, sig.n_raw))
        else:
            keys.add(("eval_nopred", b, sig.radix, sig.n_raw))
    return keys
