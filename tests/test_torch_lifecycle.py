"""The port's partition lifecycle against the JAX reference and its own cold oracle.

Two contracts, at the reference tests' size (kdd, 8 partitions x 32 rows,
a picker of 8 trees of depth 3 without feature selection, trained once
by the reference and carried into the port with `repro_torch.carry`):

  * **port against reference, step by step** — the same op sequences
    (`lifecycle_machine.ops_from_seed`: appends, deletes, compactions,
    rebalances, snapshots and crash-restores through the WAL) drive a
    reference `LifecycleMachine` and the port's twin below.  After every
    step one planner query is answered by both: estimates, group keys,
    CI halfwidths and partitions read are byte-equal on the host backend;
    on ``ExecOptions(device="cpu")`` (the kernels' plain versions) the
    estimates and halfwidths agree within rtol 1e-5, the tolerance of
    `tests/test_torch_planner.py`.  After each compaction or rebalance
    the port's folded sketches equal the reference's field by field.
  * **the port's own machine** — a twin of ``tests/lifecycle_machine.py``
    over `repro_torch`: after every step a query answered through the
    live session's folded state must be byte-equal to one answered by a
    from-scratch planner (fresh sketches, answer store and views on the
    same physical table, tombstones and directory); a failing sequence
    is shrunk (ddmin-lite) to a minimal reproducer.  Its lanes are the
    reference's `tests/test_lifecycle.py` without the mesh planes.
"""
import copy
import dataclasses
import itertools
import os
import tempfile

import numpy as np
import pytest

import repro.api as ref_api
from repro import lifecycle as ref_lifecycle
from repro.backends import ExecOptions as RefExecOptions
from repro.core import sketches as ref_sketches
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.data.table import append_partitions as ref_append_partitions
from repro_torch import carry, lifecycle, wal
from repro_torch.api import ExecOptions, QuerySpec, Session
from repro_torch.core import sketches as sketches_mod
from repro_torch.core.features import FeatureBuilder
from repro_torch.core.picker import PickerConfig, PS3Picker
from repro_torch.core.sketches import build_sketches, gather_sketches
from repro_torch.data.datasets import make_dataset
from repro_torch.data.table import append_partitions
from repro_torch.errors import InjectedCrash
from repro_torch.faults import FaultInjector, FaultPolicy
from repro_torch.planner import QueryPlanner, ViewStore
from repro_torch.queries.engine import AnswerStore, per_partition_answers
from repro_torch.queries.ir import Aggregate

import lifecycle_machine as ref_machine
from lifecycle_machine import CRASH_POINTS, ops_from_seed
import torch_threads

torch_threads.cap_under_xdist()

pytestmark = pytest.mark.lifecycle

SEED = 20260807
HOST = ExecOptions(backend="host", device="cpu")
DEVICE = ExecOptions(device="cpu")
REF_HOST = RefExecOptions(backend="host")
SKETCH_FIELDS = ("measures", "hist_edges", "cat_counts", "ndv", "dv_freq", "hh_stats",
                 "global_hh", "bitmap", "part_spans")


class ParityError(AssertionError):
    """A live answer diverged from the cold-rebuild oracle."""


@dataclasses.dataclass
class SharedArtifacts:
    """Once-per-module state every sequence shares: the base table and
    one trained picker (funnel, cluster mask, config)."""

    base_table_ctor: object  # () -> Table, a fresh copy
    funnel: object
    cluster_mask: np.ndarray
    picker_config: PickerConfig
    queries: list
    view_spec: tuple  # (groupby, aggregates)


@pytest.fixture(scope="module")
def ref_shared():
    """The reference machine's artifacts: its picker is trained here, once."""
    return ref_machine.build_shared(REF_HOST, parts=8, rows=32, seed=SEED % 1000)


@pytest.fixture(scope="module")
def shared(ref_shared):
    """The same artifacts carried into the port (the reference's weights)."""
    base = carry.table(ref_shared.base_table_ctor())
    groupby, aggs = ref_shared.view_spec
    return SharedArtifacts(
        base_table_ctor=lambda: copy.deepcopy(base),
        funnel=carry.funnel(ref_shared.funnel),
        cluster_mask=np.array(ref_shared.cluster_mask, copy=True),
        picker_config=PickerConfig(**dataclasses.asdict(ref_shared.picker_config)),
        queries=carry.queries(ref_shared.queries),
        view_spec=(tuple(groupby), tuple(
            Aggregate(a.kind, tuple((float(c), str(col)) for c, col in a.terms)) for a in aggs)),
    )


@pytest.fixture()
def dirs(tmp_path):
    counter = itertools.count()

    def factory():
        d = tmp_path / f"seq{next(counter)}"
        d.mkdir()
        return str(d)

    return factory


# --------------------------------------------------------------------------
# the port's machine (twin of tests/lifecycle_machine.py)
# --------------------------------------------------------------------------
def _append_delta(machine_seed: int, parts: int, rows: int) -> dict:
    d = make_dataset("kdd", num_partitions=parts, rows_per_partition=rows,
                     seed=100_000 + machine_seed)
    return dict(d.columns)


class LifecycleMachine:
    """A live port `Session` driven through lifecycle ops, every mutation
    through the WAL, so a crash-restore recovers at any point."""

    def __init__(self, shared: SharedArtifacts, options: ExecOptions, dirpath: str):
        self.shared = shared
        self.options = options
        self.dir = dirpath
        table = shared.base_table_ctor()
        lifecycle.ensure_directory(table)
        self.rows = table.rows_per_partition
        self.sess = Session(table, options=options)
        self._graft(self.sess)
        self.sess.register_view(*shared.view_spec)
        self.sess.save(os.path.join(dirpath, "snapshot"))
        self.log = wal.WriteAheadLog(os.path.join(dirpath, "wal"))
        self.steps = 0

    def _graft(self, sess: Session) -> None:
        fb = FeatureBuilder(sess.table, sess.sketches.sketches())
        sess.picker = PS3Picker(sess.table, fb, self.shared.funnel, self.shared.cluster_mask,
                                self.shared.picker_config, options=self.options)
        sess.planner = QueryPlanner(sess.picker, sess.answers, views=sess.views,
                                    config=sess.planner_config)
        sess._fb_version = sess.table.version

    def _delete_targets(self, frac: float, count: int) -> np.ndarray | None:
        t = self.sess.table
        live_ext = np.sort(t.ext_ids[t.live_mask()])
        if live_ext.size <= count:  # never delete the last live partition
            return None
        start = int(frac * live_ext.size) % live_ext.size
        idx = (start + np.arange(count)) % live_ext.size
        return live_ext[np.unique(idx)]

    def _apply_mutation(self, log: wal.WriteAheadLog, op: tuple) -> bool:
        """One mutation through ``log``; False = a deterministic skip."""
        t = self.sess.table
        if op[0] == "append":
            log.append(t, _append_delta(op[2], op[1], self.rows))
        elif op[0] == "delete":
            targets = self._delete_targets(op[1], op[2])
            if targets is None:
                return False
            log.delete(t, targets)
        elif op[0] == "compact":
            log.compact(t)
        elif op[0] == "rebalance":
            log.rebalance(t, lifecycle.rebalance_plan(t, op[1]))
        else:
            raise AssertionError(f"not a mutation: {op!r}")
        return True

    def apply(self, op: tuple) -> None:
        if op[0] == "snapshot":
            self.sess.save(os.path.join(self.dir, "snapshot"))
            self.log.truncate()
        elif op[0] == "crash":
            inner = (op[1],) if op[1] == "compact" else {
                "append": ("append", 1, op[3]),
                "delete": ("delete", (op[3] % 97) / 97.0, 1),
                "rebalance": ("rebalance", 1 + op[3] % 4),
            }[op[1]]
            injected = wal.WriteAheadLog(
                os.path.join(self.dir, "wal"),
                injector=FaultInjector(FaultPolicy(seed=op[3]).with_crash(op[2])),
            )
            try:
                self._apply_mutation(injected, inner)
            except InjectedCrash:
                pass  # the "process" died; recover below
            self.sess = wal.recover(self.dir, options=self.options)
            self.log = wal.WriteAheadLog(os.path.join(self.dir, "wal"))
        else:
            self._apply_mutation(self.log, op)
        self.steps += 1

    def _oracle(self) -> QueryPlanner:
        """A from-scratch planner on the session's current physical state."""
        t = self.sess.table
        fb = FeatureBuilder(t, build_sketches(t, options=self.options))
        picker = PS3Picker(t, fb, self.shared.funnel, self.shared.cluster_mask,
                           self.shared.picker_config, options=self.options)
        views = ViewStore(t, options=self.options)
        for v in self.sess.views._views:
            views.register(v.groupby, v.aggregates)
        return QueryPlanner(picker, AnswerStore(t, options=self.options), views=views,
                            config=self.sess.planner_config)

    def query(self):
        return self.shared.queries[self.steps % len(self.shared.queries)]

    def check(self, tag: str = "") -> None:
        """A query answered live and cold; any divergence, or a raise on
        either path, is a `ParityError` (so crashes shrink too)."""
        try:
            q = self.query()
            live = self.sess.execute(QuerySpec(q, error_bound=0.05))
            cold = self._oracle().answer(q, error_bound=0.05)
        except Exception as e:
            raise ParityError(f"{tag}: query path raised {type(e).__name__}: {e}") from e
        for field in ("group_keys", "estimate", "ci_halfwidth"):
            a, b = getattr(live, field), getattr(cold, field)
            if a.tobytes() != b.tobytes():
                raise ParityError(f"{tag}: {field} diverged from the cold oracle\n"
                                  f"live: {a!r}\ncold: {b!r}")
        if live.partitions_read != cold.partitions_read:
            raise ParityError(f"{tag}: partitions_read {live.partitions_read} != "
                              f"oracle {cold.partitions_read}")


def run_sequence(shared, ops, options, dirpath) -> LifecycleMachine:
    """``ops`` on a fresh machine, parity-checked after every step."""
    m = LifecycleMachine(shared, options, dirpath)
    m.check("initial state")
    for i, op in enumerate(ops):
        m.apply(op)
        m.check(f"after op {i} {op!r}")
    return m


def _fails(shared, ops, options, dirs) -> bool:
    try:
        run_sequence(shared, ops, options, dirs())
        return False
    except ParityError:
        return True


def shrink(shared, ops, options, dirs) -> list[tuple]:
    """ddmin-lite: drop chunks (halving sizes), then single ops, while the
    rest still fails."""
    current = list(ops)
    chunk = max(1, len(current) // 2)
    while chunk >= 1:
        i = 0
        while i < len(current):
            candidate = current[:i] + current[i + chunk:]
            if candidate and _fails(shared, candidate, options, dirs):
                current = candidate
            else:
                i += chunk
        chunk //= 2
    return current


def run_seeded(shared, seed: int, n_ops: int, options, dirs) -> None:
    """One seeded sequence; a parity failure is shrunk and re-raised with
    a replayable reproducer."""
    ops = ops_from_seed(seed, n_ops)
    try:
        run_sequence(shared, ops, options, dirs())
    except ParityError as e:
        minimal = shrink(shared, ops, options, dirs)
        err = ParityError(f"lifecycle parity failure (seed={seed}); shrunk to "
                          f"{len(minimal)} op(s):\n  {minimal!r}\noriginal failure: {e}")
        err.minimal = minimal
        raise err from e


# --------------------------------------------------------------------------
# port against reference, step by step
# --------------------------------------------------------------------------
def assert_sketches_equal(got, want):
    assert got.num_partitions == want.num_partitions
    for name, w in want.columns.items():
        g = got.columns[name]
        for field in SKETCH_FIELDS:
            a, b = getattr(g, field), getattr(w, field)
            assert (a is None) == (b is None), (name, field)
            if b is not None:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (name, field)
        assert g.hh_items == w.hh_items, name
        assert g.discrete_span == w.discrete_span, name


def _assert_same_answer(got, want, options, tag):
    assert got.partitions_read == want.partitions_read, tag
    np.testing.assert_array_equal(got.group_keys, want.group_keys, err_msg=tag)
    if options.backend == "host":
        for field in ("estimate", "ci_halfwidth"):
            assert getattr(got, field).tobytes() == getattr(want, field).tobytes(), (tag, field)
    else:
        np.testing.assert_allclose(got.estimate, want.estimate, rtol=1e-5, err_msg=tag)
        # a halfwidth is a spread of per-partition f32 sums: their rounding
        # counts against the estimate's magnitude (tests/test_torch_planner.py)
        scale = np.abs(np.nan_to_num(want.estimate))
        err = np.abs(got.ci_halfwidth - want.ci_halfwidth)
        assert np.all(err <= 1e-5 * (np.abs(want.ci_halfwidth) + scale)), tag


def _run_against_reference(shared, ref_shared, ops, options, dirs):
    ref = ref_machine.LifecycleMachine(ref_shared, REF_HOST, dirs())
    port = LifecycleMachine(shared, options, dirs())
    for i, op in enumerate([None] + list(ops)):
        if op is not None:
            ref.apply(op)
            port.apply(op)
        tag = f"step {i} {op!r}"
        q_ref = ref.shared.queries[ref.steps % len(ref.shared.queries)]
        want = ref.sess.execute(ref_api.QuerySpec(q_ref, error_bound=0.05))
        got = port.sess.execute(QuerySpec(port.query(), error_bound=0.05))
        _assert_same_answer(got, want, options, tag)
        t, rt = port.sess.table, ref.sess.table
        assert (t.version, t.tombstones, t.ext_ids.tolist()) == (
            rt.version, rt.tombstones, rt.ext_ids.tolist()), tag
        if options.backend == "host" and op is not None and op[0] in ("compact", "rebalance"):
            assert_sketches_equal(port.sess.sketches.sketches(),
                                  carry.sketches(ref.sess.sketches.sketches()))
    return port


@pytest.mark.parametrize("options,seeds", [(HOST, range(8)), (DEVICE, range(8, 11))],
                         ids=["host", "device"])
def test_port_matches_reference_step_by_step(shared, ref_shared, dirs, options, seeds):
    """Seeded sequences of 4 ops: after every step the port's answer is
    the reference's (byte-equal on the host backend, rtol 1e-5 on the
    device backend's plain versions)."""
    moves = 0
    for s in seeds:
        ops = ops_from_seed(SEED + s, 4)
        moves += sum(op[0] in ("compact", "rebalance") for op in ops)
        _run_against_reference(shared, ref_shared, ops, options, dirs)
    assert moves > 0  # the seeds do reach the gathers


@pytest.mark.parametrize("layout", ["compact", "rebalance"])
def test_gather_sketches_matches_reference(layout):
    """`gather_sketches` on the same sketches and index map gives the
    reference's field by field, including a discrete span that an append
    blew and the survivors bring back under the cap (recomputed exact
    counts) and the categorical heavy hitters re-folded in the gathered
    order."""
    ref_table = ref_make_dataset("kdd", num_partitions=8, rows_per_partition=32, seed=3)
    col = ref_table.numeric_columns[0]
    codes = np.random.default_rng(3).integers(0, 7, size=ref_table.columns[col].shape)
    ref_table.columns[col] = codes.astype(np.float32)  # a discrete column
    wide = {k: np.array(v[:2], copy=True) for k, v in ref_table.columns.items()}
    wide[col][:] = 1e6  # integral but far outside the span: disqualifies it
    ref_append_partitions(ref_table, wide)
    ref_lifecycle.ensure_directory(ref_table)
    table = carry.table(ref_table)
    lifecycle.ensure_directory(table)
    ref_sk = ref_sketches.build_sketches(ref_table, options=REF_HOST)
    sk = carry.sketches(ref_sk)
    assert sk.columns[col].discrete_span is None
    if layout == "compact":
        ref_lifecycle.delete_partitions(ref_table, [8, 9, 2])
        lifecycle.delete_partitions(table, [8, 9, 2])
        idx = lifecycle.compact(table)
        ref_idx = ref_lifecycle.compact(ref_table)
    else:
        perm = lifecycle.rebalance_plan(table, 3)
        idx = lifecycle.rebalance(table, perm)
        ref_idx = ref_lifecycle.rebalance(ref_table, perm)
    got = gather_sketches(sk, table, idx)
    want = ref_sketches.gather_sketches(ref_sk, ref_table, ref_idx)
    assert_sketches_equal(got, carry.sketches(want))
    if layout == "compact":
        assert got.columns[col].discrete_span is not None  # re-qualified
    assert_sketches_equal(got, build_sketches(table, options=HOST))


# --------------------------------------------------------------------------
# the port's own machine: lanes of tests/test_lifecycle.py
# --------------------------------------------------------------------------
def test_fast_lane_randomized_parity(shared, dirs):
    """40 seeded sequences of append/delete/compact/rebalance/snapshot/
    crash-restore, every step byte-equal to the cold oracle."""
    for i in range(40):
        run_seeded(shared, SEED + i, 4, HOST, dirs)


def test_device_lane_parity(shared, dirs):
    """The device backend (the kernels' plain versions on the CPU): live
    folds against the cold oracle on the same backend, byte-equal."""
    for i in range(2):
        run_seeded(shared, SEED + 1000 + i, 3, DEVICE, dirs)


@pytest.mark.parametrize("mesh", [2, 8], ids=["mesh2", "mesh8"])
def test_mesh_parity(shared, dirs, mesh):
    """The reference's plane lanes on ``mesh`` logical CPU shards: the
    machine's live folds (stack writes across shards, re-pads, in-bucket
    rewrites) against the cold oracle on the same plane, byte-equal."""
    for i in range(2):
        run_seeded(shared, SEED + 1000 + i, 3, DEVICE.replace(mesh=mesh), dirs)


def test_no_full_rebuilds_along_a_checked_sequence(shared, dirs):
    """Folding is O(touched): a crash-free sequence with a query after
    every op never falls back to a full sketch rebuild."""
    ops = [("delete", 0.3, 2), ("rebalance", 3), ("append", 2, 41), ("delete", 0.7, 1),
           ("compact",), ("rebalance", 2), ("append", 1, 42)]
    m = run_sequence(shared, ops, HOST, dirs())
    assert m.sess.sketches.full_rebuilds == 0
    assert m.sess.sketches.incremental_updates >= len(ops)
    assert m.sess.stats()["num_live"] == m.sess.table.num_live


def test_device_stack_rewritten_in_bucket(shared, dirs):
    """A compaction and a rebalance rewrite the device stack in its shape
    bucket (``stack_rewrites``), and full-table answers over it stay
    bit-identical to a cold evaluation."""
    m = LifecycleMachine(shared, DEVICE, dirs())
    q = shared.queries[0]
    m.apply(("append", 2, 7))
    stack = m.sess.answers._eval_cache.device_stack()
    m.apply(("delete", 0.2, 1))
    m.apply(("compact",))
    m.sess.answers.get(q)  # sync: the compaction folds (rewrite 1); a
    # compact+rebalance chain with no sync between is not foldable
    m.apply(("rebalance", 2))
    live = m.sess.answers.get(q)
    cold = per_partition_answers(m.sess.table, q, options=DEVICE)
    assert live.raw.tobytes() == cold.raw.tobytes()
    assert live.group_keys.tobytes() == cold.group_keys.tobytes()
    cache = m.sess.answers._eval_cache
    assert m.sess.stats()["stack_rewrites"] == 2
    assert cache.device_stack() is stack and cache.stack_rebuilds == 1
    n = m.sess.table.num_partitions
    assert not cache.device_stack()[:, n:].any()  # the dead tail is zero
    m.check("after stack rewrites")


def test_planted_parity_bug_caught_and_shrunk(shared, dirs, monkeypatch):
    """Plant a real-shaped bug — compaction and rebalance forget to
    gather the sketch rows — and require the harness to catch it and
    shrink the failing sequence to at most 5 ops."""
    monkeypatch.setattr(sketches_mod, "gather_sketches", lambda sk, table, idx: sk)
    for seed in range(40):
        if not any(o[0] in ("rebalance", "compact") for o in ops_from_seed(seed, 4)):
            continue
        try:
            run_seeded(shared, seed, 4, HOST, dirs)
        except ParityError as e:
            assert len(e.minimal) <= 5, f"shrinker left {len(e.minimal)} ops: {e.minimal!r}"
            assert any(o[0] in ("rebalance", "compact") for o in e.minimal)
            return
    raise AssertionError("planted sketch-staleness bug was never caught")


def test_delete_is_not_out_of_band_mutation(shared, dirs):
    """Tombstones are part of the fingerprint, and a delete refreshes the
    caches' copy: delete, append, query raises no `StaleStateError`."""
    m = LifecycleMachine(shared, HOST, dirs())
    m.check("warm")
    fp0 = m.sess.table.fingerprint()
    m.apply(("delete", 0.4, 1))
    assert m.sess.table.fingerprint() != fp0
    m.check("after delete")
    m.apply(("append", 1, 17))
    m.check("after delete+append")


# --------------------------------------------------------------------------
# WAL replay keyed on the version, snapshots of lifecycle state, validation
# --------------------------------------------------------------------------
def _base_table(parts=10, seed=5):
    t = make_dataset("kdd", num_partitions=parts, rows_per_partition=32, seed=seed)
    lifecycle.ensure_directory(t)
    return t


def _delta_cols(parts=2, seed=9):
    return dict(make_dataset("kdd", num_partitions=parts, rows_per_partition=32,
                             layout="random", seed=seed).columns)


@pytest.mark.parametrize("point", CRASH_POINTS)
def test_wal_crash_at_first_delete_record(tmp_path, point):
    """A crash at every point of the first delete record: recovery lands on
    the pre- or post-delete state, and replay is idempotent."""
    ref = _base_table()
    log = wal.WriteAheadLog(str(tmp_path))
    log.append(ref, _delta_cols())
    victim = wal.WriteAheadLog(
        str(tmp_path), injector=FaultInjector(FaultPolicy(seed=SEED).with_crash(point)))
    with pytest.raises(InjectedCrash):
        victim.delete(ref, [3, 5])
    recovered = _base_table()
    wal.WriteAheadLog(str(tmp_path)).replay(recovered)
    assert recovered.tombstones == (set() if point == "wal.record" else {3, 5})
    assert wal.WriteAheadLog(str(tmp_path)).replay(recovered) == 0


def test_version_keyed_replay_survives_shrinking_partition_count(tmp_path):
    """delete + compact bring the table back to an earlier partition
    count; version keying replays the whole history exactly, twice."""
    ref = _base_table()
    log = wal.WriteAheadLog(str(tmp_path))
    log.append(ref, _delta_cols(2, 11))  # 10 -> 12 partitions
    log.delete(ref, [1, 4])
    log.compact(ref)  # back to 10 partitions
    log.rebalance(ref, lifecycle.rebalance_plan(ref, 2))
    log.delete(ref, [7])
    log.append(ref, _delta_cols(1, 13))
    recovered = _base_table()
    assert wal.WriteAheadLog(str(tmp_path)).replay(recovered) == 6
    assert recovered.version == ref.version
    assert recovered.tombstones == ref.tombstones
    assert recovered.ext_ids.tobytes() == ref.ext_ids.tobytes()
    for k, v in ref.columns.items():
        assert v.tobytes() == recovered.columns[k].tobytes(), k
    assert wal.WriteAheadLog(str(tmp_path)).replay(recovered) == 0


def test_snapshot_roundtrips_lifecycle_state(shared, tmp_path):
    """Tombstones, the directory and the lifecycle log survive save and
    restore bit-identically, and the restored session folds on from them."""
    m = LifecycleMachine(shared, HOST, str(tmp_path))
    sess, t = m.sess, m.sess.table
    sess.delete_partitions([2, 6])
    sess.rebalance(num_shards=2)
    sess.delete_partitions([3])
    sess.save(str(tmp_path / "snap"))
    back = Session.restore(str(tmp_path / "snap"), options=HOST)
    assert back.table.tombstones == t.tombstones
    assert back.table.ext_ids.tobytes() == t.ext_ids.tobytes()
    assert back.table.next_ext == t.next_ext
    assert back.table.lifecycle_log == t.lifecycle_log
    for k, v in t.columns.items():
        assert v.tobytes() == back.table.columns[k].tobytes(), k
    back.compact()
    append_partitions(back.table, _delta_cols(2, 21))
    m.sess = back
    m.check("restored, compacted, appended")
    assert back.stats()["sketch_full_rebuilds"] == 0


def test_lifecycle_op_validation():
    t = _base_table(parts=4)
    with pytest.raises(KeyError):
        lifecycle.delete_partitions(t, [99])
    with pytest.raises(ValueError, match="duplicate"):
        lifecycle.delete_partitions(t, [1, 1])
    lifecycle.delete_partitions(t, [1])
    with pytest.raises(ValueError, match="already deleted"):
        lifecycle.delete_partitions(t, [1])
    with pytest.raises(ValueError, match="last live"):
        lifecycle.delete_partitions(t, [0, 2, 3])
    with pytest.raises(ValueError, match="permutation"):
        lifecycle.rebalance(t, np.array([0, 0, 1, 2]))
    with pytest.raises(ValueError, match="num_shards"):
        lifecycle.rebalance_plan(t, 0)
    # external ids survive compaction; the physical slots shift
    keep = lifecycle.compact(t)
    assert keep.tolist() == [0, 2, 3]
    assert t.ext_ids.tolist() == [0, 2, 3]
    assert lifecycle.resolve(t, [3]).tolist() == [2]
    sess = Session(t, options=HOST)
    with pytest.raises(ValueError, match="exactly one"):
        sess.rebalance()
    with pytest.raises(ValueError, match="exactly one"):
        sess.rebalance(num_shards=2, perm=np.arange(3))
    # WAL-level validation happens before the record is durable
    with tempfile.TemporaryDirectory() as d:
        log = wal.WriteAheadLog(d)
        with pytest.raises(ValueError):
            log.delete(t, [0, 2, 3])  # last-live guard
        with pytest.raises(ValueError, match="permutation"):
            log.rebalance(t, [0, 0, 1])
        assert log._record_ids() == []  # nothing was written


@pytest.mark.parametrize("options", [HOST, DEVICE], ids=["host", "device"])
def test_answer_store_folds_moves(shared, options):
    """Full cached answers survive deletes, compactions, rebalances and
    appends by folding (no miss), bit-equal to a cold evaluation of the
    table after every step; a move drops the partial answers."""
    table = shared.base_table_ctor()
    lifecycle.ensure_directory(table)
    store = AnswerStore(table, options=options)
    queries = shared.queries
    store.get_batch(queries)
    store.get_subset(queries[0], np.arange(3))
    hits, misses = store.hits, store.misses
    steps = [
        lambda: lifecycle.delete_partitions(table, [1, 5]),
        lambda: lifecycle.compact(table),
        lambda: lifecycle.rebalance(table, lifecycle.rebalance_plan(table, 3)),
        lambda: append_partitions(table, _delta_cols(2, 31)),
        lambda: lifecycle.delete_partitions(table, [0]),
        lambda: lifecycle.compact(table),
    ]
    for i, step in enumerate(steps):
        step()
        got = store.get_batch(queries)
        if i == 1:
            assert not store._partial  # the compaction dropped the partial answer
        cold = [per_partition_answers(table, q, options=options) for q in queries]
        for g, w in zip(got, cold):
            assert g.group_keys.tobytes() == w.group_keys.tobytes(), i
            assert g.raw.tobytes() == w.raw.tobytes(), i
    assert (store.hits - hits, store.misses) == (len(queries) * len(steps), misses)
