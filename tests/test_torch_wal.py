"""The port's WAL and snapshots against the JAX reference.

Twins of the reference's ``tests/test_wal.py`` without the mesh planes:
`wal.WriteAheadLog` makes every mutation durable before it applies (a
crash at any point recovers the pre- or post-mutation state, never a
torn one), `save_snapshot` / `restore_snapshot` round-trip the
session's derived state bit-identically, and `wal.recover` after a crash
gives a session whose table bytes and answers are those of one that
never crashed.  Across the packages: the two write the same log and
snapshot files for the same mutations (``derived.pkl`` apart, whose
class names differ); the port recovers a snapshot and a WAL tail the
reference wrote, to answers byte-equal to the reference session's; and
its reader of ``derived.pkl`` refuses every global outside its
allowlist without running it.

One reference picker is trained for the module (kdd, 12 partitions x 64
rows, 8 trees of depth 3, no feature selection) and carried into the
port's sessions (`carry.picker`).
"""
import copy
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import repro.api as ref_api
from repro import lifecycle as ref_lifecycle
from repro import wal as ref_wal
from repro.backends import ExecOptions as RefExecOptions
from repro.core.features import FeatureBuilder as RefFeatureBuilder
from repro.core.picker import PickerConfig as RefPickerConfig
from repro.core.picker import PS3Picker as RefPS3Picker
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.planner import QueryPlanner as RefQueryPlanner
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro_torch import api, carry, lifecycle, wal
from repro_torch.backends import ExecOptions
from repro_torch.core import sketches as sketches_mod
from repro_torch.core.features import FeatureBuilder
from repro_torch.data.datasets import make_dataset
from repro_torch.errors import InjectedCrash, StaleStateError, WalCorruptError
from repro_torch.faults import FaultInjector, FaultPolicy
from repro_torch.planner import QueryPlanner
from repro_torch.queries.generator import WorkloadSpec
import torch_threads

torch_threads.cap_under_xdist()

pytestmark = pytest.mark.chaos

SEED = 20240807
HOST = ExecOptions(backend="host", device="cpu")
DEVICE = ExecOptions(device="cpu")
REF_HOST = RefExecOptions(backend="host")
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _table(parts=12, seed=0):
    return make_dataset("kdd", num_partitions=parts, rows_per_partition=64, seed=seed)


def _delta():
    return make_dataset("kdd", num_partitions=3, rows_per_partition=64, layout="random",
                        seed=9).columns


@pytest.fixture(scope="module")
def reference():
    """A reference session on 12 kdd partitions with its trained picker."""
    t = ref_make_dataset("kdd", num_partitions=12, rows_per_partition=64, seed=0)
    sess = ref_api.Session(t, options=REF_HOST)
    sess.prepare(RefWorkloadSpec(t, seed=1), num_train_queries=8,
                 picker_config=RefPickerConfig(num_trees=8, tree_depth=3,
                                               feature_selection=False))
    return sess


def _session(reference, options=HOST, parts=12):
    """A port session over a fresh table with the reference's picker."""
    table = _table(parts=parts)
    sess = api.Session(table, options=options)
    fb = FeatureBuilder(table, sess.sketches.sketches())
    sess.picker = carry.picker(reference.picker, table, fb, options=options)
    sess.planner = QueryPlanner(sess.picker, sess.answers, views=sess.views,
                                config=sess.planner_config)
    sess._fb_version = table.version
    return sess


def _ref_session(reference):
    """A reference session over a copy of the module's table, its picker grafted."""
    table = copy.deepcopy(reference.table)
    sess = ref_api.Session(table, options=REF_HOST)
    fb = RefFeatureBuilder(table, sess.sketches.sketches())
    p = reference.picker
    sess.picker = RefPS3Picker(table, fb, p.funnel, p.cluster_mask, p.config)
    sess.planner = RefQueryPlanner(sess.picker, sess.answers, views=sess.views,
                                   config=sess.planner_config)
    sess._fb_version = table.version
    return sess


def _cols_equal(a, b):
    assert set(a.columns) == set(b.columns)
    for k, v in a.columns.items():
        assert v.tobytes() == b.columns[k].tobytes(), f"column {k} differs"


def _rewrite_derived(directory, blob):
    """Replace ``derived.pkl`` and its checksum (a coherent tampering)."""
    wal._write_atomic(os.path.join(directory, "derived.pkl"), blob)
    man_path = os.path.join(directory, "manifest.json")
    man = json.loads(open(man_path, "rb").read())
    man["files"]["derived.pkl"] = wal._sha256(blob)
    wal._write_atomic(man_path, json.dumps(man).encode())


# --------------------------------------------------------------------------
# the log: durable-then-apply, idempotent replay
# --------------------------------------------------------------------------
def test_append_then_replay_idempotent(tmp_path):
    live, stale = _table(), _table()
    log = wal.WriteAheadLog(str(tmp_path))
    delta = _delta()
    log.append(live, delta)
    assert live.num_partitions == 15
    assert log.replay(stale) == 1  # `stale` never saw the in-memory append
    _cols_equal(live, stale)
    assert log.replay(stale) == 0
    delta2 = {k: v[::-1].copy() for k, v in delta.items()}
    log.append(live, delta2)
    fresh = _table()
    assert log.replay(fresh) == 2
    _cols_equal(live, fresh)
    log.truncate()
    assert log.replay(_table()) == 0


def test_replay_rejects_corrupt_payload(tmp_path):
    log = wal.WriteAheadLog(str(tmp_path))
    log.append(_table(), _delta())
    npz_path, _ = log._paths(0)
    blob = bytearray(open(npz_path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(npz_path, "wb").write(bytes(blob))
    with pytest.raises(WalCorruptError, match="checksum"):
        log.replay(_table())


def test_replay_rejects_missing_record(tmp_path):
    table = _table()
    log = wal.WriteAheadLog(str(tmp_path))
    log.append(table, _delta())
    log.append(table, _delta())
    for path in log._paths(0):
        os.remove(path)
    with pytest.raises(WalCorruptError, match="missing"):
        log.replay(_table())


@pytest.mark.parametrize("point", ["wal.record", "wal.apply", "wal.derived"])
def test_crash_matrix_recovers_consistent_state(reference, tmp_path, point):
    """A crash at every point of the append sequence: before the record
    is durable → pre-append; once durable → post-append.  Never torn."""
    root = str(tmp_path)
    sess = _session(reference)
    wal.save_snapshot(sess, os.path.join(root, "snapshot"))
    delta = _delta()
    ref = api.Session.restore(os.path.join(root, "snapshot"), options=HOST)
    if point != "wal.record":
        wal.WriteAheadLog(os.path.join(root, "wal_ref")).append(ref.table, delta)
    log = wal.WriteAheadLog(os.path.join(root, "wal"),
                            injector=FaultInjector(FaultPolicy(seed=SEED).with_crash(point)))
    with pytest.raises(InjectedCrash) as ei:
        log.append(sess.table, delta)
    assert ei.value.point == point
    assert log._record_ids() == ([] if point == "wal.record" else [0])
    recovered = wal.recover(root, options=HOST)
    assert recovered.table.num_partitions == ref.table.num_partitions
    _cols_equal(recovered.table, ref.table)
    assert recovered.table.version == ref.table.version


# --------------------------------------------------------------------------
# snapshots: completeness checks + derived-state round trip
# --------------------------------------------------------------------------
def test_restore_requires_manifest(tmp_path):
    with pytest.raises(WalCorruptError, match="manifest"):
        api.Session.restore(str(tmp_path), options=HOST)


def test_restore_rejects_corrupt_derived_state(reference, tmp_path):
    d = str(tmp_path / "snap")
    wal.save_snapshot(_session(reference), d)
    blob = bytearray(open(os.path.join(d, "derived.pkl"), "rb").read())
    blob[len(blob) // 3] ^= 0xFF
    open(os.path.join(d, "derived.pkl"), "wb").write(bytes(blob))
    with pytest.raises(WalCorruptError, match="checksum"):
        api.Session.restore(d, options=HOST)


def test_restore_rejects_stale_sketches(reference, tmp_path):
    """Derived state of a table of another shape must not graft: the
    restore guard raises `StaleStateError` (tampered coherently, so only
    the semantic guard can catch it)."""
    d = str(tmp_path / "snap")
    wal.save_snapshot(_session(reference, parts=12), d)
    other = api.Session(_table(parts=8), options=HOST)
    derived = wal.load_derived(d)
    derived["sketches"] = other.sketches.sketches()
    _rewrite_derived(d, pickle.dumps(derived, protocol=pickle.HIGHEST_PROTOCOL))
    with pytest.raises(StaleStateError, match="partitions"):
        api.Session.restore(d, options=HOST)


def test_snapshot_roundtrip_restores_all_derived_state(reference, tmp_path):
    """Sketches, views, answer caches and the trained picker survive the
    round trip: the restored session answers view queries with zero
    reads, serves cached answers without evaluating, and its planner
    gives bit-identical estimates."""
    sess = _session(reference)
    gcol = sess.table.groupable_columns[0]
    q = api.Query((api.Aggregate("count"),), api.Predicate(), (gcol,))
    sess.register_view((gcol,), q.aggregates)
    spec = api.QuerySpec(q, error_bound=0.10)
    ans0 = sess.execute(spec)
    full = sess.answers.get(q)

    d = str(tmp_path / "snap")
    wal.save_snapshot(sess, d)
    rest = api.Session.restore(d, options=HOST)
    a, b = sess.sketches.sketches(), rest.sketches.sketches()
    for name, ca in a.columns.items():
        assert np.array_equal(ca.measures, b.columns[name].measures), name
    ans1 = rest.execute(spec)
    assert ans1.plan.mode == "view" and ans1.partitions_read == 0
    assert ans1.estimate.tobytes() == ans0.estimate.tobytes()
    hits0, misses0 = rest.answers.hits, rest.answers.misses
    again = rest.answers.get(q)
    assert (rest.answers.hits, rest.answers.misses) == (hits0 + 1, misses0)
    assert again.raw.tobytes() == full.raw.tobytes()
    q2 = WorkloadSpec(sess.table, seed=77).sample_workload(1)[0]
    pa_live = sess.planner.answer(q2, budget=6)
    pa_rest = rest.planner.answer(q2, budget=6)
    assert pa_live.estimate.tobytes() == pa_rest.estimate.tobytes()
    assert np.array_equal(pa_live.group_keys, pa_rest.group_keys)


def test_crash_recovery_bit_identical_on_the_device_backend(reference, tmp_path):
    """The single-device case of the reference's acceptance matrix: a
    crash with the record durable but unapplied, recovered on the device
    backend (the stack rebuilds from the restored host columns)."""
    root = str(tmp_path)
    sess = _session(reference, options=DEVICE)
    q = WorkloadSpec(sess.table, seed=5).sample_workload(1)[0]
    wal.save_snapshot(sess, os.path.join(root, "snapshot"))
    delta = _delta()
    ref = api.Session.restore(os.path.join(root, "snapshot"), options=DEVICE)
    wal.WriteAheadLog(os.path.join(root, "wal_ref")).append(ref.table, delta)
    ans_ref = ref.execute(api.QuerySpec(q, budget=ref.table.num_partitions))
    log = wal.WriteAheadLog(os.path.join(root, "wal"),
                            injector=FaultInjector(FaultPolicy(seed=SEED).with_crash("wal.apply")))
    with pytest.raises(InjectedCrash):
        log.append(sess.table, delta)
    recovered = wal.recover(root, options=DEVICE)
    _cols_equal(recovered.table, ref.table)
    assert recovered.table.version == ref.table.version
    ans_rec = recovered.execute(api.QuerySpec(q, budget=recovered.table.num_partitions))
    assert ans_rec.estimate.tobytes() == ans_ref.estimate.tobytes()
    assert np.array_equal(ans_rec.group_keys, ans_ref.group_keys)
    assert ans_rec.ci_halfwidth.tobytes() == ans_ref.ci_halfwidth.tobytes()
    assert recovered.answers._eval_cache.device_stack().device.type == "cpu"


@pytest.mark.parametrize("mesh", [2, 8], ids=["mesh2", "mesh8"])
def test_crash_recovery_bit_identical_across_meshes(reference, tmp_path, mesh):
    """The reference's plane lanes of its acceptance matrix on ``mesh``
    logical CPU shards: the recovered Session re-shards its stack from the
    restored host columns and answers byte-equal to a Session restored
    from the same snapshot that never crashed."""
    opts = DEVICE.replace(mesh=mesh)
    root = str(tmp_path)
    sess = _session(reference, options=opts)
    q = WorkloadSpec(sess.table, seed=5).sample_workload(1)[0]
    wal.save_snapshot(sess, os.path.join(root, "snapshot"))
    delta = _delta()
    ref = api.Session.restore(os.path.join(root, "snapshot"), options=opts)
    wal.WriteAheadLog(os.path.join(root, "wal_ref")).append(ref.table, delta)
    ans_ref = ref.execute(api.QuerySpec(q, budget=ref.table.num_partitions))
    log = wal.WriteAheadLog(os.path.join(root, "wal"),
                            injector=FaultInjector(FaultPolicy(seed=SEED).with_crash("wal.apply")))
    with pytest.raises(InjectedCrash):
        log.append(sess.table, delta)
    recovered = wal.recover(root, options=opts)
    _cols_equal(recovered.table, ref.table)
    assert recovered.table.version == ref.table.version
    ans_rec = recovered.execute(api.QuerySpec(q, budget=recovered.table.num_partitions))
    assert ans_rec.estimate.tobytes() == ans_ref.estimate.tobytes()
    assert np.array_equal(ans_rec.group_keys, ans_ref.group_keys)
    assert ans_rec.ci_halfwidth.tobytes() == ans_ref.ci_halfwidth.tobytes()
    assert len(recovered.answers._eval_cache.device_stack().shards) == mesh


# --------------------------------------------------------------------------
# across the packages
# --------------------------------------------------------------------------
def _warm(sess, queries, spec):
    """Fill a session's caches: a view, full answers and partial answers."""
    gcol = sess.table.groupable_columns[0]
    sess.register_view((gcol,), queries[0].aggregates)
    sess.answers.get_batch(queries)
    for q in queries:
        sess.execute(spec(q, error_bound=0.05))


def test_port_recovers_a_reference_snapshot_and_wal_tail(reference, tmp_path):
    """The reference writes a snapshot and a WAL tail (an append, a
    delete, a compaction); the port recovers them with its own `recover`
    to answers byte-equal to the reference session's.  The two packages
    write byte-equal log records, ``table.npz`` and ``meta.json``."""
    root, mine = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_sess = _ref_session(reference)
    ref_lifecycle.ensure_directory(ref_sess.table)
    ref_queries = RefWorkloadSpec(ref_sess.table, seed=7).sample_workload(4)
    _warm(ref_sess, ref_queries, ref_api.QuerySpec)
    ref_wal.save_snapshot(ref_sess, os.path.join(root, "snapshot"))
    port_sess = wal.restore_snapshot(api.Session, os.path.join(root, "snapshot"), options=HOST)
    assert type(port_sess.sketches.sketches()) is sketches_mod.TableSketches
    assert port_sess.answers._cache and port_sess.answers._partial and len(port_sess.views)
    wal.save_snapshot(port_sess, os.path.join(mine, "snapshot"))

    delta = dict(_delta())
    ref_log = ref_wal.WriteAheadLog(os.path.join(root, "wal"))
    ref_log.append(ref_sess.table, delta)
    ref_log.delete(ref_sess.table, [2, 13])
    ref_log.compact(ref_sess.table)
    log = wal.WriteAheadLog(os.path.join(mine, "wal"))
    log.append(port_sess.table, delta)
    log.delete(port_sess.table, [2, 13])
    log.compact(port_sess.table)
    for name in sorted(os.listdir(os.path.join(root, "wal"))):
        assert open(os.path.join(root, "wal", name), "rb").read() == open(
            os.path.join(mine, "wal", name), "rb").read(), name
    for name in ("table.npz", "meta.json"):
        assert open(os.path.join(root, "snapshot", name), "rb").read() == open(
            os.path.join(mine, "snapshot", name), "rb").read(), name

    recovered = wal.recover(root, options=HOST)
    _cols_equal(recovered.table, ref_sess.table)
    assert recovered.table.tombstones == ref_sess.table.tombstones == set()
    assert recovered.table.ext_ids.tobytes() == ref_sess.table.ext_ids.tobytes()
    assert recovered.table.lifecycle_log == ref_sess.table.lifecycle_log
    for rq, q in zip(ref_queries, carry.queries(ref_queries)):
        for ref_spec, spec in ((ref_api.QuerySpec(rq, error_bound=0.05),
                                api.QuerySpec(q, error_bound=0.05)),
                               (ref_api.QuerySpec(rq, budget=6), api.QuerySpec(q, budget=6))):
            want, got = ref_sess.execute(ref_spec), recovered.execute(spec)
            assert got.partitions_read == want.partitions_read
            for field in ("group_keys", "estimate", "ci_halfwidth"):
                assert getattr(got, field).tobytes() == getattr(want, field).tobytes(), field
    # the append is read after a later compaction moved it: not foldable
    # (events_foldable), in either package
    assert recovered.stats()["sketch_full_rebuilds"] == ref_sess.stats()[
        "sketch_full_rebuilds"] == 1


def test_reference_derived_state_loads_without_the_reference(reference, tmp_path):
    """A reference ``derived.pkl`` names ``repro.`` classes; the port's
    reader maps them to its own without importing ``repro`` (checked in a
    fresh interpreter), and the port writes only ``repro_torch.`` and
    numpy names."""
    ref_sess = _ref_session(reference)
    ref_queries = RefWorkloadSpec(ref_sess.table, seed=7).sample_workload(2)
    _warm(ref_sess, ref_queries, ref_api.QuerySpec)
    d = str(tmp_path / "snap")
    ref_wal.save_snapshot(ref_sess, d)
    code = (
        "import sys\n"
        "from repro_torch import wal\n"
        f"derived = wal.load_derived({d!r})\n"
        "assert type(derived['sketches']).__module__ == 'repro_torch.core.sketches'\n"
        "leaked = sorted(m for m in sys.modules if m == 'repro' or m.startswith('repro.')"
        " or m == 'jax' or m.startswith('jax.'))\n"
        "assert not leaked, leaked\n"
        "print(len(derived['answers_cache']), len(derived['views']))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "1"]

    port = wal.restore_snapshot(api.Session, d, options=HOST)
    mine = str(tmp_path / "mine")
    wal.save_snapshot(port, mine)
    seen = []

    class Recorder(wal._SnapshotUnpickler):
        def find_class(self, module, name):
            seen.append(module)
            return super().find_class(module, name)

    Recorder(open(os.path.join(mine, "derived.pkl"), "rb").read()).load()
    assert seen and all(m.startswith(("repro_torch.", "numpy")) for m in seen), set(seen)


class _Shell:
    """Unpickling this runs a shell command (the attack the allowlist stops)."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


def test_derived_reader_refuses_globals_outside_the_allowlist(reference, tmp_path):
    d = str(tmp_path / "snap")
    wal.save_snapshot(_session(reference), d)
    derived = wal.load_derived(d)
    marker = tmp_path / "ran"
    derived["views"] = [_Shell(str(marker))]
    _rewrite_derived(d, pickle.dumps(derived, protocol=pickle.HIGHEST_PROTOCOL))
    with pytest.raises(WalCorruptError, match="allowlist"):
        api.Session.restore(d, options=HOST)
    assert not marker.exists()
    # an allowlisted name whose pickled state lacks a field: refused whole
    state = pickle.dumps({"col": "flag", "op": "=="}, protocol=2)[2:-1]
    blob = (b"\x80\x02}X\x01\x00\x00\x00q" + b"crepro.queries.ir\nClause\n)\x81"
            + state + b"bs.")
    with pytest.raises(WalCorruptError, match="fields"):
        wal.load_derived_bytes(blob)
    with pytest.raises(WalCorruptError, match="allowlist"):
        wal.load_derived_bytes(b"\x80\x02cbuiltins\neval\n.")


def test_lifecycle_through_the_wal_recovers(reference, tmp_path):
    """Delete, rebalance and compact records replay onto the snapshot,
    and the recovered session answers as the live one."""
    root = str(tmp_path)
    sess = _session(reference)
    lifecycle.ensure_directory(sess.table)
    sess.save(os.path.join(root, "snapshot"))
    log = wal.WriteAheadLog(os.path.join(root, "wal"))
    log.delete(sess.table, [1, 4, 7])
    log.rebalance(sess.table, lifecycle.rebalance_plan(sess.table, 3))
    log.compact(sess.table)
    recovered = wal.recover(root, options=HOST)
    _cols_equal(recovered.table, sess.table)
    assert recovered.stats()["num_live"] == sess.stats()["num_live"] == 9
    q = WorkloadSpec(sess.table, seed=3).sample_workload(1)[0]
    a = sess.execute(api.QuerySpec(q, error_bound=0.05))
    b = recovered.execute(api.QuerySpec(q, error_bound=0.05))
    assert a.estimate.tobytes() == b.estimate.tobytes()
    assert a.partitions_read == b.partitions_read
