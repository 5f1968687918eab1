"""Durability: a write-ahead log of table mutations and snapshots of all
derived state, so a crash at any point recovers bit-identically.

Two cooperating pieces, in the JAX reference's on-disk format byte for
byte (a snapshot or log written by either package has the same files):

* **`WriteAheadLog`** — the mutation log.  `append(table, delta)` makes
  the delta *durable before it is applied*: the delta columns land in an
  ``NNNNNNNN.npz`` record (written to a temp file and `os.replace`d — a
  record exists iff its rename happened), then a JSON sidecar with the
  record's sha256 and the pre-mutation version, then the in-memory
  `append_partitions`.  `delete` / `compact` / `rebalance` follow the
  same durable-then-apply protocol for the lifecycle ops
  (`repro_torch.lifecycle`).  Replay is idempotent and keyed on the
  table *version* (deletes and compaction can shrink the partition
  count; versions only grow): a record applies iff its
  ``version_before`` matches the table's version, so recovery from any
  crash point lands on the pre- or post-mutation state, never a torn one.

* **Snapshots** — `save_snapshot(session, dir)` writes the table
  (``table.npz``: columns; ``meta.json``: version, logs, schema,
  tombstones, directory) and every piece of derived state the session
  owns (``derived.pkl``: sketches, views, full and partial answer
  caches, the trained picker's funnel, cluster mask and config, the
  planner config), then ``manifest.json`` with a sha256 per file, last.
  `restore_snapshot` verifies every checksum (`WalCorruptError`),
  builds ``Session(table, options)`` and grafts the derived state on.
  Device state (the `EvalCache` column stack) is never serialized: it
  rebuilds lazily on ``options.device`` from the restored host columns.

``derived.pkl`` is read by `_SnapshotUnpickler`, which resolves only an
allowlist: the port's classes of derived state — under their own
``repro_torch.`` names, or under the reference's ``repro.`` names, which
it maps to the port's twins without importing the reference — and
numpy's array reconstructors.  Any other global raises `WalCorruptError`
before anything runs, and a mapped object whose pickled attributes are
not its class's dataclass fields raises too, so no half-filled object
comes out.

Crash points (`faults.crash_point`): ``wal.record`` (before the record
is durable — the mutation is lost, pre-mutation state), ``wal.apply``
(record durable, table not yet updated — replay applies it),
``wal.derived`` (table updated, derived state not yet folded — replay
skips the record; caches fold lazily through the table's logs), and
``snapshot.begin`` / ``snapshot.files`` / ``snapshot.done`` around a
snapshot.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import io
import json
import os
import pickle

import numpy as np

from repro_torch import lifecycle
from repro_torch.data.table import ColumnSpec, Table, append_partitions
from repro_torch.errors import StaleStateError, WalCorruptError
from repro_torch.faults import FaultInjector, crash_point

_FORMAT = 1


# --------------------------------------------------------------------------
# atomic file helpers
# --------------------------------------------------------------------------
def _write_atomic(path: str, data: bytes) -> None:
    """Durable iff renamed: a crash mid-write leaves only ``*.tmp``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _read_json(path: str, what: str) -> dict:
    try:
        with open(path, "rb") as f:
            return json.loads(f.read())
    except (OSError, ValueError) as e:
        raise WalCorruptError(f"{what}: cannot read {path!r}: {e}") from e


def _read_verified(path: str, expect_sha: str, what: str) -> bytes:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise WalCorruptError(f"{what}: cannot read {path!r}: {e}") from e
    if _sha256(data) != expect_sha:
        raise WalCorruptError(f"{what}: checksum mismatch for {path!r}")
    return data


# --------------------------------------------------------------------------
# write-ahead log
# --------------------------------------------------------------------------
class WriteAheadLog:
    """Mutation log for one table: durable-then-apply appends and
    lifecycle ops.

    Records are ``NNNNNNNN.npz`` (payload) + ``NNNNNNNN.json`` (sha256,
    type, version and partition count before); a record exists iff its
    sidecar does, so a crash between the two writes leaves an ignorable
    orphan ``.npz``, never a half-record.
    """

    def __init__(self, directory: str, injector: FaultInjector | None = None):
        self.directory = directory
        self.injector = injector
        os.makedirs(directory, exist_ok=True)

    # ---- record enumeration ------------------------------------------------
    def _record_ids(self) -> list[int]:
        ids = []
        for name in os.listdir(self.directory):
            if name.endswith(".json"):
                stem = name[: -len(".json")]
                if stem.isdigit():
                    ids.append(int(stem))
        return sorted(ids)

    def _paths(self, rec_id: int) -> tuple[str, str]:
        stem = os.path.join(self.directory, f"{rec_id:08d}")
        return stem + ".npz", stem + ".json"

    def _write_record(self, arrays: dict, rtype: str, table: Table) -> None:
        """Durable record: payload ``.npz`` first, then the JSON sidecar
        with its sha256 and the version and partition count the record
        must find when it applies."""
        payload = _npz_bytes(arrays)
        ids = self._record_ids()
        rec_id = (ids[-1] + 1) if ids else 0
        npz_path, meta_path = self._paths(rec_id)
        _write_atomic(npz_path, payload)
        meta = {
            "format": _FORMAT,
            "record": rec_id,
            "type": rtype,
            "parts_before": table.num_partitions,
            "version_before": table.version,
            "sha256": _sha256(payload),
        }
        _write_atomic(meta_path, json.dumps(meta).encode())

    def _durable_then_apply(self, table: Table, arrays: dict, rtype: str, apply):
        crash_point(self.injector, "wal.record")
        self._write_record(arrays, rtype, table)
        crash_point(self.injector, "wal.apply")
        out = apply()
        crash_point(self.injector, "wal.derived")
        return out

    # ---- the mutations -----------------------------------------------------
    def append(self, table: Table, delta: dict) -> Table:
        """Durable-then-apply `append_partitions`."""
        delta = {k: np.asarray(v) for k, v in dict(delta).items()}
        return self._durable_then_apply(
            table, delta, "append", lambda: append_partitions(table, delta))

    def delete(self, table: Table, ext_ids) -> list[int]:
        """Durable-then-apply soft delete.  The request is validated
        before the record is written, so an invalid delete never reaches
        the log."""
        ext = np.atleast_1d(np.asarray(ext_ids, dtype=np.int64))
        lifecycle.validate_delete(table, ext)
        return self._durable_then_apply(
            table, {"ext_ids": ext}, "delete",
            lambda: lifecycle.delete_partitions(table, ext))

    def compact(self, table: Table) -> np.ndarray:
        """Durable-then-apply compaction.  The record has no payload: the
        survivors follow from the tombstones found at apply time, which
        the version-keyed replay makes those of the recording state."""
        if table.num_live == 0:
            raise ValueError("cannot compact a table with zero live partitions")
        return self._durable_then_apply(table, {}, "compact", lambda: lifecycle.compact(table))

    def rebalance(self, table: Table, perm) -> np.ndarray:
        """Durable-then-apply slot permutation (`lifecycle.rebalance`)."""
        perm = lifecycle.check_permutation(perm, table.num_partitions)
        return self._durable_then_apply(
            table, {"perm": perm}, "rebalance", lambda: lifecycle.rebalance(table, perm))

    # ---- recovery ----------------------------------------------------------
    def replay(self, table: Table) -> int:
        """Apply every record the table has not seen → records applied.

        Idempotent and keyed on the table *version*: a record whose
        ``version_before`` is behind the table's version applied before
        the crash and is skipped; one ahead of it means a record is
        missing (`WalCorruptError`).  ``parts_before`` cross-checks
        append records."""
        applied = 0
        for rec_id in self._record_ids():
            npz_path, meta_path = self._paths(rec_id)
            meta = _read_json(meta_path, f"WAL record {rec_id}: bad sidecar")
            ver = meta["version_before"]
            if ver < table.version:
                continue  # applied before the crash
            if ver > table.version:
                raise WalCorruptError(
                    f"WAL record {rec_id} expects table version {ver} but "
                    f"the table is at {table.version}: a preceding record "
                    "is missing"
                )
            payload = _read_verified(npz_path, meta["sha256"], f"WAL record {rec_id}")
            with np.load(io.BytesIO(payload), allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
            rtype = meta.get("type", "append")
            if rtype == "append":
                if meta["parts_before"] != table.num_partitions:
                    raise WalCorruptError(
                        f"WAL record {rec_id} expects {meta['parts_before']} "
                        f"partitions but the table has {table.num_partitions}"
                    )
                append_partitions(table, arrays)
            elif rtype == "delete":
                lifecycle.delete_partitions(table, arrays["ext_ids"])
            elif rtype == "compact":
                lifecycle.compact(table)
            elif rtype == "rebalance":
                lifecycle.rebalance(table, arrays["perm"])
            else:
                raise WalCorruptError(f"WAL record {rec_id}: unknown record type {rtype!r}")
            applied += 1
        return applied

    def truncate(self) -> None:
        """Drop every record (after a snapshot has made them redundant)."""
        for rec_id in self._record_ids():
            for path in self._paths(rec_id):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass


# --------------------------------------------------------------------------
# the derived-state reader: an allowlist of globals
# --------------------------------------------------------------------------
# the classes of derived state, by module below the package: found under
# ``repro_torch.`` (the port's snapshots) or ``repro.`` (the reference's,
# mapped to the port's twins without importing the reference)
DERIVED_CLASSES = {
    "core.sketches": ("ColumnSketch", "TableSketches"),
    "core.funnel": ("ImportanceFunnel",),
    "core.gbdt": ("Forest", "Binner"),
    "core.picker": ("PickerConfig",),
    "planner.planner": ("PlannerConfig",),
    "planner.views": ("MaterializedView",),
    "queries.engine": ("PartitionAnswers", "_AggPlan"),
    "queries.ir": ("Query", "Aggregate", "Predicate", "OrGroup", "Clause"),
}
# numpy's reconstructors of arrays, dtypes and scalars (numpy 1 and 2 names)
NUMPY_GLOBALS = frozenset(
    (f"numpy{core}.{mod}", name)
    for core in ("._core", ".core")
    for mod, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                      ("numeric", "_frombuffer"))
) | {("numpy", "dtype"), ("numpy", "ndarray")}
# lazily built caches an object may carry besides its fields: dropped on
# load and rebuilt on first use
CACHE_ATTRS = {"Binner": frozenset({"_lut_cache"})}


class _SnapshotUnpickler(pickle.Unpickler):
    """Resolves only `DERIVED_CLASSES` and `NUMPY_GLOBALS`; anything else
    raises `WalCorruptError` before it is looked up."""

    def __init__(self, data: bytes):
        super().__init__(io.BytesIO(data))
        self.classes: set[type] = set()

    def find_class(self, module: str, name: str):
        if (module, name) in NUMPY_GLOBALS:
            return super().find_class(module, name)
        package, _, sub = module.partition(".")
        if package in ("repro", "repro_torch") and name in DERIVED_CLASSES.get(sub, ()):
            cls = getattr(importlib.import_module(f"repro_torch.{sub}"), name)
            self.classes.add(cls)
            return cls
        raise WalCorruptError(
            f"snapshot derived state names {module}.{name}, which is not "
            "on the snapshot allowlist"
        )

    def persistent_load(self, pid):
        raise WalCorruptError("snapshot derived state holds a persistent id")


def _check_fields(obj, classes: set[type]) -> None:
    """Walk the loaded graph: every object of a mapped class must carry
    exactly its dataclass fields (a known cache attribute is dropped)."""
    seen: set[int] = set()
    stack = [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif isinstance(o, np.ndarray):
            if o.dtype == object:
                stack.extend(o.ravel().tolist())
        elif type(o) in classes:
            cls = type(o)
            state = vars(o)
            for attr in CACHE_ATTRS.get(cls.__name__, ()):
                state.pop(attr, None)
            fields = {f.name for f in dataclasses.fields(cls)}
            if set(state) != fields:
                raise WalCorruptError(
                    f"snapshot {cls.__name__} sets {sorted(state)}, but the "
                    f"class has the fields {sorted(fields)}"
                )
            stack.extend(state.values())


def load_derived_bytes(data: bytes) -> dict:
    """Unpickle ``derived.pkl`` bytes through the allowlist."""
    unpickler = _SnapshotUnpickler(data)
    try:
        derived = unpickler.load()
    except (pickle.UnpicklingError, EOFError, AttributeError, TypeError, ValueError) as e:
        raise WalCorruptError(f"snapshot derived state does not unpickle: {e}") from e
    if not isinstance(derived, dict):
        raise WalCorruptError("snapshot derived state is not a mapping")
    _check_fields(derived, unpickler.classes)
    return derived


# --------------------------------------------------------------------------
# snapshots of the session (table + all derived state)
# --------------------------------------------------------------------------
def save_snapshot(session, directory: str, injector: FaultInjector | None = None) -> str:
    """Persist the session's table and derived state → manifest path.

    The manifest is written last: a directory without one is an
    incomplete snapshot, and `restore_snapshot` refuses it."""
    os.makedirs(directory, exist_ok=True)
    crash_point(injector, "snapshot.begin")
    table = session.table
    files: dict[str, str] = {}

    table_bytes = _npz_bytes(dict(table.columns))
    _write_atomic(os.path.join(directory, "table.npz"), table_bytes)
    files["table.npz"] = _sha256(table_bytes)

    # bring every store current before serializing (lazy folds run here)
    sketches = session.sketches.sketches()
    session.views.refresh()
    picker_state = None
    if session.picker is not None:
        picker_state = {
            "funnel": session.picker.funnel,
            "cluster_mask": session.picker.cluster_mask,
            "config": session.picker.config,
        }
    derived = {
        "sketches": sketches,
        "views": session.views._views,
        "answers_cache": session.answers._cache,
        "answers_partial": session.answers._partial,
        "picker": picker_state,
        "planner_config": session.planner_config,
    }
    derived_bytes = pickle.dumps(derived, protocol=pickle.HIGHEST_PROTOCOL)
    crash_point(injector, "snapshot.files")
    _write_atomic(os.path.join(directory, "derived.pkl"), derived_bytes)
    files["derived.pkl"] = _sha256(derived_bytes)

    meta = {
        "format": _FORMAT,
        "name": table.name,
        "version": table.version,
        "append_log": {str(k): v for k, v in table.append_log.items()},
        "num_partitions": table.num_partitions,
        "schema": [dataclasses.asdict(s) for s in table.schema],
        # lifecycle state: tombstones, the partition directory and the
        # lifecycle log, so restored caches fold instead of rebuilding
        "tombstones": sorted(int(t) for t in table.tombstones),
        "ext_ids": None if table.ext_ids is None else [int(i) for i in table.ext_ids],
        "next_ext": int(table.next_ext),
        "lifecycle_log": {
            str(k): [v[0], list(v[1]), int(v[2])] for k, v in table.lifecycle_log.items()
        },
    }
    meta_bytes = json.dumps(meta).encode()
    _write_atomic(os.path.join(directory, "meta.json"), meta_bytes)
    files["meta.json"] = _sha256(meta_bytes)

    manifest = {"format": _FORMAT, "files": files}
    manifest_path = os.path.join(directory, "manifest.json")
    _write_atomic(manifest_path, json.dumps(manifest).encode())
    crash_point(injector, "snapshot.done")
    return manifest_path


def _manifest(directory: str) -> dict:
    path = os.path.join(directory, "manifest.json")
    if not os.path.exists(path):
        raise WalCorruptError(f"no manifest in {directory!r}: snapshot incomplete or missing")
    manifest = _read_json(path, "snapshot manifest")
    if manifest.get("format") != _FORMAT:
        raise WalCorruptError(f"snapshot format {manifest.get('format')!r} != {_FORMAT}")
    return manifest


def load_table(directory: str) -> Table:
    """The `Table` a snapshot holds, every checksum verified."""
    files = _manifest(directory)["files"]
    meta = json.loads(_read_verified(os.path.join(directory, "meta.json"),
                                     files["meta.json"], "snapshot meta"))
    table_bytes = _read_verified(os.path.join(directory, "table.npz"), files["table.npz"],
                                 "snapshot table")
    with np.load(io.BytesIO(table_bytes), allow_pickle=False) as z:
        columns = {k: z[k] for k in z.files}
    schema = tuple(ColumnSpec(**s) for s in meta["schema"])
    table = Table(
        schema, columns, name=meta["name"], version=meta["version"],
        append_log={int(k): v for k, v in meta["append_log"].items()},
        tombstones={int(t) for t in meta.get("tombstones", [])},
        next_ext=int(meta.get("next_ext", 0)),
        lifecycle_log={
            int(k): (v[0], tuple(v[1]), int(v[2]))
            for k, v in meta.get("lifecycle_log", {}).items()
        },
    )
    ext = meta.get("ext_ids")
    if ext is not None:
        table.ext_ids = np.asarray(ext, dtype=np.int64)
    return table


def load_derived(directory: str) -> dict:
    """A snapshot's derived state, checksum verified, read through the
    allowlist (`load_derived_bytes`)."""
    files = _manifest(directory)["files"]
    return load_derived_bytes(_read_verified(os.path.join(directory, "derived.pkl"),
                                             files["derived.pkl"], "snapshot derived state"))


def restore_snapshot(cls, directory: str, *, options=None, planner_config=None):
    """A `Session` (class passed in, against an import cycle) rebuilt from
    `save_snapshot`'s output, its derived state grafted on.

    ``cls(table, options=...)`` builds the session on ``options`` — on the
    card by default — including its sketch build, which the snapshot's
    sketches then replace, as the reference does.  The column stack is
    not in the snapshot: it rebuilds lazily on the device from the
    restored host columns."""
    table = load_table(directory)
    derived = load_derived(directory)
    planner_config = planner_config or derived.get("planner_config")
    sess = cls(table, options=options, planner_config=planner_config)

    sketches = derived["sketches"]
    if sketches.num_partitions != table.num_partitions:
        raise StaleStateError(
            f"snapshot sketches cover {sketches.num_partitions} partitions "
            f"but the restored table has {table.num_partitions}"
        )
    sess.sketches._sk = sketches
    sess.sketches._version = table.version
    sess.views._views = derived["views"]
    sess.views._version = table.version
    sess.answers._cache = derived["answers_cache"]
    sess.answers._partial = derived["answers_partial"]
    sess.answers._version = table.version

    picker_state = derived.get("picker")
    if picker_state is not None:
        from repro_torch.core.features import FeatureBuilder
        from repro_torch.core.picker import PS3Picker
        from repro_torch.planner import QueryPlanner

        fb = FeatureBuilder(table, sess.sketches.sketches())
        sess.picker = PS3Picker(table, fb, picker_state["funnel"], picker_state["cluster_mask"],
                                picker_state["config"], options=sess.options)
        sess.planner = QueryPlanner(sess.picker, sess.answers, views=sess.views,
                                    config=sess.planner_config)
        sess._fb_version = table.version
    return sess


def recover(directory: str, *, options=None, planner_config=None):
    """Crash recovery: restore ``<dir>/snapshot`` and replay ``<dir>/wal``
    into the restored table → the recovered `Session`.  Derived state
    folds lazily through the table's logs, as for live mutations, so the
    recovered session answers as one that never crashed."""
    from repro_torch.api import Session

    sess = restore_snapshot(Session, os.path.join(directory, "snapshot"),
                            options=options, planner_config=planner_config)
    WriteAheadLog(os.path.join(directory, "wal")).replay(sess.table)
    return sess
