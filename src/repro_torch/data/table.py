"""Partitioned columnar tables.

The storage model mirrors the paper's setting: a table is split into N
equal-size partitions ("the finest granularity at which the storage layer
maintains statistics").  Columns are either numeric (float32) or categorical
(int32 codes into a small dictionary).  We keep every column as a dense
(num_partitions, rows_per_partition) array so that per-partition operations
(sketch construction, per-partition query answers) are a single vectorized
pass — the layout a device ingest pipeline uses.

Growth happens at partition granularity (the paper's bulk-append ingest
model): `append_partitions` / `concat_tables(into=)` append whole
partitions in place, bump the data ``version``, and record the append in
a log that downstream caches use to update incrementally instead of
rebuilding — see docs/architecture.md ("streaming ingest plane").
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

NUMERIC = "numeric"
CATEGORICAL = "categorical"


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str
    kind: str  # NUMERIC | CATEGORICAL
    cardinality: int = 0  # for categorical columns: size of the code dictionary
    positive: bool = False  # numeric column known to be > 0 (log-measures apply)
    groupable: bool = False  # low-cardinality column usable in GROUP BY

    def __post_init__(self):
        if self.kind not in (NUMERIC, CATEGORICAL):
            raise ValueError(f"bad column kind {self.kind!r}")
        if self.kind == CATEGORICAL and self.cardinality <= 0:
            raise ValueError(f"categorical column {self.name} needs cardinality")


@dataclasses.dataclass
class Table:
    """A partitioned columnar table.

    columns[name] has shape (num_partitions, rows_per_partition).

    **Data versioning.**  ``version`` is bumped by every in-place mutation
    API (`append_partitions`, `concat_tables(into=)`) so caches keyed to
    this object (`EvalCache` device stacks, `AnswerStore` answers,
    `SketchStore` sketches) can detect that their snapshots went stale.
    Pure partition appends additionally record the pre-append partition
    count in an append log; `append_range` lets a cache holding a snapshot
    at an older version decide between an *incremental* update (every
    intervening version was an append — only the new partitions changed)
    and a full rebuild.
    """

    schema: tuple[ColumnSpec, ...]
    columns: dict[str, np.ndarray]
    name: str = "table"
    # data version: bumped by in-place mutations (see class docstring)
    version: int = 0
    # {version: num_partitions before the append that produced it} — only
    # pure partition appends are recorded; any version missing from the
    # log forces consumers down the full-rebuild path.  Bounded: only the
    # most recent MAX_APPEND_LOG appends are kept (a cache more than that
    # many appends behind rebuilds — correct, just not incremental), so a
    # long-running streaming server's log cannot grow without bound.
    append_log: dict[int, int] = dataclasses.field(default_factory=dict)
    # ---- lifecycle plane ------------------------------------------------
    # PHYSICAL slot ids of soft-deleted partitions.  Tombstoned rows stay
    # in `columns` (and in every per-partition derived tensor) but are
    # excluded from planner/picker candidates, view totals and population
    # sizes — deleted mass leaves N_h so CIs stay honest.
    tombstones: set[int] = dataclasses.field(default_factory=set)
    # stable EXTERNAL partition ids, (num_partitions,) int64, or None
    # until `lifecycle.ensure_directory` initializes the directory.
    # External ids survive compaction and rebalancing; physical slots
    # do not.
    ext_ids: np.ndarray | None = None
    next_ext: int = 0
    # {version: lifecycle event at that version} — mirrors append_log for
    # the non-append mutations: ("delete", phys_ids, parts_before),
    # ("compact", keep, parts_before), ("rebalance", perm, parts_before).
    # Same bound as append_log; `mutation_events` merges the two logs.
    lifecycle_log: dict[int, tuple] = dataclasses.field(default_factory=dict)

    MAX_APPEND_LOG = 1024

    def __post_init__(self):
        shapes = {c.shape for c in self.columns.values()}
        if len(shapes) != 1:
            raise ValueError(f"inconsistent column shapes: {shapes}")
        (shape,) = shapes
        if len(shape) != 2:
            raise ValueError(f"columns must be (parts, rows), got {shape}")
        names = [s.name for s in self.schema]
        if sorted(names) != sorted(self.columns):
            raise ValueError("schema/columns mismatch")
        for spec in self.schema:
            col = self.columns[spec.name]
            if spec.kind == NUMERIC and col.dtype != np.float32:
                self.columns[spec.name] = col.astype(np.float32)
            if spec.kind == CATEGORICAL and col.dtype != np.int32:
                self.columns[spec.name] = col.astype(np.int32)

    def __setstate__(self, state):
        # pickles from before the lifecycle plane (cached bench contexts,
        # old snapshots) lack the lifecycle fields — backfill defaults so
        # they unpickle as tables with no tombstones and no directory
        state.setdefault("tombstones", set())
        state.setdefault("ext_ids", None)
        state.setdefault("next_ext", 0)
        state.setdefault("lifecycle_log", {})
        self.__dict__.update(state)

    # ---- basic geometry -------------------------------------------------
    @property
    def num_partitions(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    @property
    def rows_per_partition(self) -> int:
        return next(iter(self.columns.values())).shape[1]

    @property
    def num_rows(self) -> int:
        return self.num_partitions * self.rows_per_partition

    def spec(self, name: str) -> ColumnSpec:
        for s in self.schema:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def numeric_columns(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.schema if s.kind == NUMERIC)

    @property
    def categorical_columns(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.schema if s.kind == CATEGORICAL)

    @property
    def groupable_columns(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.schema if s.groupable)

    # ---- lifecycle support ----------------------------------------------
    def live_mask(self) -> np.ndarray:
        """(num_partitions,) bool — False at tombstoned physical slots."""
        mask = np.ones(self.num_partitions, dtype=bool)
        if self.tombstones:
            mask[sorted(self.tombstones)] = False
        return mask

    @property
    def num_live(self) -> int:
        return self.num_partitions - len(self.tombstones)

    def record_lifecycle(self, event: tuple) -> None:
        """Log a lifecycle event against the (already bumped) version."""
        self.lifecycle_log[self.version] = event
        while len(self.lifecycle_log) > Table.MAX_APPEND_LOG:
            del self.lifecycle_log[min(self.lifecycle_log)]

    def mutation_events(self, since_version: int) -> list[tuple] | None:
        """Ordered mutation events covering ``(since_version, version]``.

        Each element is ``("append", old_p, new_p)`` or a lifecycle event
        as recorded by `record_lifecycle`.  Returns ``None`` (caller must
        fully rebuild) if any intervening version is missing from both
        logs — an unlogged bump means an unknown mutation.
        """
        if since_version > self.version:
            return None  # snapshot from the future: not a known chain
        events: list[tuple] = []
        appends: list[int] = []  # indices into `events` of append events
        for v in range(since_version + 1, self.version + 1):
            if v in self.append_log:
                appends.append(len(events))
                events.append(("append", self.append_log[v], -1))
            elif v in self.lifecycle_log:
                events.append(self.lifecycle_log[v])
            else:
                return None
        # resolve each append's post-append partition count: the next
        # event's parts-before, or the current count for the last event
        for i in appends:
            if i + 1 < len(events):
                nxt = events[i + 1]
                new_p = nxt[1] if nxt[0] == "append" else nxt[2]
            else:
                new_p = self.num_partitions
            events[i] = ("append", events[i][1], new_p)
        return events

    # ---- streaming-ingest support --------------------------------------
    def append_range(self, since_version: int) -> tuple[int, int] | None:
        """(old_p, new_p) if every version step since ``since_version`` was
        a pure partition append, else None (the caller must fully rebuild).

        ``old_p`` is the partition count the snapshot at ``since_version``
        saw; partitions ``[old_p, new_p)`` are the ones appended since.
        """
        if since_version == self.version:
            p = self.num_partitions
            return (p, p)
        if since_version > self.version:
            return None  # snapshot from the future: not an append chain
        # the first missing version (non-append bump, or pruned past
        # MAX_APPEND_LOG) exits immediately, so this walk is bounded by
        # the log size, not the version gap
        for v in range(since_version + 1, self.version + 1):
            if v not in self.append_log:
                return None
        return (self.append_log[since_version + 1], self.num_partitions)

    def fingerprint(self, parts: int | None = None) -> tuple:
        """Cheap content fingerprint: shape + dtype + the four corner
        values (first/last partition boundaries) per column.

        O(1) per column — this is a *guard against out-of-band mutation*
        (someone writing into a column array without bumping ``version``),
        not a cryptographic digest: it catches appends, truncations, and
        edits at the partition boundaries, which is where every supported
        mutation API operates.  The encoding is raw corner *bytes* — a
        couple of µs per call, and NaN-stable (NaN corners compare equal
        to themselves, unlike float comparison).  `EvalCache` checks it
        periodically and at batch boundaries, and raises rather than
        silently serving answers for data that moved.

        ``parts`` fingerprints only the first ``parts`` partitions: how a
        cache syncing across an append chain verifies that the *old*
        region its snapshot covers is still the data it fingerprinted.
        """
        fp = []
        # tombstones are part of the content: a soft-delete changes which
        # partitions answers may draw from, so caches must see it in the
        # fingerprint (and NOT mistake it for out-of-band mutation — the
        # delete itself refreshes their stored fingerprint).  Restricted
        # fingerprints only see tombstones inside their region.
        ts = sorted(
            t for t in self.tombstones if parts is None or t < parts
        )
        fp.append(("__tombstones__", tuple(ts)))
        for name in sorted(self.columns):
            c = self.columns[name]
            if parts is not None:
                c = c[:parts]
            if c.size == 0:
                fp.append((name, c.shape, c.dtype.str))
                continue
            corners = c[:: max(c.shape[0] - 1, 1), :: max(c.shape[1] - 1, 1)]
            fp.append((name, c.shape, c.dtype.str, corners.tobytes()))
        return tuple(fp)

    # ---- layout manipulation -------------------------------------------
    def flat(self, name: str) -> np.ndarray:
        return self.columns[name].reshape(-1)

    def with_layout(self, order: np.ndarray, name_suffix: str) -> "Table":
        """Re-partition rows according to a global row order."""
        n, r = self.num_partitions, self.rows_per_partition
        cols = {k: v.reshape(-1)[order].reshape(n, r) for k, v in self.columns.items()}
        return Table(self.schema, cols, name=f"{self.name}/{name_suffix}")

    def sorted_by(self, column: str) -> "Table":
        order = np.argsort(self.flat(column), kind="stable")
        return self.with_layout(order, f"sorted:{column}")

    def shuffled(self, seed: int = 0) -> "Table":
        order = np.random.default_rng(seed).permutation(self.num_rows)
        return self.with_layout(order, f"random:{seed}")

    def repartitioned(self, num_partitions: int) -> "Table":
        if self.num_rows % num_partitions:
            raise ValueError("row count not divisible by partition count")
        r = self.num_rows // num_partitions
        cols = {k: v.reshape(num_partitions, r) for k, v in self.columns.items()}
        return Table(self.schema, cols, name=f"{self.name}/p{num_partitions}")


def events_foldable(events: list[tuple]) -> bool:
    """Can a derived-state cache fold this mutation-event chain
    incrementally, or must it rebuild?

    The folds run in event order against the FINAL table, so any event
    that reads table *rows* (an append reads the appended region; a
    compact may re-read survivors to requalify a discrete span) is only
    valid if no later compact/rebalance relocated those rows.  Deletes
    are tombstone-only and rebalances are pure gathers of derived
    tensors — they commute with everything.
    """
    moves = {"compact", "rebalance"}
    seen_move_after = False
    for ev in reversed(events):
        if ev[0] in ("append", "compact") and seen_move_after:
            return False
        if ev[0] in moves:
            seen_move_after = True
    return True


def from_flat(schema, columns: Mapping[str, np.ndarray], name: str) -> Table:
    """Build a single-partition table from flat 1-D columns."""
    return Table(tuple(schema), {k: np.asarray(v).reshape(1, -1) for k, v in columns.items()}, name=name)


def append_partitions(
    into: Table, new: Table | Mapping[str, np.ndarray]
) -> Table:
    """Streaming ingest entry point: append whole partitions in place.

    ``new`` is either a delta table or a mapping of column name →
    ``(delta_partitions, rows_per_partition)`` arrays with the same schema
    and row count as ``into``.  The append bumps ``into.version`` and
    records the pre-append partition count in the append log, which is
    what lets every downstream cache update *incrementally* instead of
    rebuilding:

      * `core.sketches.update_sketches` / `SketchStore` compute sketch
        rows for only the appended partitions (O(delta), not O(P)) and
        merge the global heavy-hitter state;
      * `queries.engine.EvalCache` writes the new partition columns into
        its device stack's reserved slack (one O(delta) transfer; re-pad
        and re-shard only when the shape bucket overflows);
      * `queries.engine.AnswerStore` keeps cached per-partition answers
        for the untouched partitions and evaluates only the delta.

    Every incremental path is bit-identical to a cold rebuild on the grown
    table (tested in ``tests/test_streaming_ingest.py``, incl. 2- and
    8-device partition meshes).  An empty delta (0 partitions) is a no-op
    append: the version still advances, caches observe it and carry over.
    """
    cols = new.columns if isinstance(new, Table) else dict(new)
    if sorted(cols) != sorted(into.columns):
        raise ValueError("append schema mismatch")
    old_p, r = into.num_partitions, into.rows_per_partition
    out: dict[str, np.ndarray] = {}
    for spec in into.schema:
        c = np.asarray(cols[spec.name])
        if c.ndim != 2 or c.shape[1] != r:
            raise ValueError(
                f"append column {spec.name}: expected (delta, {r}), got {c.shape}"
            )
        dtype = np.float32 if spec.kind == NUMERIC else np.int32
        out[spec.name] = np.concatenate(
            [into.columns[spec.name], c.astype(dtype)], axis=0
        )
    into.columns = out
    into.version += 1
    into.append_log[into.version] = old_p
    while len(into.append_log) > Table.MAX_APPEND_LOG:
        del into.append_log[min(into.append_log)]
    if into.ext_ids is not None:
        # directory initialized: appended partitions get fresh stable ids
        delta = into.num_partitions - old_p
        new_ids = np.arange(
            into.next_ext, into.next_ext + delta, dtype=np.int64
        )
        into.ext_ids = np.concatenate([into.ext_ids, new_ids])
        into.next_ext += delta
    return into


def concat_tables(tables: Sequence[Table], into: Table | None = None) -> Table:
    """Bulk-append (the paper's ingest model): partitions are appended.

    Without ``into=`` this is pure: a new `Table` holding the concatenated
    partitions.  With ``into=`` it is an in-place streaming append through
    `append_partitions` — all deltas are combined into ONE append (one
    copy, one version bump, one append-log entry), so caches holding
    snapshots (`EvalCache` device stacks, `AnswerStore` answers,
    `SketchStore` sketches) update incrementally from the delta
    partitions instead of rebuilding, and never serve results for the
    smaller table.
    """
    if into is not None:
        if not tables:
            return into
        delta = {
            k: np.concatenate([t.columns[k] for t in tables], axis=0)
            for k in into.columns
        } if len(tables) > 1 else tables[0].columns
        return append_partitions(into, delta)
    base = tables[0]
    cols = {
        k: np.concatenate([t.columns[k] for t in tables], axis=0)
        for k in base.columns
    }
    return Table(base.schema, cols, name=base.name)
