"""Partition lifecycle: soft-delete, compaction, rebalancing.

Streaming ingest only appends; this module adds the rest of a
partition's life while keeping the contract of every mutation — each
derived structure folds in O(touched partitions), bit-identical to a
cold rebuild on the same table:

  * **soft-delete** — `delete_partitions` tombstones physical slots.
    Rows stay in `Table.columns` (and in every per-partition derived
    tensor), but the planner and picker drop tombstoned slots from their
    candidates, `ViewStore` totals exclude them and stratum populations
    shrink, so confidence intervals stop covering data that is gone.
  * **compaction** — `compact` reclaims tombstoned slots by gathering
    the survivors in their relative order.  Every per-partition statistic
    is a function of its partition's rows, so derived state follows by
    the same gather; only global reductions (categorical heavy hitters,
    the discrete-span qualification) re-fold
    (`core.sketches.gather_sketches`).
  * **rebalancing** — `rebalance` applies a slot permutation
    (`rebalance_plan` builds the canonical one: live partitions dealt
    round-robin across shards, tombstones packed at the tail).  The
    **partition directory** (`Table.ext_ids`) gives every partition an
    external id that survives compaction and rebalancing; callers
    address partitions by external id, never by physical slot.

Each op bumps `Table.version` and records its event in
`Table.lifecycle_log`; `Table.mutation_events` merges that log with the
append log, so the sketch store, the eval cache, the answer store and
the views fold any interleaving of appends and lifecycle events.
Durability is `repro_torch.wal` (delete, compact and rebalance records,
replay keyed on the version).  Everything here is numpy host state: no
op touches a device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.table import Table

__all__ = [
    "ensure_directory",
    "resolve",
    "validate_delete",
    "delete_partitions",
    "compact",
    "rebalance_plan",
    "rebalance",
]


def ensure_directory(table: Table) -> np.ndarray:
    """Initialize the partition directory (idempotent): external ids
    0..P-1 for the current physical slots."""
    if table.ext_ids is None:
        table.ext_ids = np.arange(table.num_partitions, dtype=np.int64)
        table.next_ext = table.num_partitions
    return table.ext_ids


def resolve(table: Table, ext_ids) -> np.ndarray:
    """External partition ids → physical slots (`KeyError` on unknown ids)."""
    directory = ensure_directory(table)
    ext = np.atleast_1d(np.asarray(ext_ids, dtype=np.int64))
    order = np.argsort(directory, kind="stable")
    pos = np.searchsorted(directory, ext, sorter=order)
    bad = (pos >= directory.size) | (directory[order[np.minimum(pos, directory.size - 1)]] != ext)
    if bad.any():
        raise KeyError(f"unknown external partition ids {ext[bad].tolist()}")
    return order[pos]


def validate_delete(table: Table, ext_ids) -> np.ndarray:
    """Every check of `delete_partitions` with none of its effects (the
    WAL runs it before a delete record becomes durable, so an invalid
    request never reaches the log).  → physical slots."""
    phys = resolve(table, ext_ids)
    if len(set(phys.tolist())) != phys.size:
        raise ValueError(f"duplicate ids in delete: {np.asarray(ext_ids).tolist()}")
    already = [int(p) for p in phys if int(p) in table.tombstones]
    if already:
        raise ValueError(f"partitions already deleted (physical slots {already})")
    if len(table.tombstones) + phys.size >= table.num_partitions:
        raise ValueError("cannot delete the last live partition")
    return phys


def delete_partitions(table: Table, ext_ids) -> list[int]:
    """Soft-delete partitions by external id → the physical slots
    tombstoned.  A double delete raises `ValueError`, an unknown id
    `KeyError`."""
    phys = validate_delete(table, ext_ids)
    parts_before = table.num_partitions
    slots = sorted(int(p) for p in phys)
    table.tombstones.update(slots)
    table.version += 1
    table.record_lifecycle(("delete", tuple(slots), parts_before))
    return slots


def compact(table: Table) -> np.ndarray:
    """Reclaim tombstoned slots: gather the survivors (relative order
    kept), clear the tombstones, remap the directory.  → ``keep``, the
    surviving slots in the old numbering.  A compact without tombstones is
    a legal identity gather (the version still advances)."""
    if table.num_live == 0:
        raise ValueError("cannot compact a table with zero live partitions")
    parts_before = table.num_partitions
    keep = np.flatnonzero(table.live_mask())
    table.columns = {k: v[keep] for k, v in table.columns.items()}
    if table.ext_ids is not None:
        table.ext_ids = table.ext_ids[keep]
    table.tombstones.clear()
    table.version += 1
    table.record_lifecycle(("compact", tuple(int(k) for k in keep), parts_before))
    return keep


def rebalance_plan(table: Table, num_shards: int) -> np.ndarray:
    """The canonical resharding permutation: live partitions dealt
    round-robin across ``num_shards`` shards (shard 0's slots first),
    tombstoned slots packed at the tail.  The same table state always
    gives the same plan."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    live = np.flatnonzero(table.live_mask())
    dead = np.flatnonzero(~table.live_mask())
    by_shard = [live[s::num_shards] for s in range(num_shards)]
    return np.concatenate(by_shard + [dead]).astype(np.int64)


def check_permutation(perm, num_partitions: int) -> np.ndarray:
    """``perm`` as int64, or `ValueError` if it is not a permutation of
    ``range(num_partitions)``."""
    perm = np.asarray(perm, dtype=np.int64)
    if perm.shape != (num_partitions,) or not np.array_equal(
            np.sort(perm), np.arange(num_partitions)):
        raise ValueError(f"perm must be a permutation of range({num_partitions})")
    return perm


def rebalance(table: Table, perm) -> np.ndarray:
    """Apply a slot permutation: new slot ``i`` holds what old slot
    ``perm[i]`` held.  Columns, directory and tombstones remap; external
    ids are unchanged (the directory's point)."""
    perm = check_permutation(perm, table.num_partitions)
    parts_before = table.num_partitions
    table.columns = {k: v[perm] for k, v in table.columns.items()}
    if table.ext_ids is not None:
        table.ext_ids = table.ext_ids[perm]
    if table.tombstones:
        old = table.tombstones
        table.tombstones = {int(i) for i in np.flatnonzero(np.isin(perm, sorted(old)))}
    table.version += 1
    table.record_lifecycle(("rebalance", tuple(int(i) for i in perm), parts_before))
    return perm
