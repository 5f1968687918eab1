"""Keyed event counters for the kernel layer (shared registry pattern).

PyTorch runs eagerly and the CUDA kernels take their shapes as runtime
arguments, so nothing here counts compiles.  A registry counts *events
per key* instead:

  * `kernels._build.LAUNCHES` counts kernel launches per kernel name —
    how a run shows that its main path went through the hand-written
    kernels and not their plain versions;
  * `queries.device.TRACES` counts driver launches per shape-bucket
    signature, so tests can hold the launch keys to the same
    `workload_census` the reference bounds its compiles by.
"""
from __future__ import annotations

import collections


class TraceRegistry:
    """Counts events per key for one subsystem."""

    def __init__(self, name: str):
        self.name = name
        self._counts: collections.Counter = collections.Counter()

    def note(self, *key) -> None:
        self._counts[key] += 1

    def counts(self) -> dict:
        """{key: events} since the last reset."""
        return dict(self._counts)

    def total(self) -> int:
        return sum(self._counts.values())

    def reset(self) -> None:
        self._counts.clear()
