"""Deterministic, seeded fault injection for the read path.

Every failure mode the robustness plane handles is a *testable code
path*, not a hope: a `FaultPolicy` (threaded through
`repro_torch.backends.ExecOptions(faults=...)`) describes per-partition read
failures, timeouts, stragglers and process-crash points, and a
`FaultInjector` turns it into a deterministic schedule — the outcome of
attempt ``a`` of reading partition ``p`` is a pure function of
``(policy.seed, p, issue-order, a)``, so a red chaos run reproduces
locally from the seed alone.

The injector simulates the *control plane* of a distributed read
(which attempts fail, how long retries/backoff/hedges would have taken)
while the data plane stays the in-memory column slice: partitions that
survive are evaluated exactly as before, partitions that do not are
reported to the caller, which masks them inside the existing padded
chunk shapes (`planner.QueryPlanner`) or raises a typed
`PartitionReadError` (the exact-read paths in `queries.engine`).
Nothing here touches a torch device: the schedule is host bookkeeping,
and a schedule is the JAX reference's (`repro.faults`) bit for bit —
the same keys, attempt order, backoff and hedge arithmetic and virtual
charges — so the same policy fails the same reads in both packages.

Retry policy per partition read (all times are *virtual* seconds,
accumulated in ``virtual_seconds`` — nothing sleeps):

  * a failed or timed-out attempt retries up to ``max_attempts`` times
    with exponential backoff (``backoff_base · backoff_mult**attempt``);
  * a straggling read (would succeed, but after ``straggler_delay``) is
    *hedged*: a second copy is issued after ``hedge_after`` and the
    first completion wins — stragglers cost ``hedge_after + latency``
    instead of ``straggler_delay`` whenever the hedge is healthy;
  * ``dead_frac`` marks partitions whose replicas are gone: every
    attempt fails, retries exhaust, and the partition is reported
    failed (the planner substitutes same-stratum replacements and
    re-expands the survivor weights).

Crash points (`crash_point` / `FaultInjector.crash`) raise
`errors.InjectedCrash` (a BaseException — un-swallowable by recovery
code under test) the first time an armed point is reached; the
reference's WAL places them around its write/apply sequence.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.sketches import hash_u64
from repro_torch.errors import InjectedCrash, PartitionReadError


class VirtualClock:
    """Deterministic monotonic clock for chaos and serving tests.

    Nothing sleeps: time advances only when a component declares that
    work *would* have taken that long — `FaultInjector.read_ids` adds its
    virtual chunk latency when given a clock, and the serving front
    door's virtual mode adds its modeled service time per flush.  Pass
    ``clock.now`` wherever a ``clock: Callable[[], float]`` is accepted
    (planner deadlines, front-door admission), and every deadline /
    rate-limit / latency-percentile assertion becomes a pure function of
    the schedule instead of the CI machine's scheduler.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"VirtualClock.advance needs dt >= 0, got {dt}")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        """Move forward to ``t`` (monotonic: never backwards)."""
        self._now = max(self._now, float(t))
        return self._now


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Deterministic fault schedule + retry/hedge policy, in one value.

    Frozen and hashable so it can ride inside `ExecOptions`.  All rates
    are probabilities in [0, 1]; all durations are virtual seconds.
    """

    seed: int = 0
    # failure modes (per-attempt unless noted)
    dead_frac: float = 0.0  # per-PARTITION: replicas gone, never readable
    fail_frac: float = 0.0  # transient read failure (fails fast, retries)
    timeout_frac: float = 0.0  # attempt hangs until chunk_timeout, retries
    straggler_frac: float = 0.0  # read succeeds but takes straggler_delay
    # virtual-time model
    read_latency: float = 1e-3  # healthy read
    chunk_timeout: float = 0.25  # per-attempt timeout (what a timeout costs)
    straggler_delay: float = 1.0  # unhedged straggler completion time
    # retry / hedging policy
    max_attempts: int = 3
    backoff_base: float = 0.02
    backoff_mult: float = 2.0
    hedge_after: float = 0.05  # straggler detection threshold; >= straggler_delay
    # disables hedging (the straggler is simply awaited)
    # injected process-crash points (names consumed by the WAL)
    crash_points: frozenset = frozenset()

    def __post_init__(self):
        for f in ("dead_frac", "fail_frac", "timeout_frac", "straggler_frac"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultPolicy.{f} must be in [0, 1], got {v}")
        if self.max_attempts < 1:
            raise ValueError("FaultPolicy.max_attempts must be >= 1")
        object.__setattr__(self, "crash_points", frozenset(self.crash_points))

    def with_crash(self, *points: str) -> "FaultPolicy":
        return dataclasses.replace(
            self, crash_points=self.crash_points | set(points)
        )


def _uniform(seed: int, *parts: int) -> float:
    """Deterministic uniform in [0, 1) from integer keys.

    Built on `sketches.hash_u64` (multiply-shift mix); `hash()` of an
    int tuple is process-stable (ints hash to themselves — no
    PYTHONHASHSEED dependence), so schedules reproduce across runs."""
    key = hash((seed,) + parts) & 0x7FFFFFFFFFFFFFFF
    return float(hash_u64(np.array([key], dtype=np.int64))[0])


class FaultInjector:
    """Stateful executor of one `FaultPolicy` schedule.

    ``read_ids`` is the read gate both fault-aware paths share: it
    simulates every partition read (retries, backoff, hedging) and
    splits the ids into survivors and permanently-failed.  Telemetry
    accumulates across calls; ``report()`` snapshots it.  The issue
    counter ``_tick`` advances per call so a transient failure in one
    round does not deterministically repeat in the next — the schedule
    is still a pure function of (seed, call order).
    """

    def __init__(self, policy: FaultPolicy, clock: VirtualClock | None = None):
        self.policy = policy
        # optional shared virtual clock: when set, read_ids advances it by
        # the chunk's virtual completion time, so deadlines measured on
        # the same clock see the cost of slow/faulty reads (test plane)
        self.clock = clock
        self._tick = 0
        self._fired: set[str] = set()
        self.reads = 0
        self.attempts = 0
        self.retries = 0
        self.transient_failures = 0
        self.timeouts = 0
        self.stragglers = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.permanent_failures = 0
        self.crashes = 0
        self.virtual_seconds = 0.0

    # ---- schedule ----------------------------------------------------------
    def is_dead(self, pid: int) -> bool:
        """Partition-stable: a dead partition is dead on every attempt."""
        p = self.policy
        return p.dead_frac > 0 and _uniform(p.seed, 0xD0A, int(pid)) < p.dead_frac

    def _attempt_outcome(self, pid: int, attempt: int, hedge: bool = False) -> str:
        p = self.policy
        if self.is_dead(pid):
            return "fail"
        u = _uniform(p.seed, int(pid), self._tick, attempt, int(hedge))
        if u < p.fail_frac:
            return "fail"
        if u < p.fail_frac + p.timeout_frac:
            return "timeout"
        if not hedge and u < p.fail_frac + p.timeout_frac + p.straggler_frac:
            return "straggle"
        return "ok"

    # ---- the read gate -----------------------------------------------------
    def _read_one(self, pid: int) -> tuple[bool, float, bool]:
        """Simulate one partition read with retries/backoff/hedging.

        → (survived, virtual completion time, timed_out_every_attempt)."""
        p = self.policy
        t = 0.0
        timeouts_only = True
        for attempt in range(p.max_attempts):
            self.attempts += 1
            outcome = self._attempt_outcome(pid, attempt)
            if outcome == "ok":
                return True, t + p.read_latency, False
            if outcome == "straggle":
                self.stragglers += 1
                if p.hedge_after < p.straggler_delay:
                    # hedged re-issue: second copy after hedge_after; the
                    # first completion wins.  The straggler itself still
                    # finishes at straggler_delay, so a sick hedge only
                    # costs the wait, never the read.
                    self.hedges += 1
                    if self._attempt_outcome(pid, attempt, hedge=True) == "ok":
                        self.hedge_wins += 1
                        return True, t + p.hedge_after + p.read_latency, False
                return True, t + p.straggler_delay, False
            if outcome == "timeout":
                self.timeouts += 1
                t += p.chunk_timeout
            else:
                self.transient_failures += 1
                timeouts_only = False
                t += p.read_latency
            if attempt + 1 < p.max_attempts:
                self.retries += 1
                t += p.backoff_base * p.backoff_mult**attempt
        return False, t, timeouts_only

    def read_ids(self, ids) -> tuple[np.ndarray, np.ndarray]:
        """Attempt to read every partition in ``ids`` (issued in
        parallel; virtual chunk latency is the max completion time).

        → (survivors, failed), both in the input order.  Failed ids
        exhausted ``max_attempts`` — the caller degrades (planner) or
        raises `PartitionReadError` (exact-read paths)."""
        ids = np.asarray(ids, dtype=np.int64)
        self._tick += 1
        if ids.size == 0:
            return ids, ids
        ok = np.ones(ids.size, dtype=bool)
        t_max = 0.0
        for i, pid in enumerate(ids):
            self.reads += 1
            survived, t, _ = self._read_one(int(pid))
            ok[i] = survived
            t_max = max(t_max, t)
        self.permanent_failures += int((~ok).sum())
        self.virtual_seconds += t_max
        if self.clock is not None:
            self.clock.advance(t_max)
        return ids[ok], ids[~ok]

    def read_ids_strict(self, ids, where: str) -> np.ndarray:
        """`read_ids` for paths with no degraded mode (exact full reads):
        any permanent failure raises a typed `PartitionReadError`."""
        survivors, failed = self.read_ids(ids)
        if failed.size:
            raise PartitionReadError(
                f"{where}: {failed.size} partition read(s) failed after "
                f"{self.policy.max_attempts} attempts "
                f"(ids {failed[:8].tolist()}{'...' if failed.size > 8 else ''})",
                failed_ids=failed,
                report=self.report(),
            )
        return survivors

    # ---- crash points ------------------------------------------------------
    def crash(self, point: str) -> None:
        """Raise `InjectedCrash` the first time an armed point is hit.

        One-shot per injector: recovery re-runs the same code path with a
        fresh (or no) injector and must be allowed to pass."""
        if point in self.policy.crash_points and point not in self._fired:
            self._fired.add(point)
            self.crashes += 1
            raise InjectedCrash(point)

    # ---- telemetry ---------------------------------------------------------
    def report(self) -> dict:
        return {
            "reads": self.reads,
            "attempts": self.attempts,
            "retries": self.retries,
            "transient_failures": self.transient_failures,
            "timeouts": self.timeouts,
            "stragglers": self.stragglers,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "permanent_failures": self.permanent_failures,
            "crashes": self.crashes,
            "virtual_seconds": self.virtual_seconds,
        }


def injector_for(options) -> FaultInjector | None:
    """The injector an `ExecOptions` implies (None when fault-free)."""
    policy = getattr(options, "faults", None)
    if policy is None:
        return None
    if not isinstance(policy, FaultPolicy):
        raise TypeError(
            f"ExecOptions.faults must be a FaultPolicy, got {type(policy).__name__}"
        )
    return FaultInjector(policy)


def crash_point(injector: FaultInjector | None, point: str) -> None:
    """Module-level convenience: no-op without an injector."""
    if injector is not None:
        injector.crash(point)
