"""Typed exception hierarchy for the robustness plane.

Every failure the system can *handle* gets its own type, so callers can
route on meaning instead of string-matching messages:

  * `PartitionReadError` — partition reads exhausted their retry budget
    (carries the failed ids); the planner catches this shape of failure
    and degrades instead of raising, the exact-read paths surface it.
  * `BudgetExhaustedError` — an error bound could not be met even after
    escalating to every readable partition (raised only under
    ``strict=True``; the default contract returns a ``degraded`` answer).
  * `StaleStateError` — a cache detected that its table snapshot no
    longer matches the table (out-of-band mutation of a column array,
    or derived state restored against the wrong table).
  * `WalCorruptError` — a write-ahead-log record or snapshot failed its
    checksum / schema validation on recovery.
  * `InjectedCrash` — a fault-injection crash point fired.  Deliberately
    a `BaseException`: an injected "process kill" must not be swallowed
    by ``except Exception`` recovery code under test.

Compatibility: the types that replaced bare ``ValueError`` /
``RuntimeError`` raises keep those as secondary bases, so pre-existing
``except ValueError`` / ``pytest.raises(RuntimeError)`` call sites are
unaffected by the migration.
"""
from __future__ import annotations


class ReproError(Exception):
    """Base of every typed error raised by the repro system."""


class InvalidQueryError(ReproError, ValueError):
    """A query/spec is malformed (bad operator, group radix, contract)."""


class SessionStateError(ReproError, RuntimeError):
    """A Session method was called out of lifecycle order."""


class StaleStateError(ReproError, RuntimeError):
    """Cached/derived state no longer matches the table it was built on.

    Raised by the `EvalCache` fingerprint guard when a column array is
    mutated out of band (no version bump), and by snapshot restore when
    the on-disk state does not match the recovered table.
    """


class PartitionReadError(ReproError):
    """Partition reads failed after exhausting the retry budget.

    ``failed_ids`` lists the unreadable partitions; ``report`` carries
    the injector/read telemetry (attempts, retries, hedges, timeouts).
    """

    def __init__(self, message: str, failed_ids=(), report: dict | None = None):
        super().__init__(message)
        self.failed_ids = tuple(int(i) for i in failed_ids)
        self.report = report or {}


class PartitionReadTimeout(PartitionReadError):
    """A partition read exceeded its per-chunk timeout on every attempt."""


class BudgetExhaustedError(ReproError):
    """An error bound stayed unmet after reading every readable partition.

    Only raised under ``strict=True``; the default planner contract stops
    at the capped escalation and returns the answer with
    ``plan.degraded = True`` instead.
    """

    def __init__(self, message: str, predicted_error: float | None = None,
                 partitions_read: int = 0):
        super().__init__(message)
        self.predicted_error = predicted_error
        self.partitions_read = partitions_read


class DeadlineExceededError(BudgetExhaustedError):
    """A request deadline expired before its error bound was met.

    In the `BudgetExhaustedError` family on purpose: a deadline is a
    budget denominated in seconds, and strict-mode callers that already
    catch budget exhaustion handle deadline expiry the same way.  Raised
    under ``strict=True`` (the planner's between-round deadline check,
    or the serving front door shedding an expired-in-queue request); the
    non-strict contract returns the best answer produced so far with
    ``plan.degraded``/``plan.deadline_hit`` set instead.
    """


class OverloadError(ReproError):
    """The serving front door refused a request to protect the system.

    ``reason`` routes the caller's response:

      * ``"rate_limited"`` — the tenant's token bucket is empty; retry
        after ``retry_after`` seconds without backing off other work.
      * ``"tenant_queue_full"`` — the tenant's bulkhead queue cap is hit
        (its own backlog, not system overload).
      * ``"shed"`` — the global queue is full with the brownout ladder
        exhausted; the system is overloaded and callers should back off
        for ``retry_after`` seconds.
      * ``"deadline"`` — the request expired while still queued and was
        shed before any partition read (non-strict requests; strict ones
        get `DeadlineExceededError`).
    """

    def __init__(self, message: str, *, reason: str = "shed",
                 retry_after: float = 0.0, tenant: str | None = None):
        super().__init__(message)
        self.reason = reason
        self.retry_after = float(retry_after)
        self.tenant = tenant


class WalError(ReproError):
    """Write-ahead-log / snapshot failure (I/O layer)."""


class WalCorruptError(WalError):
    """A WAL record or snapshot failed checksum/schema validation."""


class InjectedCrash(BaseException):
    """A fault-injection crash point fired (simulated process kill).

    BaseException on purpose: recovery code under test must not be able
    to swallow it with a broad ``except Exception``.
    """

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point
