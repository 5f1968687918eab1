"""Serving front door: admission, backpressure, graceful degradation.

The planner answers one `QuerySpec` at a time with bounded error *or*
bounded latency; this layer makes that contract survive concurrent
multi-tenant traffic and overload.  The design is four standard serving
patterns wired around the existing `Session`/`QueryPlanner` stack, all
deterministic under a `faults.VirtualClock` so every latency / fairness /
shedding assertion in tests and `bench_serving_load` is a pure function
of the schedule:

  * **queue-based load leveling** — `submit()` only enqueues (bounded
    global queue, FIFO per tenant); a flush loop (`tick()`, or the
    `start()` thread, or the asyncio `serve()` wrapper on top) drains up
    to ``batch_cap`` requests per tick round-robin across tenants and
    executes them through the shared Session.  Identical effective
    requests in one flush are coalesced into a single planner call.
    Planner reads stay in fixed ``chunk``-sized partition slices, so
    concurrent mixed-shape traffic reuses the same shape buckets — the
    launch-key census is flat no matter the traffic mix (asserted in
    tests via the same trace counters `BatchPicker` snapshots).
  * **token-bucket rate limiting + bulkhead isolation** — each tenant
    has a refilling token bucket (reject → `OverloadError` with
    ``reason="rate_limited"`` and an exact ``retry_after``), a private
    queue cap (``"tenant_queue_full"``), and at most ``tenant_slots``
    of any flush — one hot tenant can saturate its own bulkhead but
    cannot starve the others' queue space or flush share.
  * **brownout before shedding** — a controller keyed on queue depth
    (watermark hysteresis) and the admitted-latency EMA raises a degrade
    level one step per tick; each level widens error bounds by
    ``brownout_widen`` and shrinks the planner's escalation cap by
    ``brownout_shrink`` (via the `budget_cap` hook), so the system first
    serves *worse answers with honest, wider intervals*.  Only when the
    global queue is full **and** the ladder is at its top does `submit`
    shed (``reason="shed"``, retry-after from the measured drain rate).
    Requests whose deadline expires while queued are shed before any
    partition read (`DeadlineExceededError` if strict, else
    ``reason="deadline"``).
  * **circuit breaker over routes** — each route is a prepared Session
    (e.g. device- and host-backend twins); after every flush the breaker
    reads the route's ``fault_report`` delta and opens on a
    permanent-failure rate above threshold, routing traffic to the next
    healthy route, then half-opens a probe after the cooldown.

Observability: `serve_stats()` reports p50/p95/p99 admitted latency,
queue depth, per-tenant admit/degrade/shed counters and breaker states;
`healthz()` returns the cheap status snapshot a load balancer polls.

The door itself is host bookkeeping; every request executes through a
route's `Session`, so it runs on the device that Session's options name
(the card by default).  The flush loop may run on the `start()` thread,
and the kernels then launch from that thread.  The census counters are
the port's shape-key registries: ``serve_compiles`` and
``eval_compiles`` count clustering and query-eval keys first seen since
the door was made.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import threading
import time

import numpy as np

from repro_torch.core import clustering
from repro_torch.errors import (
    DeadlineExceededError,
    InvalidQueryError,
    OverloadError,
)
from repro_torch.faults import VirtualClock
from repro_torch.queries import device as query_device
from repro_torch.queries.engine import query_key


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """All admission / brownout / breaker policy in one frozen value."""

    # queue-based load leveling
    max_queue: int = 64  # global bound across every tenant queue
    batch_cap: int = 8  # requests drained per flush tick
    # bulkhead isolation
    tenant_queue_cap: int = 16  # per-tenant backlog bound
    tenant_slots: int = 4  # per-tenant share of one flush
    # token-bucket rate limiting (per tenant)
    tenant_rate: float = 64.0  # sustained requests/sec
    tenant_burst: float = 16.0  # bucket capacity
    # brownout ladder (level 0 = healthy .. brownout_levels = maximum)
    brownout_levels: int = 3
    brownout_widen: float = 1.6  # error-bound multiplier per level
    brownout_shrink: float = 0.5  # escalation-cap multiplier per level
    brownout_budget0: int = 128  # level-1 escalation cap (partitions)
    high_water: float = 0.5  # queue fraction that raises the level
    low_water: float = 0.2  # queue fraction that lowers it (hysteresis)
    latency_slo: float | None = None  # admitted-latency EMA that also
    # raises the level (None = queue-depth control only)
    latency_alpha: float = 0.2  # admitted-latency EMA smoothing
    # circuit breaker (per route, on the fault_report failure rate)
    breaker_threshold: float = 0.5  # permanent-failure rate that opens
    breaker_min_reads: int = 8  # minimum reads before judging a window
    breaker_cooldown: float = 30.0  # seconds open before a half-open probe
    # telemetry
    latency_window: int = 4096  # admitted-latency reservoir (percentiles)

    def __post_init__(self):
        if self.max_queue < 1 or self.batch_cap < 1:
            raise InvalidQueryError("max_queue and batch_cap must be >= 1")
        if self.tenant_queue_cap < 1 or self.tenant_slots < 1:
            raise InvalidQueryError(
                "tenant_queue_cap and tenant_slots must be >= 1"
            )
        if self.brownout_levels < 1:
            raise InvalidQueryError("brownout_levels must be >= 1")
        if not 0.0 <= self.low_water <= self.high_water <= 1.0:
            raise InvalidQueryError(
                "need 0 <= low_water <= high_water <= 1"
            )


class TokenBucket:
    """Classic refilling token bucket on an injected clock."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = float(now)

    def _refill(self, now: float) -> None:
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now

    def try_take(self, now: float) -> bool:
        self._refill(now)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def eta(self, now: float) -> float:
        """Seconds until one token is available (0 when it already is)."""
        self._refill(now)
        if self.tokens >= 1.0:
            return 0.0
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else float("inf")


class CircuitBreaker:
    """closed → open (failure-rate trip) → half-open probe → closed.

    Judged on deltas of the route Session's ``fault_report`` between
    flushes: a window with at least ``min_reads`` reads whose permanent
    failure rate crosses ``threshold`` opens the breaker for
    ``cooldown`` seconds; the first flush after the cooldown is the
    half-open probe — clean closes it, dirty re-opens.
    """

    def __init__(self, threshold: float, min_reads: int, cooldown: float):
        self.threshold = threshold
        self.min_reads = min_reads
        self.cooldown = cooldown
        self.state = "closed"
        self.opened_at = 0.0
        self.trips = 0
        self._reads0 = 0
        self._fail0 = 0

    def allow(self, now: float) -> bool:
        if self.state == "open" and now - self.opened_at >= self.cooldown:
            self.state = "half_open"
        return self.state != "open"

    def observe(self, report: dict | None, now: float) -> None:
        """Fold one flush's fault_report snapshot into the state machine."""
        if report is None:
            if self.state == "half_open":
                self.state = "closed"
            return
        reads = int(report.get("reads", 0))
        fails = int(report.get("permanent_failures", 0))
        d_reads, d_fails = reads - self._reads0, fails - self._fail0
        self._reads0, self._fail0 = reads, fails
        if d_reads < self.min_reads:
            return  # window too small to judge
        dirty = d_fails / d_reads >= self.threshold
        if dirty:
            self.state = "open"
            self.opened_at = now
            self.trips += 1
        elif self.state == "half_open":
            self.state = "closed"


class Ticket:
    """Completion handle for one submitted request (future-like).

    ``result()`` blocks (real time) until the flush loop resolves it,
    then returns the `PlannedAnswer` or raises the typed error; in
    virtual-time tests the caller pumps ``tick()`` itself and reads
    ``answer`` / ``error`` directly.
    """

    def __init__(self, tenant: str, submitted: float):
        self.tenant = tenant
        self.submitted = submitted  # clock instant of admission
        self.answer = None
        self.error: BaseException | None = None
        self.degrade_level = 0  # brownout level applied at execution
        self.queue_seconds = 0.0
        self.latency = 0.0  # admission → resolution, on the door's clock
        self._done = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: list = []

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError("ticket not resolved within timeout")
        if self.error is not None:
            raise self.error
        return self.answer

    def add_done_callback(self, fn) -> None:
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)  # already resolved: fire inline

    def _resolve(self, answer=None, error: BaseException | None = None) -> None:
        with self._cb_lock:
            self.answer = answer
            self.error = error
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


@dataclasses.dataclass
class _Request:
    spec: object  # QuerySpec
    tenant: str
    deadline: float | None
    ticket: Ticket


class _Tenant:
    """Bulkhead state for one tenant: bucket, queue, counters."""

    def __init__(self, name: str, cfg: FrontDoorConfig, now: float):
        self.name = name
        self.bucket = TokenBucket(cfg.tenant_rate, cfg.tenant_burst, now)
        self.queue: collections.deque[_Request] = collections.deque()
        self.admitted = 0
        self.completed = 0
        self.degraded = 0
        self.shed = 0  # queue-full sheds attributed to this tenant
        self.rate_limited = 0
        self.queue_full = 0
        self.deadline_shed = 0
        self.errors = 0  # strict-contract raises resolved into tickets


class FrontDoor:
    """Concurrent admission + micro-batched execution for one table.

    ``routes`` maps names to *prepared* Sessions over the same table
    (typically backend twins); the breaker walks them in order.  With a
    `VirtualClock` the door is fully deterministic: nothing sleeps, the
    clock advances only through the injector's virtual read time and the
    explicit ``service_model`` seconds per executed request.
    """

    def __init__(
        self,
        session,
        *,
        routes: list[tuple[str, object]] | None = None,
        config: FrontDoorConfig | None = None,
        clock: VirtualClock | None = None,
        service_model=None,
    ):
        self.config = config or FrontDoorConfig()
        self.routes = list(routes) if routes else [("default", session)]
        if not self.routes:
            raise InvalidQueryError("FrontDoor needs at least one route")
        self.session = session
        self.clock = clock  # None = wall clock (time.monotonic)
        # virtual mode: seconds one executed request "costs", as a
        # function of partitions_read — the closed-loop bench calibrates
        # this against the real measured rate; real mode measures instead
        self.service_model = service_model
        self.breakers = {
            name: CircuitBreaker(
                self.config.breaker_threshold,
                self.config.breaker_min_reads,
                self.config.breaker_cooldown,
            )
            for name, _ in self.routes
        }
        self._lock = threading.RLock()
        self._tenants: dict[str, _Tenant] = {}
        self._rr: collections.deque[str] = collections.deque()  # round-robin
        self.level = 0  # current brownout level
        self.ticks = 0
        self.first_degrade_tick: int | None = None
        self.first_shed_tick: int | None = None
        self.sheds = 0
        self.sheds_at_max_level = 0
        self.coalesced = 0
        self.completed = 0
        self.degraded_answers = 0
        self.latency_ema: float | None = None
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=self.config.latency_window
        )
        self._flush_seconds_ema: float | None = None
        # census baseline: only traffic served by THIS door counts
        self._bucket_base = dict(clustering.trace_counts())
        self._eval_base = dict(query_device.TRACES.counts())
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()

    # ---- clock -------------------------------------------------------------
    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.monotonic()

    def _advance(self, dt: float) -> None:
        if self.clock is not None and dt > 0:
            self.clock.advance(dt)

    # ---- admission ---------------------------------------------------------
    def _tenant(self, name: str, now: float) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(name, self.config, now)
            self._rr.append(name)
        return t

    def _queue_depth_locked(self) -> int:
        return sum(len(t.queue) for t in self._tenants.values())

    def _drain_eta(self) -> float:
        """Retry-after hint: time to drain one flush's worth of queue."""
        per_flush = self._flush_seconds_ema or 0.05
        depth = self._queue_depth_locked()
        flushes = max(1.0, depth / self.config.batch_cap)
        return flushes * per_flush

    def submit(self, spec, *, tenant: str = "default",
               deadline: float | None = None) -> Ticket:
        """Admit one request or raise a typed `OverloadError`.

        Admission is pure bookkeeping — no partition is read here.  The
        rejection order is deliberate: rate limit (the tenant's own
        contract) → bulkhead queue cap (the tenant's own backlog) →
        global shed (system overload, only with the brownout ladder
        already at its top).
        """
        cfg = self.config
        with self._lock:
            now = self._now()
            t = self._tenant(tenant, now)
            if not t.bucket.try_take(now):
                t.rate_limited += 1
                raise OverloadError(
                    f"tenant {tenant!r} is over its rate limit "
                    f"({cfg.tenant_rate}/s)",
                    reason="rate_limited",
                    retry_after=t.bucket.eta(now),
                    tenant=tenant,
                )
            if len(t.queue) >= cfg.tenant_queue_cap:
                t.queue_full += 1
                raise OverloadError(
                    f"tenant {tenant!r} bulkhead queue is full "
                    f"({cfg.tenant_queue_cap})",
                    reason="tenant_queue_full",
                    retry_after=self._drain_eta(),
                    tenant=tenant,
                )
            if self._queue_depth_locked() >= cfg.max_queue:
                # ladder first, shed last: a full global queue forces the
                # maximum brownout level, so by construction no request is
                # ever shed while degradation steps remain untried
                if self.level < cfg.brownout_levels:
                    self.level = cfg.brownout_levels
                    if self.first_degrade_tick is None:
                        self.first_degrade_tick = self.ticks
                t.shed += 1
                self.sheds += 1
                self.sheds_at_max_level += 1
                if self.first_shed_tick is None:
                    self.first_shed_tick = self.ticks
                raise OverloadError(
                    f"serving queue full ({cfg.max_queue}); brownout level "
                    f"{self.level}/{cfg.brownout_levels} exhausted",
                    reason="shed",
                    retry_after=self._drain_eta(),
                    tenant=tenant,
                )
            ticket = Ticket(tenant, now)
            t.queue.append(_Request(spec, tenant, deadline, ticket))
            t.admitted += 1
            return ticket

    # ---- brownout controller ----------------------------------------------
    def _update_level_locked(self) -> None:
        cfg = self.config
        depth = self._queue_depth_locked()
        pressured = depth >= cfg.high_water * cfg.max_queue
        if cfg.latency_slo is not None and self.latency_ema is not None:
            pressured = pressured or self.latency_ema > cfg.latency_slo
        if pressured:
            if self.level < cfg.brownout_levels:
                self.level += 1
                if self.first_degrade_tick is None:
                    self.first_degrade_tick = self.ticks
        elif depth <= cfg.low_water * cfg.max_queue and self.level > 0:
            if (cfg.latency_slo is None or self.latency_ema is None
                    or self.latency_ema <= cfg.latency_slo):
                self.level -= 1

    def _degrade(self, spec):
        """Apply the current brownout level to one spec.

        → (effective spec, budget_cap, level applied).  Level L widens a
        relative error bound by ``widen**L`` (capped at 1.0) and clamps
        planner escalation to ``budget0 · shrink**(L-1)`` partitions.
        """
        cfg, level = self.config, self.level
        if level <= 0:
            return spec, None, 0
        cap = max(
            self.session.planner_config.chunk,
            int(cfg.brownout_budget0 * cfg.brownout_shrink ** (level - 1)),
        )
        if spec.error_bound is not None:
            widened = min(1.0, spec.error_bound * cfg.brownout_widen ** level)
            spec = dataclasses.replace(spec, error_bound=widened)
        return spec, cap, level

    # ---- routing -----------------------------------------------------------
    def _route(self, now: float):
        for name, sess in self.routes:
            if self.breakers[name].allow(now):
                return name, sess
        # every breaker open: serve on the least-recently-tripped route
        # (refusing reads entirely would turn a backend brownout into an
        # outage); its next observation doubles as the half-open probe
        name = min(self.routes, key=lambda r: self.breakers[r[0]].opened_at)[0]
        self.breakers[name].state = "half_open"
        return name, dict(self.routes)[name]

    # ---- the flush loop ----------------------------------------------------
    def _drain_locked(self) -> list[_Request]:
        """Round-robin across tenant queues, honoring bulkhead slots."""
        cfg = self.config
        out: list[_Request] = []
        took: dict[str, int] = collections.defaultdict(int)
        if self._rr:
            # rotate the ring once per flush so no tenant is always first
            self._rr.rotate(-1)
        progressed = True
        while progressed and len(out) < cfg.batch_cap:
            progressed = False
            for name in self._rr:
                if len(out) >= cfg.batch_cap:
                    break
                t = self._tenants[name]
                if t.queue and took[name] < cfg.tenant_slots:
                    out.append(t.queue.popleft())
                    took[name] += 1
                    progressed = True
        return out

    def tick(self) -> int:
        """One flush: update brownout, drain, shed expired, coalesce,
        execute through the breaker-chosen route, resolve tickets.
        Returns the number of tickets resolved."""
        with self._lock:
            self.ticks += 1
            self._update_level_locked()
            batch = self._drain_locked()
            now = self._now()
        if not batch:
            return 0
        resolved = 0
        # shed expired-in-queue requests before any partition read
        runnable: list[tuple[_Request, object, int | None, int]] = []
        groups: dict[str, list[int]] = {}
        for req in batch:
            tkt = req.ticket
            tkt.queue_seconds = now - tkt.submitted
            if req.deadline is not None and now >= req.deadline:
                late = now - req.deadline
                if getattr(req.spec, "strict", False):
                    err: BaseException = DeadlineExceededError(
                        f"deadline expired {late:.3f}s before execution",
                        predicted_error=None, partitions_read=0,
                    )
                else:
                    err = OverloadError(
                        f"deadline expired {late:.3f}s in queue",
                        reason="deadline", tenant=req.tenant,
                    )
                with self._lock:
                    self._tenants[req.tenant].deadline_shed += 1
                self._finish(tkt, error=err, now=now)
                resolved += 1
                continue
            spec, cap, level = self._degrade(req.spec)
            tkt.degrade_level = level
            key = "|".join([
                query_key(spec.query),
                repr((spec.error_bound, spec.latency_bound, spec.budget,
                      spec.strict, cap, req.deadline)),
            ])
            groups.setdefault(key, []).append(len(runnable))
            runnable.append((req, spec, cap, level))
        route_name, route_sess = self._route(now)
        for key, members in groups.items():
            lead_req, lead_spec, cap, level = runnable[members[0]]
            self.coalesced += len(members) - 1
            t0 = time.perf_counter()
            try:
                ans = route_sess.execute(
                    lead_spec,
                    deadline=lead_req.deadline,
                    clock=self._now if self.clock is not None else None,
                    budget_cap=cap,
                )
                err = None
            except Exception as e:  # typed planner errors → the ticket
                ans, err = None, e
            if self.service_model is not None:
                self._advance(self.service_model(
                    0 if ans is None else ans.partitions_read
                ))
            dt = time.perf_counter() - t0
            end = self._now()
            for i in members:
                req = runnable[i][0]
                self._finish(
                    req.ticket, answer=ans, error=err, now=end, level=level
                )
                resolved += 1
            with self._lock:
                self._flush_seconds_ema = (
                    dt if self._flush_seconds_ema is None
                    else 0.7 * self._flush_seconds_ema + 0.3 * dt
                )
        with self._lock:
            self.breakers[route_name].observe(
                route_sess.stats().get("fault_report"), self._now()
            )
        return resolved

    def _finish(self, ticket: Ticket, *, answer=None,
                error: BaseException | None = None, now: float,
                level: int = 0) -> None:
        ticket.latency = max(0.0, now - ticket.submitted)
        with self._lock:
            t = self._tenants[ticket.tenant]
            if error is None:
                t.completed += 1
                self.completed += 1
                self._latencies.append(ticket.latency)
                a = self.config.latency_alpha
                self.latency_ema = (
                    ticket.latency if self.latency_ema is None
                    else (1 - a) * self.latency_ema + a * ticket.latency
                )
                if level > 0 or (answer is not None and answer.plan.degraded):
                    t.degraded += 1
                    self.degraded_answers += 1
            else:
                t.errors += 1
        ticket._resolve(answer=answer, error=error)

    def run_until_idle(self, max_ticks: int = 10_000) -> int:
        """Pump `tick()` until every queue is empty (tests/virtual mode)."""
        done = 0
        for _ in range(max_ticks):
            with self._lock:
                if self._queue_depth_locked() == 0:
                    return done
            done += self.tick()
        return done

    # ---- background pump + asyncio face ------------------------------------
    def start(self, interval: float = 0.002) -> "FrontDoor":
        """Run the flush loop on a daemon thread (real-clock serving)."""
        if self._thread is not None:
            return self
        self._stop_evt.clear()

        def _loop():
            while not self._stop_evt.is_set():
                if self.tick() == 0:
                    self._stop_evt.wait(interval)

        self._thread = threading.Thread(
            target=_loop, name="frontdoor-flush", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None

    async def serve(self, spec, *, tenant: str = "default",
                    deadline: float | None = None):
        """Async face over submit(): awaits the ticket without blocking
        the event loop.  `OverloadError` raises immediately (admission is
        synchronous bookkeeping); execution errors raise on await."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        ticket = self.submit(spec, tenant=tenant, deadline=deadline)

        def _resolve(t: Ticket) -> None:
            def _set():
                if fut.cancelled():
                    return
                if t.error is not None:
                    fut.set_exception(t.error)
                else:
                    fut.set_result(t.answer)
            loop.call_soon_threadsafe(_set)

        ticket.add_done_callback(_resolve)
        return await fut

    # ---- observability ------------------------------------------------------
    def _percentiles(self) -> dict:
        if not self._latencies:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        arr = np.asarray(self._latencies)
        p50, p95, p99 = np.percentile(arr, [50, 95, 99])
        return {"p50": float(p50), "p95": float(p95), "p99": float(p99)}

    def serve_stats(self) -> dict:
        with self._lock:
            serve_compiles = len(set(clustering.trace_counts()) - set(self._bucket_base))
            eval_compiles = len(
                set(query_device.TRACES.counts()) - set(self._eval_base)
            )
            tenants = {
                t.name: {
                    "admitted": t.admitted,
                    "completed": t.completed,
                    "degraded": t.degraded,
                    "shed": t.shed,
                    "rate_limited": t.rate_limited,
                    "queue_full": t.queue_full,
                    "deadline_shed": t.deadline_shed,
                    "errors": t.errors,
                    "queued": len(t.queue),
                }
                for t in self._tenants.values()
            }
            sess_stats = self.session.stats()
            return {
                "ticks": self.ticks,
                "queue_depth": self._queue_depth_locked(),
                "brownout_level": self.level,
                "completed": self.completed,
                "degraded_answers": self.degraded_answers,
                "coalesced": self.coalesced,
                "sheds": self.sheds,
                "sheds_at_max_level": self.sheds_at_max_level,
                "first_degrade_tick": self.first_degrade_tick,
                "first_shed_tick": self.first_shed_tick,
                "latency": self._percentiles(),
                "latency_ema": self.latency_ema,
                "tenants": tenants,
                "breakers": {
                    name: {"state": b.state, "trips": b.trips}
                    for name, b in self.breakers.items()
                },
                "serve_compiles": serve_compiles,
                "eval_compiles": eval_compiles,
                "answer_ttl_expired": sess_stats.get("answer_ttl_expired", 0),
                "ema_keys": sess_stats.get("ema_keys", 0),
            }

    def healthz(self) -> dict:
        """Cheap liveness/pressure snapshot for a poller."""
        with self._lock:
            depth = self._queue_depth_locked()
            if depth >= self.config.max_queue:
                status = "overloaded"
            elif self.level > 0:
                status = "degraded"
            else:
                status = "ok"
            return {
                "status": status,
                "queue_depth": depth,
                "brownout_level": self.level,
                "latency_p99": self._percentiles()["p99"],
                "breakers": {n: b.state for n, b in self.breakers.items()},
            }
