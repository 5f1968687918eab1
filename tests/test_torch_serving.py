"""The port's serving path (`BatchPicker`, `FrontDoor`) vs the JAX reference.

One kdd table (16 partitions x 64 rows, the reference's
`tests/test_frontdoor.py` size) and one reference Session prepared on the
host backend with a tiny picker; the port's Sessions get that picker
grafted in (`carry.picker`).  Held across the two packages:

  * `FrontDoor`: the same submit schedule on a `VirtualClock`, over the
    same routes (a route whose every read fails, then a clean one), gives
    the reference door's ticket outcomes — admitted, or refused with the
    same reason (and the same ``retry_after`` where it is a function of
    the schedule: rate limits, and sheds before the first flush; later
    ones scale a wall-clock flush time) — the same brownout level after
    every tick, the same virtual latencies, bit-equal answers on the host
    backend, and the same breaker trips;
  * `BatchPicker`: the reference's selections, and its estimates bit for
    bit on the host backend;
  * the reference's `tests/test_frontdoor.py` and BatchPicker assertions
    of `tests/test_serving.py`, ported as they are.  The port counts runs
    per shape key where the reference counts compiles, so its census
    checks hold launch-key sets (`serving/engine.py` docstring).
"""
import asyncio
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import repro.api as ref_api
from repro import faults as ref_faults
from repro.backends import ExecOptions as RefExecOptions
from repro.core.picker import PickerConfig as RefPickerConfig
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.errors import OverloadError as RefOverloadError
from repro.planner import QueryPlanner as RefQueryPlanner
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro.serving import BatchPicker as RefBatchPicker
from repro.serving import FrontDoor as RefFrontDoor
from repro.serving import FrontDoorConfig as RefFrontDoorConfig
from repro_torch import api, carry
from repro_torch.backends import ExecOptions
from repro_torch.core import clustering
from repro_torch.core.features import FeatureBuilder
from repro_torch.core.picker import PickerConfig
from repro_torch.data.datasets import make_dataset
from repro_torch.data.table import Table
from repro_torch.errors import DeadlineExceededError, OverloadError
from repro_torch.faults import FaultPolicy, VirtualClock
from repro_torch.planner import QueryPlanner
from repro_torch.queries import device
from repro_torch.queries.engine import AnswerStore, per_partition_answers, query_key
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.serving import BatchPicker, FrontDoor, FrontDoorConfig, TokenBucket
from repro_torch.serving.engine import pick_stream
import torch_threads

torch_threads.cap_under_xdist()

SEED = int(os.environ.get("CHAOS_SEED", "20240807"))
HOST = ExecOptions(backend="host", device="cpu")  # KMeans picks on the CPU too
DEVICE = ExecOptions(device="cpu")
REF_HOST = RefExecOptions(backend="host")
TINY = dict(num_trees=8, tree_depth=3, feature_selection=False)
OPEN_RATE = dict(tenant_rate=1e9, tenant_burst=1e9)


def _ref_session(table, options=REF_HOST):
    sess = ref_api.Session(table, options=options)
    sess.prepare(RefWorkloadSpec(table, seed=1), num_train_queries=10,
                 picker_config=RefPickerConfig(**TINY))
    return sess


def _ref_graft(ref_sess, options):
    """A reference Session over ``ref_sess``'s table and trained picker."""
    sess = ref_api.Session(ref_sess.table, options=options)
    sess.picker = ref_sess.picker
    sess.planner = RefQueryPlanner(sess.picker, sess.answers, views=sess.views,
                                   config=sess.planner_config)
    sess._fb_version = ref_sess.table.version
    return sess


def _graft(ref_sess, options, table=None, **session_kw):
    """A port Session with ``ref_sess``'s trained picker grafted in."""
    table = table if table is not None else carry.table(ref_sess.table)
    sess = api.Session(table, options=options, **session_kw)
    fb = FeatureBuilder(table, carry.sketches(ref_sess.picker.fb.sk))
    sess.picker = carry.picker(ref_sess.picker, table, fb, options=options)
    sess.planner = QueryPlanner(sess.picker, sess.answers, views=sess.views,
                                config=sess.planner_config)
    sess._fb_version = table.version
    return sess


@pytest.fixture(scope="module")
def ctx():
    ref_table = ref_make_dataset("kdd", num_partitions=16, rows_per_partition=64)
    ref_sess = _ref_session(ref_table)
    ref_queries = RefWorkloadSpec(ref_table, seed=7).sample_workload(6)
    sess = _graft(ref_sess, HOST)
    return SimpleNamespace(ref_sess=ref_sess, ref_queries=ref_queries, sess=sess,
                           queries=carry.queries(ref_queries))


def _door(sess, clock, **cfg_kw):
    defaults = dict(max_queue=64, batch_cap=4, **OPEN_RATE)
    defaults.update(cfg_kw)
    return FrontDoor(sess, clock=clock, service_model=lambda p: 0.002 + 0.0005 * p,
                     config=FrontDoorConfig(**defaults))


# --------------------------------------------------------------------------
# the door's schedule is the reference's
# --------------------------------------------------------------------------
DOOR_CFG = dict(max_queue=6, batch_cap=2, tenant_queue_cap=3, tenant_slots=1, tenant_rate=4.0,
                tenant_burst=3.0, brownout_levels=2, breaker_min_reads=4,
                breaker_threshold=0.5, breaker_cooldown=0.5)


def _drive(door, clock, specs, errors):
    """One virtual-time schedule: a flood before any flush, ticks, later
    arrivals, a drain.  → ([(kind, detail, ticket)], [level after tick])."""
    out, levels = [], []

    def submit(i, tenant):
        try:
            t = door.submit(specs[i % len(specs)], tenant=tenant,
                            deadline=clock.now() + 0.02 if i % 5 == 4 else None)
            out.append(("admitted", None, t))
        except errors as e:
            out.append((e.reason, (e.tenant, e.retry_after, door.ticks == 0), None))

    for i in range(14):  # flood: rate limits, bulkheads, sheds at the ladder's top
        submit(i, f"t{i % 3}")
    for step in range(6):
        door.tick()
        levels.append(door.level)
        clock.advance(0.15)
        for i in range(3):
            submit(step * 3 + i, f"t{(step + i) % 4}")
    door.run_until_idle()
    for _ in range(3):
        door.tick()
        levels.append(door.level)
    return out, levels


def test_frontdoor_schedule_matches_reference(ctx):
    ref_bad = _ref_graft(ctx.ref_sess, RefExecOptions(
        backend="host", faults=ref_faults.FaultPolicy(seed=SEED, dead_frac=1.0, max_attempts=1)))
    ref_clk = ref_faults.VirtualClock()
    ref_door = RefFrontDoor(ctx.ref_sess, routes=[("bad", ref_bad), ("good", ctx.ref_sess)],
                            clock=ref_clk, service_model=lambda p: 0.002 + 0.0005 * p,
                            config=RefFrontDoorConfig(**DOOR_CFG))
    bad = _graft(ctx.ref_sess, HOST.replace(faults=FaultPolicy(seed=SEED, dead_frac=1.0,
                                                               max_attempts=1)),
                 table=ctx.sess.table)
    clk = VirtualClock()
    door = FrontDoor(ctx.sess, routes=[("bad", bad), ("good", ctx.sess)], clock=clk,
                     service_model=lambda p: 0.002 + 0.0005 * p,
                     config=FrontDoorConfig(**DOOR_CFG))
    ref_specs = [ref_api.QuerySpec(q, error_bound=0.1) for q in ctx.ref_queries]
    specs = [api.QuerySpec(q, error_bound=0.1) for q in ctx.queries]
    want, want_levels = _drive(ref_door, ref_clk, ref_specs, RefOverloadError)
    got, got_levels = _drive(door, clk, specs, OverloadError)
    assert got_levels == want_levels
    assert max(got_levels) == DOOR_CFG["brownout_levels"]
    assert clk.now() == ref_clk.now()
    assert len(got) == len(want)
    kinds = {k for k, _, _ in got}
    assert {"admitted", "rate_limited", "shed"} <= kinds, kinds
    for (gk, gd, gt), (wk, wd, wt) in zip(got, want):
        assert gk == wk
        if gk != "admitted":
            assert gd[0] == wd[0] and gd[2] == wd[2]
            if gk == "rate_limited" or gd[2]:  # a function of the schedule
                assert gd[1] == wd[1]
            continue
        assert gt.done() and wt.done()
        assert (gt.degrade_level, gt.latency, gt.queue_seconds) == \
            (wt.degrade_level, wt.latency, wt.queue_seconds)
        assert type(gt.error).__name__ == type(wt.error).__name__
        if gt.error is not None:
            assert getattr(gt.error, "reason", None) == getattr(wt.error, "reason", None)
            continue
        np.testing.assert_array_equal(gt.answer.group_keys, wt.answer.group_keys)
        np.testing.assert_array_equal(gt.answer.estimate, wt.answer.estimate)
        assert gt.answer.partitions_read == wt.answer.partitions_read
        assert gt.answer.plan.degraded == wt.answer.plan.degraded
    gs, ws = door.serve_stats(), ref_door.serve_stats()
    for key in ("ticks", "brownout_level", "completed", "degraded_answers", "coalesced", "sheds",
                "sheds_at_max_level", "first_degrade_tick", "first_shed_tick", "latency",
                "latency_ema", "tenants", "breakers"):
        assert gs[key] == ws[key], key
    assert gs["breakers"]["bad"]["trips"] >= 1
    assert door.healthz() == ref_door.healthz()


# --------------------------------------------------------------------------
# BatchPicker picks and estimates what the reference's does
# --------------------------------------------------------------------------
@pytest.mark.parametrize("options", [HOST, DEVICE], ids=["host", "device"])
def test_batch_picker_matches_reference(ctx, options):
    """Without clustering the picks are the reference's ids and the
    estimates its bits (host backend); with clustering a 2-member cluster
    ties exactly at its median, so either member may be its exemplar
    (`ROADMAP.md` § 3): the groups, budgets and weights must agree."""
    sess = _graft(ctx.ref_sess, options, table=ctx.sess.table)
    ref_bp = RefBatchPicker(ctx.ref_sess.picker, options=REF_HOST)
    bp = BatchPicker(sess.picker, options=options)
    queries = WorkloadSpec(sess.table, seed=9).sample_workload(8)
    ref_queries = RefWorkloadSpec(ctx.ref_sess.table, seed=9).sample_workload(8)
    for budget in (4, 8):
        want = ref_bp.answer_batch(ref_queries, budget, use_clustering=False, seed=5)
        got = bp.answer_batch(queries, budget, use_clustering=False, seed=5)
        for (ge, gs), (we, ws) in zip(got, want, strict=True):
            np.testing.assert_array_equal(gs.ids, ws.ids)
            np.testing.assert_array_equal(gs.weights, ws.weights)
            if options.backend == "host":
                np.testing.assert_array_equal(ge, we)
            else:
                np.testing.assert_allclose(ge, we, rtol=1e-5, equal_nan=True)
        for gs, ws in zip(bp.pick_batch(queries, budget), ref_bp.pick_batch(ref_queries, budget),
                          strict=True):
            assert (gs.num_outliers, gs.group_sizes, gs.group_budgets) == (
                ws.num_outliers, ws.group_sizes, ws.group_budgets)
            np.testing.assert_array_equal(np.sort(gs.weights), np.sort(ws.weights))
    st, ref_st = bp.serve_stats(), ref_bp.serve_stats()
    for key in ("picks", "answer_hits", "answer_misses", "mesh_devices"):
        assert st[key] == ref_st[key], key
    assert st["fault_report"] is None


# --------------------------------------------------------------------------
# the reference's BatchPicker assertions (`tests/test_serving.py`)
# --------------------------------------------------------------------------
def test_batch_matches_single_query_path(ctx):
    picker = ctx.sess.picker
    queries = WorkloadSpec(ctx.sess.table, seed=9).sample_workload(10)
    bp = BatchPicker(picker)
    for q, sel in zip(queries, bp.pick_batch(queries, 8)):
        ref = picker.pick(q, 8)
        np.testing.assert_array_equal(sel.ids, ref.ids)
        np.testing.assert_allclose(sel.weights, ref.weights)


def test_answer_batch_uses_cache(ctx):
    table = ctx.sess.table
    queries = WorkloadSpec(table, seed=13).sample_workload(5)
    bp = BatchPicker(ctx.sess.picker)
    first = bp.answer_batch(queries, 8)
    assert bp.stats.answer_misses == 5 and bp.stats.answer_hits == 0
    second = bp.answer_batch(queries, 8)
    assert bp.stats.answer_hits == 5
    for (e1, _), (e2, _) in zip(first, second):
        np.testing.assert_allclose(e1, e2, equal_nan=True)
    for q, (est, sel) in zip(queries, second):
        ref = per_partition_answers(table, q, options=HOST).estimate(sel.ids, sel.weights)
        np.testing.assert_allclose(est, ref, equal_nan=True)


def test_pick_stream_chunks(ctx):
    picker = ctx.sess.picker
    queries = WorkloadSpec(ctx.sess.table, seed=19).sample_workload(7)
    streamed = list(pick_stream(picker, iter(queries), 8, batch_size=3))
    assert len(streamed) == 7
    for q, sel in zip(queries, streamed):
        np.testing.assert_array_equal(sel.ids, picker.pick(q, 8).ids)


def test_serving_census_bounded_over_traffic(ctx):
    """Serving a varied workload keeps the shape keys at the bucket census,
    not the query count; a warm pass adds no key."""
    queries = WorkloadSpec(ctx.sess.table, seed=23).sample_workload(30)
    clustering.reset_trace_counts()
    bp = BatchPicker(ctx.sess.picker)  # census baseline starts at construction
    for budget in (4, 6, 8, 12):
        bp.pick_batch(queries, budget)
    stats = bp.serve_stats()
    assert stats["picks"] == 120
    assert stats["compiles"] == len(stats["bucket_traces"]) == stats["shape_buckets"]
    assert 0 < stats["compiles"] < 30  # << 120 picks
    assert clustering.total_traces() == sum(clustering.trace_counts().values())
    keys = set(clustering.trace_counts())
    bp.pick_batch(queries, 8)  # warm: no new key
    assert set(clustering.trace_counts()) == keys
    assert bp.serve_stats()["compiles"] == stats["compiles"]


# --------------------------------------------------------------------------
# the reference's FrontDoor assertions (`tests/test_frontdoor.py`)
# --------------------------------------------------------------------------
def test_happy_path_matches_direct_execution(ctx):
    clk = VirtualClock()
    fd = _door(ctx.sess, clk)
    specs = [api.QuerySpec(q, error_bound=0.2) for q in ctx.queries]
    tickets = [fd.submit(s, tenant=f"t{i % 2}") for i, s in enumerate(specs)]
    n = fd.run_until_idle()
    assert n == len(tickets)
    for s, t in zip(specs, tickets):
        assert t.done() and t.error is None
        direct = ctx.sess.execute(s)
        assert np.array_equal(t.answer.group_keys, direct.group_keys)
        assert np.allclose(t.answer.estimate, direct.estimate, equal_nan=True)
        assert t.latency >= 0 and t.queue_seconds >= 0
    st = fd.serve_stats()
    assert st["completed"] == len(tickets)
    assert st["queue_depth"] == 0
    assert clk.now() > 0


def test_coalescing_identical_requests(ctx):
    fd = _door(ctx.sess, VirtualClock(), batch_cap=8)
    spec = api.QuerySpec(ctx.queries[0], error_bound=0.2)
    t1 = fd.submit(spec, tenant="a")
    t2 = fd.submit(spec, tenant="b")
    misses0 = ctx.sess.answers.misses
    fd.run_until_idle()
    assert t1.answer is t2.answer  # one planner call fanned out
    assert fd.serve_stats()["coalesced"] == 1
    assert ctx.sess.answers.misses == misses0


def test_token_bucket_rate_limit():
    clk = VirtualClock()
    bucket = TokenBucket(rate=2.0, burst=2.0, now=clk.now())
    assert bucket.try_take(clk.now()) and bucket.try_take(clk.now())
    assert not bucket.try_take(clk.now())
    eta = bucket.eta(clk.now())
    assert eta == pytest.approx(0.5)
    clk.advance(eta)
    assert bucket.try_take(clk.now())


def test_submit_rate_limited_typed(ctx):
    clk = VirtualClock()
    fd = _door(ctx.sess, clk, tenant_rate=1.0, tenant_burst=1.0)
    spec = api.QuerySpec(ctx.queries[0], error_bound=0.2)
    fd.submit(spec, tenant="slow")
    with pytest.raises(OverloadError) as ei:
        fd.submit(spec, tenant="slow")
    assert ei.value.reason == "rate_limited"
    assert ei.value.tenant == "slow"
    assert ei.value.retry_after > 0
    clk.advance(ei.value.retry_after)
    fd.submit(spec, tenant="slow")
    assert fd.serve_stats()["tenants"]["slow"]["rate_limited"] == 1


def test_bulkhead_queue_cap_isolates_tenants(ctx):
    fd = _door(ctx.sess, VirtualClock(), tenant_queue_cap=2, max_queue=64)
    spec = api.QuerySpec(ctx.queries[0], error_bound=0.2)
    fd.submit(spec, tenant="hog")
    fd.submit(spec, tenant="hog")
    with pytest.raises(OverloadError) as ei:
        fd.submit(spec, tenant="hog")
    assert ei.value.reason == "tenant_queue_full"
    fd.submit(spec, tenant="bystander")
    fd.run_until_idle()
    st = fd.serve_stats()["tenants"]
    assert st["hog"]["queue_full"] == 1 and st["bystander"]["admitted"] == 1


def test_shed_only_after_brownout_ladder_exhausted(ctx):
    fd = _door(ctx.sess, VirtualClock(), max_queue=6, batch_cap=2, brownout_levels=2)
    spec = api.QuerySpec(ctx.queries[0], error_bound=0.2)
    sheds = []
    for i in range(12):
        try:
            fd.submit(spec, tenant=f"t{i % 3}")
        except OverloadError as e:
            assert e.reason == "shed" and e.retry_after > 0
            assert fd.level == fd.config.brownout_levels
            sheds.append(e)
    assert sheds, "flood must overflow the global queue"
    st = fd.serve_stats()
    assert st["sheds"] == st["sheds_at_max_level"] == len(sheds)
    assert st["first_degrade_tick"] <= st["first_shed_tick"]
    fd.run_until_idle()
    assert fd.serve_stats()["queue_depth"] == 0


def test_brownout_widens_bounds_then_recovers(ctx):
    fd = _door(ctx.sess, VirtualClock(), max_queue=8, batch_cap=2, brownout_levels=3)
    spec = api.QuerySpec(ctx.queries[0], error_bound=0.10)
    tickets = [fd.submit(spec, tenant=f"t{i}") for i in range(6)]
    fd.run_until_idle()
    levels = [t.degrade_level for t in tickets]
    assert max(levels) >= 1
    st = fd.serve_stats()
    assert st["degraded_answers"] >= sum(1 for v in levels if v > 0)
    for _ in range(fd.config.brownout_levels):
        fd.tick()
    assert fd.level == 0
    assert fd.healthz()["status"] == "ok"


def test_brownout_budget_cap_reaches_planner(ctx):
    planner = ctx.sess.planner
    full = planner.answer(ctx.queries[0], error_bound=0.01)
    capped = planner.answer(ctx.queries[0], error_bound=0.01, budget_cap=4)
    assert capped.partitions_read < full.partitions_read
    assert capped.partitions_read <= 4 + capped.plan.outliers
    assert capped.plan.degraded or capped.plan.predicted_error <= 0.01


def test_deadline_expired_in_queue_sheds_before_any_read(ctx):
    clk = VirtualClock()
    fd = _door(ctx.sess, clk)
    strict = fd.submit(api.QuerySpec(ctx.queries[0], error_bound=0.2, strict=True),
                       deadline=clk.now() + 0.5)
    soft = fd.submit(api.QuerySpec(ctx.queries[1], error_bound=0.2),
                     deadline=clk.now() + 0.5)
    reads0 = ctx.sess.answers.hits + ctx.sess.answers.misses
    clk.advance(1.0)
    fd.run_until_idle()
    assert isinstance(strict.error, DeadlineExceededError)
    assert isinstance(soft.error, OverloadError)
    assert soft.error.reason == "deadline"
    assert ctx.sess.answers.hits + ctx.sess.answers.misses == reads0
    assert fd.serve_stats()["tenants"]["default"]["deadline_shed"] == 2


def test_deadline_mid_execution_returns_best_so_far():
    """A deadline that expires during escalation (the injector advancing a
    shared virtual clock) stops the planner between rounds: non-strict
    keeps the best answer with honest flags, strict raises."""
    ref_table = ref_make_dataset("kdd", num_partitions=48, rows_per_partition=64)
    sess = _graft(_ref_session(ref_table), HOST.replace(
        faults=FaultPolicy(seed=SEED, read_latency=0.1)))  # 0.1 s per chunk
    clk = VirtualClock()
    sess.planner.injector.clock = clk  # reads advance the deadline clock
    q = WorkloadSpec(sess.table, seed=7).sample_workload(3)[0]
    ans = sess.execute(api.QuerySpec(q, error_bound=0.001), deadline=clk.now() + 0.25,
                       clock=clk.now)
    assert ans.plan.deadline_hit and ans.plan.degraded
    assert 0 < ans.partitions_read < sess.table.num_partitions
    assert ans.plan.predicted_error > 0
    with pytest.raises(DeadlineExceededError) as ei:
        sess.execute(api.QuerySpec(q, error_bound=0.001, strict=True),
                     deadline=clk.now() + 0.25, clock=clk.now)
    assert ei.value.partitions_read > 0
    assert isinstance(ei.value, api.BudgetExhaustedError)


def test_deadline_already_expired_strict_raises_without_reading(ctx):
    clk = VirtualClock(start=10.0)
    misses0 = ctx.sess.answers.misses
    with pytest.raises(DeadlineExceededError) as ei:
        ctx.sess.execute(api.QuerySpec(ctx.queries[0], error_bound=0.2, strict=True),
                         deadline=5.0, clock=clk.now)
    assert ei.value.partitions_read == 0
    assert ctx.sess.answers.misses == misses0


def test_breaker_trips_on_bad_route_and_half_opens(ctx):
    bad = _graft(ctx.ref_sess, HOST.replace(
        faults=FaultPolicy(seed=SEED, dead_frac=1.0, max_attempts=1)))
    good = _graft(ctx.ref_sess, HOST, table=bad.table)
    clk = VirtualClock()
    fd = FrontDoor(good, routes=[("bad", bad), ("good", good)], clock=clk,
                   service_model=lambda p: 0.01,
                   config=FrontDoorConfig(breaker_min_reads=4, breaker_threshold=0.5,
                                          breaker_cooldown=5.0, **OPEN_RATE))
    q = WorkloadSpec(bad.table, seed=7).sample_workload(2)[0]
    spec = api.QuerySpec(q, error_bound=0.2)
    t0 = fd.submit(spec)
    fd.run_until_idle()
    assert t0.answer is not None and t0.answer.plan.degraded
    assert fd.breakers["bad"].state == "open"
    t1 = fd.submit(spec)
    fd.run_until_idle()
    assert t1.error is None and not t1.answer.plan.degraded
    assert fd.breakers["bad"].state == "open"
    clk.advance(6.0)
    assert fd.breakers["bad"].allow(clk.now())
    assert fd.breakers["bad"].state == "half_open"
    st = fd.serve_stats()
    assert st["breakers"]["bad"]["trips"] == 1
    assert st["breakers"]["good"]["state"] == "closed"


def _run_victim_schedule(fd, clk, spec, arrivals, hot_spec=None, hot_arrivals=()):
    victim, hot_refused = [], 0
    events = sorted([(t, "victim") for t in arrivals] + [(t, "hot") for t in hot_arrivals])
    i = 0
    while i < len(events) or fd.serve_stats()["queue_depth"] > 0:
        if i < len(events) and (fd.serve_stats()["queue_depth"] == 0
                                or events[i][0] <= clk.now()):
            t_arr, who = events[i]
            clk.advance_to(t_arr)
            try:
                tkt = fd.submit(hot_spec if who == "hot" else spec, tenant=who)
                if who == "victim":
                    victim.append(tkt)
            except OverloadError:
                if who == "hot":
                    hot_refused += 1
                else:
                    victim.append(None)
            i += 1
        else:
            fd.tick()
    fd.run_until_idle()
    return victim, hot_refused


def test_hot_tenant_cannot_move_victim_latency(ctx):
    cfg = dict(max_queue=32, batch_cap=4, tenant_slots=2, tenant_queue_cap=8,
               tenant_rate=50.0, tenant_burst=8.0)
    spec = api.QuerySpec(ctx.queries[0], error_bound=0.2)
    hot_spec = api.QuerySpec(ctx.queries[1], error_bound=0.2)
    arrivals = [0.05 * k for k in range(40)]
    clk_a = VirtualClock()
    solo, _ = _run_victim_schedule(_door(ctx.sess, clk_a, **cfg), clk_a, spec, arrivals)
    clk_b = VirtualClock()
    fd_b = _door(ctx.sess, clk_b, **cfg)
    hot_arrivals = [0.002 * k for k in range(1000)]  # 500/s vs a 50/s limit
    mixed, hot_refused = _run_victim_schedule(fd_b, clk_b, spec, arrivals, hot_spec,
                                              hot_arrivals)
    assert hot_refused > 0
    solo_lat = np.asarray([t.latency for t in solo if t is not None])
    mixed_lat = np.asarray([t.latency for t in mixed if t is not None])
    assert sum(1 for t in mixed if t is None) == sum(1 for t in solo if t is None) == 0
    svc_max = 0.002 + 0.0005 * ctx.sess.table.num_partitions
    assert float(np.percentile(mixed_lat, 99)) <= \
        float(np.percentile(solo_lat, 99)) + cfg["tenant_slots"] * svc_max
    stats = fd_b.serve_stats()["tenants"]
    assert stats["hot"]["rate_limited"] + stats["hot"]["queue_full"] > 0
    assert stats["victim"]["shed"] == 0


def test_census_flat_under_mixed_shape_traffic(ctx):
    sess = _graft(ctx.ref_sess, DEVICE, table=ctx.sess.table)
    chunk = sess.planner_config.chunk
    table = sess.table
    probes = [q for q in WorkloadSpec(table, seed=11).sample_workload(8) if q.groupby][:3]
    assert probes
    sub = Table(table.schema, {k: v[:chunk] for k, v in table.columns.items()},
                name=f"{table.name}/censusprobe")
    expected = set()
    for q in probes:
        expected |= device.workload_census(sub, [q])
    device.TRACES.reset()
    fd = _door(sess, VirtualClock(), batch_cap=8, max_queue=64)
    tickets = []
    for rep in range(3):  # interleave tenants and shapes across flushes
        for i, q in enumerate(probes):
            tickets.append(fd.submit(api.QuerySpec(q, error_bound=0.1 if rep else 0.2),
                                     tenant=f"t{(rep + i) % 3}"))
    fd.run_until_idle()
    assert all(t.error is None for t in tickets)
    assert set(device.TRACES.counts()) <= expected, (device.TRACES.counts(), expected)
    assert fd.serve_stats()["eval_compiles"] <= len(expected)


def test_session_ttl_expiry_counted_in_serve_stats():
    """On the port's own `Session.prepare` (host backend)."""
    clk = VirtualClock()
    table = make_dataset("kdd", num_partitions=8, rows_per_partition=64)
    sess = api.Session(table, options=HOST, answer_ttl=30.0, clock=clk.now)
    sess.prepare(WorkloadSpec(table, seed=1), num_train_queries=8,
                 picker_config=PickerConfig(**TINY))
    spec = api.QuerySpec(WorkloadSpec(table, seed=3).sample_workload(2)[0], budget=8)
    sess.execute(spec)
    misses0 = sess.answers.misses
    sess.execute(spec)
    assert sess.answers.misses == misses0
    clk.advance(31.0)
    sess.execute(spec)
    assert sess.answers.misses > misses0
    assert sess.stats()["answer_ttl_expired"] >= 1
    assert FrontDoor(sess, clock=clk).serve_stats()["answer_ttl_expired"] >= 1


def test_answer_store_concurrent_access_regression(ctx):
    table = ctx.sess.table
    queries = ctx.queries[:4]
    store = AnswerStore(table, capacity=2, options=HOST)  # constant churn
    expected = {q.describe(): store.get(q).raw.copy() for q in queries}
    errors: list = []
    start = threading.Barrier(6)

    def hammer(seed):
        rng = np.random.default_rng(seed)
        try:
            start.wait(timeout=10)
            for _ in range(30):
                q = queries[int(rng.integers(len(queries)))]
                mode = int(rng.integers(3))
                if mode == 0:
                    assert np.array_equal(store.get(q).raw, expected[q.describe()])
                elif mode == 1:
                    ids = np.sort(rng.choice(table.num_partitions, size=4,
                                             replace=False)).astype(np.int64)
                    assert store.get_subset(q, ids).raw.shape[0] == 4
                else:
                    store.get_batch(list(queries))
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_session_rates_ema_map_is_bounded(ctx):
    sess = ctx.sess
    q = ctx.queries[0]
    saved = dict(sess._rates)
    try:
        for i in range(api.Session.MAX_RATE_KEYS + 8):
            key = (f"backend{i}", 16)
            sess._rate_key = lambda key=key: key  # instance override
            sess.execute(api.QuerySpec(q, budget=2))
        stats = sess.stats()
        assert stats["ema_keys"] == len(sess._rates) <= api.Session.MAX_RATE_KEYS
        assert (f"backend{api.Session.MAX_RATE_KEYS + 7}", 16) in sess._rates
    finally:
        del sess._rate_key
        sess._rates.clear()
        sess._rates.update(saved)


def test_threaded_pump_concurrent_submitters(ctx):
    fd = FrontDoor(ctx.sess, config=FrontDoorConfig(**OPEN_RATE))
    fd.start(interval=0.001)
    try:
        results: dict[int, object] = {}
        errors: list = []

        def client(i):
            try:
                spec = api.QuerySpec(ctx.queries[i % len(ctx.queries)], error_bound=0.2)
                results[i] = fd.submit(spec, tenant=f"client{i % 3}").result(timeout=60)
            except Exception as e:  # pragma: no cover - failure capture
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 8
        assert all(r.estimate is not None for r in results.values())
    finally:
        fd.stop()
    assert fd.serve_stats()["completed"] >= 8


def test_asyncio_serve_face(ctx):
    fd = FrontDoor(ctx.sess, config=FrontDoorConfig(**OPEN_RATE))
    fd.start(interval=0.001)

    async def main():
        specs = [api.QuerySpec(q, error_bound=0.2) for q in ctx.queries[:4]]
        return await asyncio.gather(*(fd.serve(s, tenant=f"a{i % 2}")
                                      for i, s in enumerate(specs)))

    try:
        answers = asyncio.run(main())
    finally:
        fd.stop()
    assert len(answers) == 4
    assert all(a.partitions_read >= 0 for a in answers)


def test_healthz_snapshot_shape(ctx):
    h = _door(ctx.sess, VirtualClock()).healthz()
    assert h["status"] == "ok" and h["queue_depth"] == 0
    assert set(h) >= {"status", "queue_depth", "brownout_level", "latency_p99", "breakers"}


def test_query_key_coalesces_like_reference(ctx):
    """Coalescing keys on the canonical query text, as the reference does."""
    from repro.queries.engine import query_key as ref_query_key

    for rq, q in zip(ctx.ref_queries, ctx.queries):
        assert query_key(q) == ref_query_key(rq)
