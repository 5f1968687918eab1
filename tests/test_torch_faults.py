"""The port's fault injection and fault-aware planner vs the JAX reference.

The reference's contract (`tests/test_faults.py`): a seeded `FaultPolicy`
makes every partition-read outcome a pure function of the seed; the
planner masks irrecoverable reads inside its padded chunk shapes,
substitutes must-reads and stratum members from the still-readable
candidates, re-expands the survivors' SRSWOR weights and reports
``degraded``/``partitions_failed``; exact reads raise `PartitionReadError`.

Held here across the two packages:

  * the injector's schedule is the reference's for the same policy and
    ids — survivors, lost ids, attempt counters, virtual time;
  * on one tpch table (48 partitions x 96 rows) with the reference's
    picker grafted into the port (`carry.picker`), the port's planner
    under the reference's ``GATE`` and ``CHAOS`` policies reads the same
    partitions in the same rounds, loses the same ids, and returns the
    reference's estimates bit for bit on the host backend and within
    rtol 1e-5 on the device backend (the CPU here: the f32-sum
    tolerance of `tests/test_torch_planner.py`);
  * the reference's own assertions, ported as they are (its census test
    on the single plane: the port has no mesh).
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

import repro.api as ref_api
from repro import faults as ref_faults
from repro.backends import ExecOptions as RefExecOptions
from repro.core.picker import PickerConfig as RefPickerConfig
from repro.core.picker import train_picker as ref_train_picker
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.planner import QueryPlanner as RefQueryPlanner
from repro.queries.engine import AnswerStore as RefAnswerStore
from repro.queries.engine import per_partition_answers as ref_per_partition_answers
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro_torch import api, carry
from repro_torch import faults as port_faults
from repro_torch.backends import ExecOptions
from repro_torch.core.features import FeatureBuilder
from repro_torch.data.table import Table
from repro_torch.errors import BudgetExhaustedError, InjectedCrash, PartitionReadError
from repro_torch.faults import (
    FaultInjector, FaultPolicy, VirtualClock, crash_point, injector_for,
)
from repro_torch.planner import PlannerConfig, QueryPlanner
from repro_torch.queries import device
from repro_torch.queries.engine import AnswerStore, EvalCache
import torch_threads

torch_threads.cap_under_xdist()

SEED = int(os.environ.get("CHAOS_SEED", "20240807"))
HOST = ExecOptions(backend="host")
DEVICE = ExecOptions(device="cpu")

# the reference's policies (`tests/test_faults.py`), built in both packages
POLICIES = {
    "chaos": dict(seed=SEED, dead_frac=0.05, fail_frac=0.05, timeout_frac=0.02,
                  straggler_frac=0.05),
    "gate": dict(seed=SEED, dead_frac=0.0125, fail_frac=0.05, timeout_frac=0.02,
                 straggler_frac=0.05),
}
CHAOS = FaultPolicy(**POLICIES["chaos"])
GATE = FaultPolicy(**POLICIES["gate"])


def _rel_err(keys_e, est, keys_t, truth) -> float:
    """The reference test's per-answer relative error (missing group = 1)."""
    if keys_t.size == 0:
        return 0.0
    lut = {int(k): i for i, k in enumerate(keys_e)}
    tot, cnt = 0.0, 0
    for gi, k in enumerate(keys_t):
        i = lut.get(int(k))
        for j in range(truth.shape[1]):
            t = truth[gi, j]
            if np.isnan(t):
                continue
            if i is None or np.isnan(est[i, j]):
                tot += 1.0
            else:
                tot += min(abs(est[i, j] - t) / max(abs(t), 1e-12), 1.0)
            cnt += 1
    return tot / max(cnt, 1)


@pytest.fixture(scope="module")
def ctx():
    """The reference's fixture (tpch 48x96, a tiny picker trained on the
    host backend, 10 held-out queries) and its port twin: the same table,
    the reference picker grafted over the reference's sketches."""
    ref_table = ref_make_dataset("tpch", num_partitions=48, rows_per_partition=96)
    art = ref_train_picker(ref_table, RefWorkloadSpec(ref_table, seed=0),
                           num_train_queries=24,
                           config=RefPickerConfig(num_trees=8, tree_depth=3,
                                                  feature_selection=False),
                           options=RefExecOptions(backend="host"))
    ref_queries = RefWorkloadSpec(ref_table, seed=123).sample_workload(10)
    table = carry.table(ref_table)
    fb = FeatureBuilder(table, carry.sketches(art.picker.fb.sk))
    queries = carry.queries(ref_queries)
    truth = {}
    for rq, q in zip(ref_queries, queries):
        truth[q.describe()] = ref_per_partition_answers(
            ref_table, rq, options=RefExecOptions(backend="host"))
    return SimpleNamespace(ref_table=ref_table, ref_picker=art.picker, ref_queries=ref_queries,
                           table=table, fb=fb, queries=queries, truth=truth)


def _picker(ctx, options):
    return carry.picker(ctx.ref_picker, ctx.table, ctx.fb, options=options)


def _planner(ctx, options):
    return QueryPlanner(_picker(ctx, options), AnswerStore(ctx.table, options=options))


def _ref_planner(ctx, policy):
    opts = RefExecOptions(backend="host", faults=policy)
    return RefQueryPlanner(ctx.ref_picker, RefAnswerStore(ctx.ref_table, options=opts))


# --------------------------------------------------------------------------
# the injector's schedule is the reference's
# --------------------------------------------------------------------------
SCHEDULES = {
    **POLICIES,
    "dead": dict(seed=SEED, dead_frac=0.3),
    "transient": dict(seed=SEED, fail_frac=0.3, max_attempts=4),
    "hedged": dict(seed=SEED, straggler_frac=1.0, hedge_after=0.05, straggler_delay=1.0),
    "unhedged": dict(seed=SEED, straggler_frac=1.0, hedge_after=1.0, straggler_delay=1.0),
    "timeouts": dict(seed=SEED, timeout_frac=1.0, max_attempts=2, chunk_timeout=0.25,
                     backoff_base=0.0),
    "mixed": dict(seed=7, dead_frac=0.1, fail_frac=0.2, timeout_frac=0.2, straggler_frac=0.2,
                  read_latency=0.003, backoff_mult=3.0, max_attempts=5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_injector_schedule_matches_reference(name):
    ref_policy = ref_faults.FaultPolicy(**SCHEDULES[name])
    policy = carry.fault_policy(ref_policy)
    assert policy == FaultPolicy(**SCHEDULES[name])
    ref_clock, clock = ref_faults.VirtualClock(), VirtualClock()
    ref_inj = ref_faults.FaultInjector(ref_policy, clock=ref_clock)
    inj = FaultInjector(policy, clock=clock)
    rng = np.random.default_rng(3)
    for ids in (np.arange(64), rng.permutation(200)[:50], np.arange(64), np.empty(0, np.int64)):
        ok_r, bad_r = ref_inj.read_ids(ids)
        ok, bad = inj.read_ids(ids)
        np.testing.assert_array_equal(ok, ok_r)
        np.testing.assert_array_equal(bad, bad_r)
        assert inj.report() == ref_inj.report()  # every counter, virtual time bit-equal
        assert clock.now() == ref_clock.now()
    assert [inj.is_dead(p) for p in range(300)] == [ref_inj.is_dead(p) for p in range(300)]


def test_uniform_keys_match_reference():
    """The schedule's one random source, key for key."""
    for parts in [(0xD0A, 5), (3, 1, 0, 0), (2**40, 9, 2, 1), (-4, 17)]:
        for seed in (0, SEED, 2**31 + 5):
            assert port_faults._uniform(seed, *parts) == ref_faults._uniform(seed, *parts)


# --------------------------------------------------------------------------
# the reference's injector assertions, ported as they are
# --------------------------------------------------------------------------
def test_schedule_is_pure_function_of_seed():
    ids = np.arange(64)
    runs = []
    for _ in range(2):
        inj = FaultInjector(CHAOS)
        ok1, bad1 = inj.read_ids(ids)
        ok2, bad2 = inj.read_ids(ids)  # second round re-rolls transients
        runs.append((ok1.tolist(), bad1.tolist(), ok2.tolist(), bad2.tolist(), inj.report()))
    assert runs[0] == runs[1], "same seed must reproduce the same schedule"
    a = FaultInjector(FaultPolicy(seed=SEED, dead_frac=0.5))
    b = FaultInjector(FaultPolicy(seed=SEED + 1, dead_frac=0.5))
    assert [a.is_dead(p) for p in range(512)] != [b.is_dead(p) for p in range(512)]


def test_dead_partitions_are_stable_and_fail_permanently():
    inj = FaultInjector(FaultPolicy(seed=SEED, dead_frac=0.3))
    dead = [p for p in range(100) if inj.is_dead(p)]
    assert 10 <= len(dead) <= 60  # ~30 of 100
    assert dead == [p for p in range(100) if inj.is_dead(p)]  # stable
    survivors, failed = inj.read_ids(np.arange(100))
    assert failed.tolist() == dead  # dead ⇔ permanently failed
    assert survivors.size + failed.size == 100
    assert inj.retries >= len(dead) * (inj.policy.max_attempts - 1)


def test_transient_failures_recover_via_retry():
    inj = FaultInjector(FaultPolicy(seed=SEED, fail_frac=0.3, max_attempts=4))
    survivors, failed = inj.read_ids(np.arange(200))
    assert survivors.size > 180  # 0.3^4 ≈ 0.8% permanent
    assert inj.retries > 0 and inj.transient_failures > 0
    assert inj.virtual_seconds > 0


def test_straggler_hedging_wins_and_costs_less():
    inj = FaultInjector(FaultPolicy(seed=SEED, straggler_frac=1.0, hedge_after=0.05,
                                    straggler_delay=1.0))
    survivors, failed = inj.read_ids(np.arange(32))
    assert failed.size == 0  # stragglers always complete
    assert inj.hedges == 32
    assert inj.hedge_wins > 0
    slow = FaultInjector(FaultPolicy(seed=SEED, straggler_frac=1.0, hedge_after=1.0,
                                     straggler_delay=1.0))
    slow.read_ids(np.arange(32))
    assert slow.hedges == 0
    assert slow.virtual_seconds >= inj.virtual_seconds


def test_timeouts_cost_chunk_timeout_per_attempt():
    inj = FaultInjector(FaultPolicy(seed=SEED, timeout_frac=1.0, max_attempts=2,
                                    chunk_timeout=0.25, backoff_base=0.0))
    survivors, failed = inj.read_ids(np.arange(4))
    assert survivors.size == 0
    assert inj.timeouts == 8  # 4 ids x 2 attempts
    assert inj.virtual_seconds == pytest.approx(0.5)  # max over parallel ids


def test_read_ids_strict_raises_typed_error():
    inj = FaultInjector(FaultPolicy(seed=SEED, dead_frac=0.5))
    with pytest.raises(PartitionReadError) as ei:
        inj.read_ids_strict(np.arange(40), "test")
    assert ei.value.failed_ids
    assert ei.value.report["permanent_failures"] == len(ei.value.failed_ids)


def test_policy_validation_and_injector_for():
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        FaultPolicy(dead_frac=1.5)
    with pytest.raises(ValueError, match="max_attempts"):
        FaultPolicy(max_attempts=0)
    assert injector_for(HOST) is None
    assert injector_for(HOST.replace(faults=CHAOS)).policy is CHAOS
    with pytest.raises(TypeError, match="FaultPolicy"):
        injector_for(HOST.replace(faults="nope"))
    # the options stay frozen and hashable with a policy inside
    assert hash(DEVICE.replace(faults=CHAOS)) == hash(ExecOptions(device="cpu", faults=CHAOS))


def test_crash_points_fire_once():
    inj = FaultInjector(FaultPolicy(seed=SEED).with_crash("p"))
    crash_point(None, "p")  # no injector: no-op
    inj.crash("other")  # unarmed point: no-op
    with pytest.raises(InjectedCrash) as ei:
        inj.crash("p")
    assert ei.value.point == "p"
    inj.crash("p")  # one-shot
    assert inj.crashes == 1
    assert not issubclass(InjectedCrash, Exception)  # un-swallowable


# --------------------------------------------------------------------------
# the fault-aware planner reads, loses and estimates what the reference does
# --------------------------------------------------------------------------
@pytest.mark.parametrize("options", [HOST, DEVICE], ids=["host", "device"])
@pytest.mark.parametrize("policy", ["gate", "chaos"])
def test_faulted_planner_matches_reference(ctx, policy, options):
    ref_policy = ref_faults.FaultPolicy(**POLICIES[policy])
    ref = _ref_planner(ctx, ref_policy)
    port = _planner(ctx, options.replace(faults=carry.fault_policy(ref_policy)))
    failed = 0
    for rq, q in zip(ctx.ref_queries, ctx.queries):
        for kw in (dict(error_bound=0.05), dict(error_bound=1e-6), dict(budget=12)):
            want, got = ref.answer(rq, **kw), port.answer(q, **kw)
            assert got.partitions_read == want.partitions_read
            np.testing.assert_array_equal(got.group_keys, want.group_keys)
            assert (got.plan.mode, got.plan.rounds, got.plan.schedule, got.plan.outliers,
                    got.plan.strata_sizes, got.plan.degraded, got.plan.partitions_failed,
                    got.plan.failed_ids) == (
                want.plan.mode, want.plan.rounds, want.plan.schedule, want.plan.outliers,
                want.plan.strata_sizes, want.plan.degraded, want.plan.partitions_failed,
                want.plan.failed_ids)
            assert got.plan.read_report == want.plan.read_report
            if options.backend == "host":
                np.testing.assert_array_equal(got.estimate, want.estimate)
                np.testing.assert_array_equal(got.ci_halfwidth, want.ci_halfwidth)
                assert got.plan.predicted_error == want.plan.predicted_error
            else:
                np.testing.assert_allclose(got.estimate, want.estimate, rtol=1e-5)
            failed += got.plan.partitions_failed
    assert failed > 0, "the policy injected no failures"


# --------------------------------------------------------------------------
# the reference's planner assertions, ported as they are
# --------------------------------------------------------------------------
def test_degraded_answers_hold_coverage(ctx):
    """With ~5% of reads failing, answers at the 5% bound keep >= 0.9
    empirical coverage and report degraded exactly."""
    planner = _planner(ctx, HOST.replace(faults=GATE))
    bound, hits, any_failed = 0.05, 0, 0
    for q in ctx.queries:
        pa = planner.answer(q, error_bound=bound)
        ta = ctx.truth[q.describe()]
        err = _rel_err(pa.group_keys, pa.estimate, ta.group_keys, ta.truth())
        hits += err <= bound
        any_failed += pa.plan.partitions_failed
        if pa.plan.partitions_failed:
            assert pa.plan.degraded
            assert len(pa.plan.failed_ids) == pa.plan.partitions_failed
            assert pa.plan.read_report["permanent_failures"] > 0
            assert pa.plan.mode != "exact"
    assert any_failed > 0, "chaos policy injected no failures"
    assert hits / len(ctx.queries) >= 0.9, f"{hits}/{len(ctx.queries)}"


def test_fault_free_plans_report_clean(ctx):
    pa = _planner(ctx, HOST).answer(ctx.queries[0], error_bound=0.05)
    assert not pa.plan.degraded
    assert pa.plan.partitions_failed == 0
    assert pa.plan.failed_ids == ()
    assert pa.plan.read_report == {}


def test_strict_mode_raises_on_failures(ctx):
    planner = _planner(ctx, HOST.replace(faults=CHAOS))
    raised = 0
    for q in ctx.queries:
        try:
            pa = planner.answer(q, error_bound=0.05, strict=True)
            assert pa.plan.partitions_failed == 0  # strict only passes clean
        except (PartitionReadError, BudgetExhaustedError):
            raised += 1
    assert raised > 0, "chaos policy never tripped strict mode"


def test_unachievable_bound_stops_at_full_read(ctx):
    dead = FaultPolicy(seed=SEED, dead_frac=0.25)
    planner = _planner(ctx, HOST.replace(faults=dead))
    q = next(q for q in ctx.queries if q.groupby)
    pa = planner.answer(q, error_bound=1e-6)
    assert pa.plan.degraded
    assert pa.plan.partitions_failed > 0
    assert pa.partitions_read <= pa.plan.candidates
    assert pa.plan.schedule[-1] == sum(pa.plan.strata_sizes)
    with pytest.raises(BudgetExhaustedError) as ei:
        _planner(ctx, HOST.replace(faults=dead)).answer(q, error_bound=1e-6, strict=True)
    assert ei.value.predicted_error > 1e-6
    assert ei.value.partitions_read > 0


def test_replacement_substitution_reads_same_stratum(ctx):
    clean = _planner(ctx, HOST)
    faulty = _planner(ctx, HOST.replace(faults=FaultPolicy(seed=SEED, dead_frac=0.15)))
    q = next(q for q in ctx.queries if q.groupby)
    pa_c = clean.answer(q, error_bound=0.05)
    pa_f = faulty.answer(q, error_bound=0.05)
    assert pa_f.plan.partitions_failed > 0
    assert pa_f.partitions_read >= int(0.7 * pa_c.partitions_read)


def test_degraded_ci_widens_vs_clean(ctx):
    q = next(q for q in ctx.queries if q.groupby)
    clean = _planner(ctx, HOST).answer(q, budget=24)
    faulty = _planner(ctx, HOST.replace(
        faults=FaultPolicy(seed=SEED, dead_frac=0.3))).answer(q, budget=24)
    assert faulty.plan.partitions_failed > 0
    present = ~np.isnan(faulty.estimate[:, 0])
    assert present.any()
    assert np.all(faulty.ci_halfwidth[present, 0] > 0), \
        "degraded answer claimed an exact interval over unreadable mass"
    common = np.intersect1d(clean.group_keys, faulty.group_keys)
    ic = np.searchsorted(clean.group_keys, common)
    jf = np.searchsorted(faulty.group_keys, common)
    assert float(np.nansum(faulty.ci_halfwidth[jf, 0])) >= \
        float(np.nansum(clean.ci_halfwidth[ic, 0]))


@pytest.mark.parametrize("options", [HOST, DEVICE], ids=["host", "device"])
def test_answer_store_exact_reads_raise(ctx, options):
    store = AnswerStore(ctx.table, options=options.replace(
        faults=FaultPolicy(seed=SEED, dead_frac=0.3)))
    with pytest.raises(PartitionReadError, match="AnswerStore.get"):
        store.get(ctx.queries[0])
    with pytest.raises(PartitionReadError, match="AnswerStore.get_batch"):
        store.get_batch(list(ctx.queries[:2]))


def test_answer_store_fault_free_unaffected(ctx):
    faulty = AnswerStore(ctx.table, options=HOST.replace(faults=FaultPolicy(
        seed=SEED, straggler_frac=0.2)))  # stragglers always succeed
    clean = AnswerStore(ctx.table, options=HOST)
    q = ctx.queries[0]
    a, b = faulty.get(q), clean.get(q)
    assert a.raw.tobytes() == b.raw.tobytes()
    assert faulty.injector.stragglers > 0


def test_census_flat_under_faults(ctx):
    """Failed partitions are masked inside the padded chunk shapes: a
    fault-injected escalation launches no key outside the fault-free
    chunk census (the reference's single-plane case)."""
    planner = _planner(ctx, DEVICE.replace(faults=CHAOS))
    chunk = PlannerConfig().chunk
    sub = Table(ctx.table.schema, {k: v[:chunk] for k, v in ctx.table.columns.items()},
                name=f"{ctx.table.name}/censusprobe")
    probes = [q for q in ctx.queries if q.groupby][:3]
    expected = set()
    for q in probes:
        expected |= device.workload_census(sub, [q])
    device.TRACES.reset()
    failed = 0
    for q in probes:
        for bound in (0.10, 0.05, 1e-6):  # incl. capped escalation to full
            failed += planner.answer(q, error_bound=bound).plan.partitions_failed
    assert set(device.TRACES.counts()) <= expected, (device.TRACES.counts(), expected)
    assert failed > 0, "chaos policy injected no failures"


@pytest.mark.parametrize("mesh", [2, 8], ids=["mesh2", "mesh8"])
def test_census_flat_under_faults_on_a_plane(ctx, mesh):
    """The reference's plane lanes on ``mesh`` logical CPU shards: every
    key the faulted escalation launches is a key of the fault-free chunk
    census at the plane's local shapes, and the answers equal the
    single-device port's byte for byte."""
    opts = DEVICE.replace(faults=CHAOS, mesh=mesh)
    planner = _planner(ctx, opts)
    single = _planner(ctx, DEVICE.replace(faults=CHAOS))
    chunk = PlannerConfig().chunk
    sub = Table(ctx.table.schema, {k: v[:chunk] for k, v in ctx.table.columns.items()},
                name=f"{ctx.table.name}/censusprobe")
    probes = [q for q in ctx.queries if q.groupby][:3]
    expected = set()
    for q in probes:
        expected |= device.workload_census(sub, [q], EvalCache(sub, options=opts))
    bounds = (0.10, 0.05, 1e-6)
    want = [single.answer(q, error_bound=b) for q in probes for b in bounds]
    device.TRACES.reset()
    got = [planner.answer(q, error_bound=b) for q in probes for b in bounds]
    keys = set(device.TRACES.counts())
    for g, w in zip(got, want, strict=True):
        assert g.estimate.tobytes() == w.estimate.tobytes()
        assert g.partitions_read == w.partitions_read
    failed = sum(g.plan.partitions_failed for g in got)
    assert keys <= expected, (keys, expected)
    assert failed > 0, "chaos policy injected no failures on this plane"


def _session(ctx, options):
    sess = api.Session(ctx.table, options=options)
    sess.picker = _picker(ctx, options)
    sess.planner = QueryPlanner(sess.picker, sess.answers, views=sess.views,
                                config=sess.planner_config)
    sess._fb_version = ctx.table.version
    return sess


def test_session_threads_faults_and_reports(ctx):
    sess = _session(ctx, HOST.replace(faults=CHAOS))
    degraded = 0
    for q in ctx.queries[:5]:
        ans = sess.execute(api.QuerySpec(q, error_bound=0.05))
        degraded += int(ans.plan.degraded)
    st = sess.stats()
    assert st["degraded_answers"] == degraded
    assert st["fault_report"]["reads"] > 0
    assert st["partitions_failed"] >= 0
    assert _session(ctx, HOST).stats()["fault_report"] is None


def test_session_stats_match_reference(ctx):
    """The fault keys of `Session.stats` count what the reference's do."""
    ref_sess = ref_api.Session(ctx.ref_table, options=RefExecOptions(
        backend="host", faults=ref_faults.FaultPolicy(**POLICIES["chaos"])))
    ref_sess.picker = ctx.ref_picker
    ref_sess.planner = RefQueryPlanner(ref_sess.picker, ref_sess.answers, views=ref_sess.views,
                                       config=ref_sess.planner_config)
    ref_sess._fb_version = ctx.ref_table.version
    sess = _session(ctx, HOST.replace(faults=CHAOS))
    for rq, q in zip(ctx.ref_queries, ctx.queries):
        ref_sess.execute(ref_api.QuerySpec(rq, error_bound=0.05))
        sess.execute(api.QuerySpec(q, error_bound=0.05))
    want, got = ref_sess.stats(), sess.stats()
    for key in ("degraded_answers", "partitions_failed", "fault_report", "chunk_evals"):
        assert got[key] == want[key], key
    assert got["partitions_failed"] > 0


def test_spec_strict_propagates(ctx):
    sess = _session(ctx, HOST.replace(faults=FaultPolicy(seed=SEED, dead_frac=0.4)))
    q = next(q for q in ctx.queries if q.groupby)
    with pytest.raises((PartitionReadError, BudgetExhaustedError)):
        sess.execute(api.QuerySpec(q, error_bound=0.05, strict=True))
