"""The port's partition data plane on logical CPU shards vs its single-device path.

The twin of the reference's `tests/test_distributed_dataplane.py` on
``ExecOptions(device="cpu", mesh=n)``: n logical shards of the CPU stand
in for the reference's ``--xla_force_host_platform_device_count=8``
devices, so these lanes run in tier-1 where the reference's skip.  The
contract (`repro_torch/distributed/dataplane.py`): per-shard ingest and
query eval are bit-identical to the port's single-device path on 1, 2
and 8 shards, pad partitions never reach an answer, and the launch keys
a workload produces have the same cardinality on every plane.  Inputs
are made with numpy from a seed; the reference's own 1-device plane
(`EvalCache(table, plane=1)`) is held to the port at the reference's
tolerance (keys and counts bit-equal, sums within rtol 1e-5).
"""
import numpy as np
import pytest
import torch

from repro.backends import ExecOptions as RefExecOptions
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.queries import device as ref_device
from repro.queries import engine as ref_engine
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro_torch import carry
from repro_torch.backends import ExecOptions, default_mesh_devices
from repro_torch.core import ingest
from repro_torch.core.sketches import build_sketches
from repro_torch.data.datasets import make_dataset
from repro_torch.data.table import append_partitions
from repro_torch.distributed import dataplane
from repro_torch.queries import device
from repro_torch.queries.engine import (
    AnswerStore,
    EvalCache,
    per_partition_answers_batch,
    stack_partitions,
)
from repro_torch.queries.generator import WorkloadSpec
from repro_torch.serving import BatchPicker
import torch_threads

torch_threads.cap_under_xdist()

CPU = ExecOptions(device="cpu", mesh=None)
MESHES = (1, 2, 8)
SKETCH_FIELDS = ("measures", "hist_edges", "cat_counts", "ndv", "dv_freq", "hh_stats",
                 "global_hh", "bitmap", "part_spans")


def on(mesh) -> ExecOptions:
    return CPU.replace(mesh=mesh)


@pytest.fixture(scope="module")
def table():
    # 12 partitions: divisible by 2, not by 8, so the 8-shard lanes also
    # run zero pad partitions
    return make_dataset("tpch", num_partitions=12, rows_per_partition=256)


@pytest.fixture(scope="module")
def workload(table):
    return WorkloadSpec(table, seed=3).sample_workload(16)


@pytest.fixture(scope="module")
def single_device_answers(table, workload):
    return device.eval_workload(table, workload, cache=EvalCache(table, options=CPU))


def assert_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.group_keys, w.group_keys)
        assert g.raw.shape == w.raw.shape
        np.testing.assert_array_equal(g.raw.view(np.uint64), w.raw.view(np.uint64))


# --------------------------------------------------------------------------
# bit parity
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES)
def test_eval_parity_bit_exact(table, workload, single_device_answers, mesh):
    """Per-shard answers equal the single-device answers bit for bit; the
    stack is padded to the bucket, then to a plane multiple."""
    cache = EvalCache(table, options=on(mesh))
    assert cache.plane.num_devices == mesh
    got = device.eval_workload(table, workload, cache=cache)
    assert_bits(got, single_device_answers)
    stack = cache.device_stack()
    assert isinstance(stack, dataplane.ShardedTensor) and len(stack.shards) == mesh
    assert stack.shape[1] == stack_partitions(12, cache.plane) == 16
    assert all(s.shape == (len(table.schema) + 1, 16 // mesh, 256) for s in stack.shards)
    # the pad partitions, ones-column included, are zero on every shard
    host = cache.plane.gather(stack.shards, 16, axis=1)
    assert not host[:, 12:].any()


@pytest.mark.parametrize("mesh", MESHES)
def test_ingest_parity_bit_exact(table, mesh):
    for start in (None, 5):  # the full pass and a streaming delta
        if start is None:
            want = ingest.build_statistics(table, discrete_counts=True, options=CPU)
            got = ingest.build_statistics(table, discrete_counts=True, options=on(mesh))
        else:
            want = ingest.delta_statistics(table, start, discrete_counts=True, options=CPU)
            got = ingest.delta_statistics(table, start, discrete_counts=True,
                                          options=on(mesh))
        assert want.keys() == got.keys()
        for col, tensors in want.items():
            assert tensors.keys() == got[col].keys(), col
            for key, val in tensors.items():
                a, b = np.asarray(val), np.asarray(got[col][key])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (col, key, start)


@pytest.mark.parametrize("mesh", MESHES)
def test_sketch_parity_bit_exact(table, mesh):
    """`build_sketches` on the device backend: every tensor the funnel and
    the picker read is unchanged by the plane."""
    want = build_sketches(table, options=CPU)
    got = build_sketches(table, options=on(mesh))
    for name, a in want.columns.items():
        b = got.columns[name]
        for field in SKETCH_FIELDS:
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), (name, field)
            if x is not None:
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), (name, field)
        assert a.hh_items == b.hh_items, name
        assert a.discrete_span == b.discrete_span, name


def test_padding_masked_not_double_counted():
    """P=5 on 2 shards pads to 6: the pad partition appears in no answer
    and shifts no group total (the host backend is the oracle)."""
    table = make_dataset("kdd", num_partitions=5, rows_per_partition=192)
    queries = WorkloadSpec(table, seed=9).sample_workload(8)
    host = per_partition_answers_batch(table, queries, options=CPU.replace(backend="host"))
    cache = EvalCache(table, options=on(2))
    sharded = device.eval_workload(table, queries, cache=cache)
    assert cache.device_stack().shape[1] == 8  # bucket 8, a multiple of 2
    cache3 = EvalCache(table, options=on(3))
    assert cache3.device_stack().shape[1] == 9  # bucket 8, then a multiple of 3
    assert_bits(device.eval_workload(table, queries, cache=cache3), sharded)
    for h, s in zip(host, sharded):
        assert s.raw.shape[0] == 5
        np.testing.assert_array_equal(h.group_keys, s.group_keys)
        np.testing.assert_array_equal(h.raw[..., 0], s.raw[..., 0])  # counts exact
        np.testing.assert_allclose(s.raw, h.raw, rtol=1e-5, atol=1e-5)


def test_matches_the_reference_one_device_plane():
    """The reference's own plane (``EvalCache(table, plane=1)``, its
    jitted shard_map path) against the port's 2-shard plane: group keys
    and counts bit-equal, sums within rtol 1e-5."""
    ref_table = ref_make_dataset("tpch", num_partitions=12, rows_per_partition=256, seed=0)
    ref_queries = RefWorkloadSpec(ref_table, seed=3).sample_workload(8)
    ref_cache = ref_engine.EvalCache(
        ref_table, options=RefExecOptions(backend="device", mesh=1))
    assert ref_cache.plane.num_devices == 1
    want = ref_device.eval_workload(ref_table, ref_queries, cache=ref_cache, use_ref=True)
    t = carry.table(ref_table)
    got = device.eval_workload(t, carry.queries(ref_queries),
                               cache=EvalCache(t, options=on(2)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.group_keys, g.group_keys)
        np.testing.assert_array_equal(w.raw[..., 0], g.raw[..., 0])
        np.testing.assert_allclose(g.raw, w.raw, rtol=1e-5, atol=1e-4)


# --------------------------------------------------------------------------
# launch keys
# --------------------------------------------------------------------------
def test_census_bounded_and_mesh_independent(table, workload):
    """Every launch key is a census key at local shapes, the census's
    cardinality does not depend on the plane, and a warm rerun launches
    no new key."""
    sizes = {}
    for mesh in MESHES:
        cache = EvalCache(table, options=on(mesh))
        census = device.workload_census(table, workload, cache)
        device.TRACES.reset()
        device.eval_workload(table, workload, cache=cache)
        cold = set(device.TRACES.counts())
        assert cold == census
        local = stack_partitions(12, cache.plane) // mesh
        assert all(key[1] % local == 0 for key in cold)
        device.eval_workload(table, workload, cache=cache)  # warm
        assert set(device.TRACES.counts()) == cold
        # one launch a shard for every chunk
        assert device.TRACES.total() == 2 * mesh * len(device.plan_launches(
            table, workload, cache)[0])
        sizes[mesh] = len(census)
    assert len(set(sizes.values())) == 1, sizes


def test_ingest_keys_warm_rerun_launches_no_new_key(table):
    ingest.TRACES.reset()
    ingest.build_statistics(table, discrete_counts=True, options=on(2))
    keys = set(ingest.TRACES.counts())
    ingest.TRACES.reset()
    ingest.build_statistics(table, discrete_counts=True, options=on(2))
    assert set(ingest.TRACES.counts()) == keys
    assert all(k[1] == 6 for k in keys)  # the local P of 12 over 2 shards


# --------------------------------------------------------------------------
# plane resolution and geometry
# --------------------------------------------------------------------------
def test_resolve_plane_env_policy(monkeypatch):
    monkeypatch.delenv("REPRO_MESH", raising=False)
    assert dataplane.resolve_plane("auto", "cpu") is None
    assert ExecOptions(device="cpu").plane() is None  # "auto" by default
    for off in ("0", "off", "none", ""):
        monkeypatch.setenv("REPRO_MESH", off)
        assert default_mesh_devices("cpu") == 0 and CPU.replace(mesh="auto").plane() is None
    monkeypatch.setenv("REPRO_MESH", "1")
    plane = dataplane.resolve_plane("auto", "cpu")
    assert plane is not None and plane.num_devices == 1
    monkeypatch.setenv("REPRO_MESH", "auto")
    assert dataplane.resolve_plane("auto", "cpu").num_devices == 1
    monkeypatch.setenv("REPRO_MESH", "all")
    assert default_mesh_devices("cpu") == 1
    monkeypatch.setenv("REPRO_MESH", "4")
    assert ExecOptions(device="cpu").plane().num_devices == 4  # logical CPU shards
    assert ExecOptions(device="cpu", backend="host").plane() is None  # host: no plane
    # on CUDA a count above the visible devices raises: no fallback
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="REPRO_MESH=4"):
            default_mesh_devices("cuda")
    assert dataplane.resolve_plane(None, "cpu") is None
    assert dataplane.resolve_plane(plane, "cpu") is plane
    for off in (0, "off", None):
        assert CPU.replace(mesh=off).plane() is None


def test_cuda_plane_needs_the_devices():
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA device"):
        dataplane.plane_of(n + 1, "cuda")
    with pytest.raises(ValueError, match="available"):
        dataplane.PartitionPlane((f"cuda:{n}",))
    with pytest.raises(ValueError, match="mixed"):
        dataplane.PartitionPlane(("cpu", "meta"))
    with pytest.raises(ValueError, match="no partition plane on 'meta'"):
        ExecOptions(device="meta", mesh=2).plane()
    with pytest.raises(ValueError, match="plane on meta devices"):
        CPU.replace(mesh=("meta", "meta")).plane()
    with pytest.raises(ValueError, match="bad partition-plane spec"):
        dataplane.resolve_plane(2.5, "cpu")


def test_plane_holds_the_options_device(monkeypatch):
    # two CUDA devices as the plane sees them; nothing here launches
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.delenv("REPRO_MESH", raising=False)
    second = ExecOptions(device="cuda:1")
    # an int plane is counted from the options' device, not from cuda:0
    assert second.replace(mesh=1).plane().devices == (torch.device("cuda", 1),)
    assert ExecOptions(mesh=2).plane().devices == (torch.device("cuda", 0),
                                                   torch.device("cuda", 1))
    with pytest.raises(ValueError, match="from cuda:1 but 2 are available"):
        second.replace(mesh=2).plane()
    monkeypatch.setenv("REPRO_MESH", "1")
    assert second.plane().devices == (torch.device("cuda", 1),)
    monkeypatch.setenv("REPRO_MESH", "all")  # every device: cuda:1 is one of them
    assert second.plane().num_devices == 2
    # a plane that does not hold the options' device raises
    with pytest.raises(ValueError, match="not a device of its plane"):
        second.replace(mesh=("cuda:0",) * 3).plane()
    assert ExecOptions(mesh=("cuda:0",) * 3).plane().num_devices == 3  # "cuda" is cuda:0
    for off in (0, None, "off", "none", "0", ""):
        assert second.replace(mesh=off).plane() is None


def test_plane_geometry_and_options():
    plane = dataplane.resolve_plane(1, "cpu")
    assert plane.padded(5) == 5 and plane.local(5) == 5
    plane = dataplane.resolve_plane(2, "cpu")
    assert plane.padded(5) == 6 and plane.local(5) == 3
    assert plane.padded(4) == 4 and plane.local(4) == 2
    assert dataplane.resolve_plane(("cpu",) * 3, "cpu").padded(1024) == 1026
    assert stack_partitions(1024, dataplane.resolve_plane(3, "cpu")) == 1026
    assert stack_partitions(1025, dataplane.resolve_plane(3, "cpu")) == 2049
    # the options stay frozen and hashable whatever the mesh spec
    specs = ("auto", None, 2, ("cpu", "cpu"), ["cpu"], plane)
    opts = [CPU.replace(mesh=m) for m in specs]
    assert len({hash(o) for o in opts}) == len(opts)
    assert opts[4].mesh == ("cpu",)
    with pytest.raises(Exception):
        opts[0].mesh = 3


def test_shard_and_gather_round_trip():
    plane = dataplane.resolve_plane(3, "cpu")
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 7, 5)).astype(np.float32)
    st = plane.shard_partitions(a, axis=1, target=8)
    assert st.shape == (4, 9, 5) and st.local == 3
    back = plane.gather(st.shards, 9, axis=1)
    np.testing.assert_array_equal(back[:, :7], a)
    assert not back[:, 7:].any()
    b = rng.integers(0, 9, size=(5, 2)).astype(np.int32)
    st = plane.shard_partitions(b)
    assert st.shards[0].dtype == torch.int32 and st.shape == (6, 2)
    np.testing.assert_array_equal(plane.gather(st.shards, 5), b)


# --------------------------------------------------------------------------
# write_partitions
# --------------------------------------------------------------------------
def test_write_partitions_crosses_a_shard_boundary():
    """A write whose global range spans shards is split: each shard gets
    the part it holds, the pad beyond the delta is zero, nothing else
    moves.  The launch key takes the delta's power-of-two bucket where it
    fits the slack, the exact count where it does not."""
    plane = dataplane.resolve_plane(3, "cpu")
    base = np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3) + 1
    buf = plane.shard_partitions(base, axis=1, target=12)  # 12 slots, 4 a shard
    delta = -np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3) - 1
    dataplane.TRACES.reset()
    assert dataplane.write_partitions(buf, delta, 4, axis=1, plane=plane) is buf
    got = plane.gather(buf.shards, 12, axis=1)
    np.testing.assert_array_equal(got[:, :4], base)
    np.testing.assert_array_equal(got[:, 4:9], delta)  # slots 4..8: shards 1 and 2
    assert not got[:, 9:].any()
    # 5 → bucket 8 would end at 12: it fits the slack, so the key is 8
    assert dataplane.TRACES.counts() == {("write_partitions", 1, 2, 12, 3, 8): 1}
    # 3 at 9: the bucket 4 would end past 12, so the exact count is taken
    dataplane.write_partitions(buf, delta[:, :3], 9, axis=1, plane=plane)
    assert ("write_partitions", 1, 2, 12, 3, 3) in dataplane.TRACES.counts()
    np.testing.assert_array_equal(plane.gather(buf.shards, 12, axis=1)[:, 9:], delta[:, :3])


def test_write_partitions_overflow_raises():
    plane = dataplane.resolve_plane(2, "cpu")
    buf = plane.shard_partitions(np.zeros((6, 2), np.float32), target=8)
    with pytest.raises(ValueError, match="reserved slack"):
        dataplane.write_partitions(buf, np.ones((3, 2), np.float32), 6, plane=plane)
    single = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="reserved slack"):
        dataplane.write_partitions(single, np.ones((9, 2), np.float32), 0)
    dataplane.write_partitions(single, np.ones((2, 2), np.float32), 6)
    assert single[6:].eq(1).all() and not single[:6].any()


# --------------------------------------------------------------------------
# the stores on a plane
# --------------------------------------------------------------------------
def test_answer_store_folds_appends_on_a_plane():
    """An in-slack append writes across the shards, an overflow re-pads
    and re-shards, and the folded answers equal a cold single-device
    evaluation bit for bit; the delta view keeps the store's plane."""
    table = make_dataset("kdd", num_partitions=5, rows_per_partition=64)
    queries = WorkloadSpec(table, seed=4).sample_workload(6)
    store = AnswerStore(table, options=on(3))
    assert store.plane.num_devices == 3
    store.get_batch(queries)
    cache = store._eval_cache
    assert cache.device_stack().shape[1] == 9
    for parts, seed in ((3, 21), (4, 22)):  # 5 → 8 in the slack, then 12 → re-pad at 18
        delta = make_dataset("kdd", num_partitions=parts, rows_per_partition=64,
                             layout="random", seed=seed)
        append_partitions(table, delta.columns)
        got = store.get_batch(queries)
        assert_bits(got, per_partition_answers_batch(table, queries, options=CPU,
                                                     cache=EvalCache(table, options=CPU)))
        view_cache = next(iter(store._delta_caches.values()))[1]
        assert view_cache.plane is store.plane
    # the overflow dropped the stack; the next read re-pads and re-shards it
    assert (cache.stack_appends, cache.stack_rebuilds) == (1, 1)
    assert cache.device_stack().shape[1] == 18 and cache.stack_rebuilds == 2


def test_serve_stats_reports_the_plane():
    from repro_torch.core.picker import PickerConfig, train_picker

    table = make_dataset("kdd", num_partitions=8, rows_per_partition=64)
    art = train_picker(table, WorkloadSpec(table, seed=1), num_train_queries=4,
                       config=PickerConfig(num_trees=2, tree_depth=2, feature_selection=False),
                       options=CPU.replace(backend="host"))
    assert BatchPicker(art.picker, options=on(2)).serve_stats()["mesh_devices"] == 2
    assert BatchPicker(art.picker, options=CPU).serve_stats()["mesh_devices"] == 1
