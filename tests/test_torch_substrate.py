"""The port's training substrate vs the JAX reference, on the CPU.

  * `repro_torch.data.tokens`: the token store (tokens and every metadata
    column), `mixture_query` and, on the host backend at the reference
    test's size, `PS3DataPlane`'s shard ids and f64 weights, its batch
    stream and `substitute`'s replacement — all bit-equal (a KMeans exact
    tie would be a logged divergence, `ROADMAP.md` § 3; this input has
    none);
  * the reference's `tests/test_substrate.py` contract on the port: AdamW
    descends for each state dtype, the int8 round trip and state shapes,
    the checkpointer's round trip, keep-last, crash safety, async save
    and restore onto a device, and the data plane's mixture estimate,
    batch shapes and straggler substitution;
  * a checkpoint the reference wrote loads in the port byte for byte, and
    the port writes the reference's manifest;
  * the port's device backend (plain versions, CPU) picks the host
    backend's shards and weights;
  * `core.sketches.sketch_storage_bytes` equals the reference's.
"""
import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sketches import build_sketches as ref_build_sketches
from repro.core.sketches import sketch_storage_bytes as ref_storage
from repro.data import tokens as ref_tokens
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.train.checkpoint import Checkpointer as RefCheckpointer
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.core.sketches import build_sketches, sketch_storage_bytes
from repro_torch.data import tokens
from repro_torch.train import optimizer as opt
from repro_torch.train.tree import leaves
from repro_torch.train.checkpoint import Checkpointer
import torch_threads

torch_threads.cap_under_xdist()

PLANE = dict(n_shards=32, seqs_per_shard=32, seq_len=33, vocab=128, seed=1)  # the reference test's
PLANE_OPTS = dict(budget_frac=0.3, num_train_queries=12, seed=1, backend="host")


def _toy_params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "slots": ({"w": torch.randn((6, 16, 32), generator=g).to(torch.bfloat16)},),
        "head": torch.randn((16, 8), generator=g).to(torch.bfloat16),
    }


def _ref_toy_params(seed=0):  # `tests/test_substrate.py::_toy_params`
    k = jax.random.PRNGKey(seed)
    return {
        "slots": ({"w": jax.random.normal(k, (6, 16, 32), jnp.bfloat16)},),
        "head": jax.random.normal(k, (16, 8), jnp.bfloat16),
    }


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


# --------------------------------------------------------------------------
# the token store and the data plane, bit for bit
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_token_store_matches_reference(seed):
    kw = dict(n_shards=8, seqs_per_shard=16, seq_len=17, vocab=300, seed=seed)
    ref, port = ref_tokens.make_token_store(**kw), tokens.make_token_store(**kw)
    np.testing.assert_array_equal(port.tokens, ref.tokens)
    assert port.tokens.dtype == ref.tokens.dtype and port.n_domains == ref.n_domains
    assert port.meta.name == ref.meta.name
    assert [carry.column_spec(s) for s in ref.meta.schema] == list(port.meta.schema)
    for name, col in ref.meta.columns.items():
        assert port.meta.columns[name].dtype == col.dtype
        np.testing.assert_array_equal(port.meta.columns[name], col)


def test_mixture_query_matches_reference():
    for qmin in (0.3, 0.55):
        assert tokens.mixture_query(qmin) == carry.query(ref_tokens.mixture_query(qmin))


@pytest.fixture(scope="module")
def ref_plane():
    return ref_tokens.PS3DataPlane(ref_tokens.make_token_store(**PLANE), **PLANE_OPTS)


@pytest.fixture(scope="module")
def plane():
    return tokens.PS3DataPlane(tokens.make_token_store(**PLANE), device="cpu", **PLANE_OPTS)


def _fresh(p):
    """A copy whose selection a `substitute` may change."""
    q = copy.copy(p)
    q.shard_ids, q.dead = p.shard_ids.copy(), set()
    return q


def test_data_plane_matches_reference(plane, ref_plane):
    assert plane.budget == ref_plane.budget
    np.testing.assert_array_equal(plane.shard_ids, ref_plane.shard_ids)
    assert plane.weights.dtype == np.float64
    np.testing.assert_array_equal(plane.weights, ref_plane.weights)
    for start in (0, 2):
        got = list(plane.batches(8, 3, seed=5, start=start))
        want = list(ref_plane.batches(8, 3, seed=5, start=start))
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    est, truth = plane.mixture_estimate()
    ref_est, ref_truth = ref_plane.mixture_estimate()
    np.testing.assert_array_equal(est, ref_est)
    np.testing.assert_array_equal(truth, ref_truth)
    p, r = _fresh(plane), _fresh(ref_plane)
    for victim in (int(plane.shard_ids[0]), int(plane.shard_ids[3])):
        assert p.substitute(victim) == r.substitute(victim)
        np.testing.assert_array_equal(p.shard_ids, r.shard_ids)


def test_data_plane_device_backend_matches_host(plane):
    """The device backend (the kernels' plain versions on the CPU) picks
    the host backend's shards and weights: the device-backend contract
    of the PS³ path (on the card: `chip_smoke.py` phase 12 check (c))."""
    opts = {**PLANE_OPTS, "backend": "device"}
    dev = tokens.PS3DataPlane(tokens.make_token_store(**PLANE), device="cpu", **opts)
    np.testing.assert_array_equal(dev.shard_ids, plane.shard_ids)
    np.testing.assert_array_equal(dev.weights, plane.weights)
    est, truth = dev.mixture_estimate()
    want_est, want_truth = plane.mixture_estimate()
    np.testing.assert_array_equal(truth, want_truth)
    # f32 sums in another order: the reference's cross-lowering tolerance
    np.testing.assert_allclose(est, want_est, rtol=1e-5)


def test_data_plane_options():
    store = tokens.make_token_store(n_shards=4, seqs_per_shard=4, seq_len=5, vocab=16)
    with pytest.raises(ValueError, match="unknown backend"):
        tokens.PS3DataPlane(store, backend="tpu", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tokens.PS3DataPlane(store)  # the default device is cuda


# the reference's data-plane contract (`tests/test_substrate.py`), on the port
def test_data_plane_mixture_beats_naive_subset(plane):
    est, truth = plane.mixture_estimate()
    covered = np.isfinite(est[:, 0])
    assert covered.mean() > 0.55
    rel = np.abs(est[covered] - truth[covered]) / np.maximum(truth[covered], 1)
    assert rel.mean() < 0.5


def test_data_plane_batches_shapes(plane):
    for batch in plane.batches(8, 3, seed=0):
        assert batch["tokens"].shape == (8, 32)
        assert batch["targets"].shape == (8, 32)
        assert batch["loss_weights"].shape == (8,)
        assert np.all(batch["loss_weights"] > 0)
        break


def test_straggler_substitution(plane):
    p = _fresh(plane)
    victim = int(p.shard_ids[0])
    repl = p.substitute(victim)
    assert repl != victim
    assert victim not in p.shard_ids or victim in p.dead
    assert p.weights.sum() > 0


# --------------------------------------------------------------------------
# the optimizer (`tests/test_substrate.py`'s contract)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_adamw_descends(dtype):
    cfg = opt.AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=50,
                          weight_decay=0.0, state_dtype=dtype)
    params = {"w": torch.tensor([2.0, -3.0, 1.0])}
    state = opt.init_state(cfg, params)
    for _ in range(60):
        g = {"w": 2 * params["w"]}  # grad of sum(w²)
        params, state, _ = opt.apply_updates(cfg, params, g, state)
    assert float(torch.sum(params["w"] ** 2)) < 0.05, dtype


def test_int8_state_roundtrip_accuracy():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(64, 256)), dtype=torch.float32)
    q, s = opt._q8_encode(x)
    back = opt._q8_decode(q, s, x.shape)
    rel = float((back - x).abs().max() / x.abs().max())
    assert rel < 0.02


def test_int8_states_same_shape_as_param():
    cfg = opt.AdamWConfig(state_dtype="int8")
    state = opt.init_state(cfg, _toy_params())
    q, s = state["m"]["slots"][0]["w"]
    assert q.shape == (6, 16, 32) and s.shape == (6, 16, 1)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert state["step"].dtype == torch.int32


# --------------------------------------------------------------------------
# the checkpointer (`tests/test_substrate.py`'s contract)
# --------------------------------------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    state = opt.init_state(opt.AdamWConfig(state_dtype="int8"), _toy_params())
    tree = {"params": _toy_params(), "opt": state}
    ck.save(5, tree)
    got = ck.restore(5, tree)
    assert got.keys() == tree.keys() and isinstance(got["opt"]["m"]["slots"], tuple)
    flat_got, flat_want = leaves(got), leaves(tree)
    assert len(flat_got) == len(flat_want) == 2 + 2 * 4 + 1
    for a, b in zip(flat_got, flat_want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert ck.manifest(5)["paths"] == sorted(
        ["params/head", "params/slots/0/w", "opt/step"]
        + [f"opt/{mv}/{p}/{i}" for mv in "mv" for p in ("head", "slots/0/w") for i in (0, 1)])


def test_checkpoint_keep_last_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_crash_safety(tmp_path):
    """A torn tmp dir (simulated crash mid-save) is never listed."""
    ck = Checkpointer(str(tmp_path), keep_last=3)
    ck.save(1, {"x": torch.ones(4)})
    torn = tmp_path / "step_99"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"garbage")  # no manifest => ignored
    assert ck.all_steps() == [1]


def test_checkpoint_async(tmp_path):
    """The async save copies the tree before it returns: an in-place
    update right after it does not reach the checkpoint."""
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(10)
    ck.save(7, {"x": x}, blocking=False)
    x.add_(100)
    ck.wait()
    assert ck.latest_step() == 7
    np.testing.assert_array_equal(ck.restore(7, {"x": x})["x"].numpy(), np.arange(10))


def test_restore_onto_device(tmp_path):
    """Save, then restore onto a named device (the elastic restore onto
    a mesh, ``shardings=``, is in `tests/test_torch_distributed.py`)."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ck.save(1, tree)
    got = ck.restore(1, tree, device="cpu")
    assert got["w"].device == torch.device("cpu")
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].numpy())
    with pytest.raises(ValueError, match="shape"):
        ck.restore(1, {"w": torch.zeros(2, 8)})


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_reference_checkpoint_loads_byte_for_byte(tmp_path, dtype):
    """The reference's checkpoint of `_toy_params` and its AdamW state
    restores in the port with the same bits; the port's save of the same
    tree writes the reference's manifest."""
    from repro.train import optimizer as ref_opt

    ref_params = _ref_toy_params()
    ref_state = ref_opt.init_state(ref_opt.AdamWConfig(state_dtype=dtype), ref_params)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.5, ref_params)
    _, ref_state, _ = ref_opt.apply_updates(ref_opt.AdamWConfig(state_dtype=dtype),
                                            ref_params, grads, ref_state)
    ref_tree = {"params": ref_params, "opt": ref_state}
    RefCheckpointer(str(tmp_path / "ref")).save(3, ref_tree, extra={"note": "x"})

    like = {"params": _toy_params(1),
            "opt": opt.init_state(opt.AdamWConfig(state_dtype=dtype), _toy_params(1))}
    got = Checkpointer(str(tmp_path / "ref")).restore(3, like)
    for a, b in zip(leaves(got), jax.tree.leaves(ref_tree)):
        b = np.asarray(b)
        want = b.view(np.int16) if b.dtype.name == "bfloat16" else b
        assert a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), want)

    Checkpointer(str(tmp_path / "port")).save(3, got, extra={"note": "x"})
    manifests = [json.loads((tmp_path / d / "step_3" / "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    with np.load(tmp_path / "ref" / "step_3" / "arrays.npz") as r, \
            np.load(tmp_path / "port" / "step_3" / "arrays.npz") as p:
        assert list(r.keys()) == list(p.keys())
        for k in r.keys():
            assert r[k].dtype == p[k].dtype
            np.testing.assert_array_equal(r[k], p[k])


# --------------------------------------------------------------------------
# sketch storage (`tests/test_core_components.py::test_storage_under_paper_budget`)
# --------------------------------------------------------------------------
def test_sketch_storage_bytes_matches_reference():
    ref_table = ref_make_dataset("tpch", num_partitions=16, rows_per_partition=256, seed=0)
    table = carry.table(ref_table)
    want = ref_storage(ref_table, ref_build_sketches(ref_table))
    got = sketch_storage_bytes(table, build_sketches(table, options=ExecOptions(device="cpu")))
    assert got == want
    assert got["total_kb"] < 110.0  # paper Table 4: ≤ ~103KB/partition
