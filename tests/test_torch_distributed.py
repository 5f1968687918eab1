"""The port's multi-device layer vs the JAX reference, on the CPU.

Held across the two packages, on the same shapes and numpy inputs:

  * `sharding.param_shardings` (through `spec_for_path`) on every
    parameter leaf of every smoke and full config, on plain ``{axis:
    size}`` meshes at production sizes (``{"data": 16, "model": 16}``
    and ``{"pod": 2, "data": 16, "model": 16}``), on sizes that force the
    divisibility fallback, and on a mesh without a data axis: the
    reference's spec with its stacked layer axis dropped for the
    ``slots``, ``encoder/layers`` and ``cross`` leaves, which the port
    holds one a layer (mixtral's 8 experts on a 16-way model axis take the
    expert-to-tensor fallback);
  * `param_shardings` of an int8 AdamW state (``(q, scale)`` pairs
    inherit their parameter's rule), `data_shardings` and
    `cache_shardings` (the per-layer caches against the reference's
    stacked ones), and their placements on a one-rank ``("data",
    "model")`` `DeviceMesh`;
  * `axes._resolve` for each tag, and `axes.constrain` redistributing a
    `DTensor` (a plain tensor, and any tensor with no axes active, is
    returned as it is);
  * `compress.ef_quantized_mean_plain` against the reference's
    ``ef_quantized_psum_mean`` under ``jax.vmap(axis_name="pod")``: 2 and
    3 pods with distinct values, a 130-element leaf and a nonzero incoming
    error.  Against the reference run op by op the mean and the new
    error are bit for bit.  Jitted, XLA:CPU multiplies by rounded
    reciprocals where the reference divides by 127 and by the pod count,
    and contracts ``g - q·s`` into one fused multiply-add: the mean and
    the error then differ by a few ulps of their group's largest ``|g|``
    (``JIT_ULPS``), held so;
  * the gloo form (`ef_quantized_psum_mean`, `compressed_pod_mean`) on 2
    spawned ranks, bit for bit against the plain forms, and on the
    one-rank group of the fixture;
  * elastic restore onto a one-rank mesh (the reference's
    `test_elastic_restore_resharding`), a qwen-smoke int8 train state
    through `param_shardings` too.
"""
import os
import subprocess
import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro import configs as ref_configs
from repro.distributed import axes as ref_axes
from repro.distributed import compress as ref_compress
from repro.distributed import sharding as ref_sharding
from repro.models import lm as ref_lm
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.distributed import axes, compress, sharding
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import tree
from repro_torch.train.checkpoint import Checkpointer

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
MESHES = {
    "prod": {"data": 16, "model": 16},
    "multipod": {"pod": 2, "data": 16, "model": 16},
    "indivisible": {"data": 3, "model": 7},
    "model-only": {"model": 16},
}
# the reference's trees stacked along a leading layer axis → the port's lists
STACKS = {"slots": "blocks", "encoder/layers": "encoder/layers", "cross": "cross"}


class _Spec:
    """The reference's `NamedSharding(mesh, spec)`, kept as its spec (a
    tree leaf): the reference's rules run on a mesh of sizes alone."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


class _Mesh:
    """The reference's view of a mesh: axis names and sizes."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


@pytest.fixture(scope="module")
def group():
    """A one-rank gloo group (an in-memory store) and its ("data",
    "model") CPU `DeviceMesh`, destroyed after the module."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    mesh = DeviceMesh("cpu", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model"))
    yield mesh
    dist.destroy_process_group()


@pytest.fixture
def ref_specs(monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Spec)


@pytest.fixture
def logical_axes():
    yield
    axes.set_logical_axes(())
    ref_axes.set_logical_axes(())


def _flat_specs(spec_tree) -> dict:
    return {path: leaf.spec for path, leaf in tree.flatten(spec_tree).items()}


def _unstacked(ref_flat: dict, ref_shapes: dict, period: int) -> dict:
    """The reference's {path: spec} in the port's paths: each stacked leaf
    (``slots/j``: unit u → block u·period + j; ``encoder/layers`` and
    ``cross``: layer i) once a layer, its leading None dropped."""
    out = {}
    for path, spec in ref_flat.items():
        for ref_prefix, port_prefix in STACKS.items():
            head, sep, rest = path.partition(ref_prefix + "/")
            if sep and (not head or head.endswith("/")):
                assert spec[0] is None, (path, spec)
                j = 0
                if ref_prefix == "slots":
                    j, rest = rest.split("/", 1)
                for u in range(ref_shapes[path][0]):
                    i = u * period + int(j) if ref_prefix == "slots" else u
                    out[f"{head}{port_prefix}/{i}/{rest}"] = spec[1:]
                break
        else:
            out[path] = spec
    return out


@lru_cache(maxsize=None)
def _ref_shapes(arch: str, size: str):
    cfg = (ref_configs.get_smoke if size == "smoke" else ref_configs.get_config)(arch)
    return ref_lm.param_shapes(cfg)


def _port_tree(arch: str, size: str):
    cfg = (configs.get_smoke if size == "smoke" else configs.get_config)(arch)
    return lm.param_tree(lm.LM(cfg, device="meta"))


def _shape_paths(ref_tree) -> dict:
    return {p: tuple(a.shape) for p, a in tree.flatten(ref_tree).items()}


# --------------------------------------------------------------------------
# the parameter rules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_match_reference(arch, size, ref_specs):
    shapes = _ref_shapes(arch, size)
    port_tree = _port_tree(arch, size)
    leaves = tree.flatten(port_tree)
    period = len(shapes["slots"])
    for name, sizes in MESHES.items():
        want = _unstacked(_flat_specs(ref_sharding.param_shardings(shapes, _Mesh(sizes))),
                          _shape_paths(shapes), period)
        got = _flat_specs(sharding.param_shardings(port_tree, sizes))
        assert got.keys() == want.keys(), (name, sorted(got.keys() ^ want.keys())[:4])
        for path, spec in want.items():
            assert got[path] == spec, (name, path, got[path], spec)
            assert spec == sharding.spec_for_path(path, tuple(leaves[path].shape), sizes), path


def test_expert_fallback_to_tensor_parallel():
    """mixtral's 8 experts do not divide a 16-way model axis: the expert
    FFN width is sharded instead; on 8 ways the experts are."""
    cfg = configs.get_config("mixtral_8x22b")
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff_expert or cfg.d_ff
    for m, wi, wo in ((16, (None, "data", "model"), (None, "model", "data")),
                      (8, ("model", "data", None), ("model", None, "data"))):
        mesh = {"data": 16, "model": m}
        assert sharding.spec_for_path("blocks/0/ffn/wi", (e, d, ff), mesh) == wi
        assert sharding.spec_for_path("blocks/0/ffn/wo", (e, ff, d), mesh) == wo
        # the reference's, stacked
        got = ref_sharding.spec_for_path("slots/0/ffn/wi", (56, e, d, ff), _Mesh(mesh),
                                         stacked=True)
        assert tuple(got) == (None,) + wi


def test_opt_state_specs_match_reference(ref_specs):
    """An int8 AdamW state: each ``(q, scale)`` pair takes its parameter's
    rule, the scale's trailing 1 replicated; the step replicated."""
    arch = "deepseek_v2_236b"
    shapes = jax.eval_shape(lambda p: ref_opt.init_state(ref_opt.AdamWConfig(
        state_dtype="int8"), p), _ref_shapes(arch, "smoke"))
    port_state = opt.init_state(opt.AdamWConfig(state_dtype="int8"), _port_tree(arch, "smoke"))
    sizes = {"data": 2, "model": 4}
    want = _unstacked(_flat_specs(ref_sharding.param_shardings(shapes, _Mesh(sizes))),
                      _shape_paths(shapes), len(shapes["m"]["slots"]))
    got = _flat_specs(sharding.param_shardings(port_state, sizes))
    assert got.keys() == want.keys()
    assert got == want
    assert got["step"] == ()
    wi = tree.flatten(port_state)["m/blocks/0/ffn/wi/0"]
    assert wi.dtype == torch.int8 and wi.ndim == 3
    assert got["m/blocks/0/ffn/wi/0"] == sharding.spec_for_path("blocks/0/ffn/wi",
                                                                tuple(wi.shape), sizes)
    assert got["m/blocks/0/ffn/wi/1"][-1] is None


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "mixtral_8x22b", "recurrentgemma_9b",
                                  "whisper_small"])
def test_cache_and_data_specs_match_reference(arch, ref_specs, group):
    """The per-layer caches against the reference's stacked ones (its
    ``slots`` and whisper's ``cross_k``/``cross_v``), on a mesh of sizes
    and on the one-rank `DeviceMesh`; a batch's leading axis on the DP
    axes where it divides."""
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    b, max_len = 4, 24
    ref_cache = jax.eval_shape(lambda: ref_lm.init_cache(ref_cfg, b, max_len))
    cache = lm.init_cache(cfg, b, max_len, "meta")
    period = len(cfg.block_pattern)
    n_lead = cfg.first_dense_layers
    for sizes in ({"pod": 2, "data": 2, "model": 4}, {"data": 1, "model": 1}):
        want = ref_sharding.cache_shardings(ref_cache, ref_cfg, _Mesh(sizes))
        got = sharding.cache_shardings(cache, cfg, sizes)
        for j, slot in enumerate(want["slots"]):
            for name, sp in slot.items():
                units = ref_cache["slots"][j][name].shape[0]
                for u in range(units):
                    assert got[n_lead + u * period + j][name].spec == sp.spec[1:], (name, u)
        for name in ("cross_k", "cross_v"):
            if name in want:
                for i in range(cfg.n_layers):
                    assert got[i][name].spec == want[name].spec[1:]
    got = sharding.cache_shardings(cache, cfg, group)
    assert got[0][next(iter(cache[0]))].placements[0] == Shard(0)  # batch on "data"
    batch = {"tokens": torch.zeros(4, 16, dtype=torch.long), "loss_weights": torch.ones(4),
             "odd": torch.zeros(3, 2)}
    for sizes in ({"pod": 2, "data": 2, "model": 4}, {"data": 3, "model": 2}):
        want = jax.tree.map(lambda s: s.spec, ref_sharding.data_shardings(
            {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32) for k, v in batch.items()},
            _Mesh(sizes)), is_leaf=lambda x: isinstance(x, _Spec))
        got = sharding.data_shardings(batch, sizes)
        assert {k: v.spec for k, v in got.items()} == want
    on_mesh = sharding.data_shardings(batch, group)
    assert on_mesh["tokens"].placements == (Shard(0), Replicate())
    placed = distribute_tensor(batch["tokens"], group, on_mesh["tokens"].placements)
    assert torch.equal(placed.full_tensor(), batch["tokens"])


# --------------------------------------------------------------------------
# logical axes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("names", [("pod", "data", "model"), ("data", "model"), ("data",),
                                   ("model",), ("part",), ()])
def test_resolve_matches_reference(names, logical_axes):
    axes.set_logical_axes(names)
    ref_axes.set_logical_axes(names)
    assert axes.active() == ref_axes.active() == names
    for tag in ("batch", "seq", "partition", "model", "data", "pod", None, "other"):
        assert axes._resolve(tag) == ref_axes._resolve(tag), tag


def test_constrain_redistributes_dtensor(group, logical_axes):
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    d = distribute_tensor(x, group, [Replicate(), Replicate()])
    assert axes.constrain(d, "batch", "seq", None) is d  # no axes active
    axes.set_logical_axes(group.mesh_dim_names)
    plain = torch.ones(3)
    assert axes.constrain(plain, "batch") is plain
    out = axes.constrain(d, "batch", "seq", None)
    assert isinstance(out, DTensor)
    assert out.placements == (Shard(0), Shard(1))
    assert torch.equal(out.full_tensor(), x)
    out = axes.constrain(out, "model", "batch")  # (4 on "model", 6 on "data")
    assert out.placements == (Shard(1), Shard(0))
    assert torch.equal(out.full_tensor(), x)
    # the logits' tags: vocab on "model", the rest replicated
    assert axes.constrain(d, "batch", None, "model").placements == (Shard(0), Shard(2))


def test_placements_of_multi_axis_batch():
    """A batch dimension over ("pod", "data") shards over both mesh dims."""
    sizes = {"pod": 2, "data": 4, "model": 2}
    spec = sharding.data_shardings({"t": torch.zeros(8, 3)}, sizes)["t"].spec
    assert spec == (("pod", "data"), None)
    assert axes.placements(spec, sizes) == (Shard(0), Shard(0), Replicate())


# --------------------------------------------------------------------------
# the int8 error-feedback pod mean
# --------------------------------------------------------------------------
def _pods(pods: int, shape, seed: int):
    """Distinct values a pod (scales spread over 2 decades) and a small
    nonzero incoming error."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(pods,) + shape) * rng.uniform(0.1, 10, size=(pods,) + shape))
    err = rng.normal(size=(pods,) + shape) * 1e-3
    return x.astype(np.float32), err.astype(np.float32)


# XLA:CPU jits ``max / 127`` and ``total·s / n`` as multiplies by rounded
# reciprocals and ``g - q·s`` as one fused multiply-add; the port (and the
# reference run op by op) rounds each op.  Measured: up to 1.0 ulp of the
# group's max |g| on the mean and 2.03 on the error (3 pods, 50 × 128)
JIT_ULPS = 4


def _reference_ef(x, err, jit: bool):
    f = jax.vmap(lambda a, b: ref_compress.ef_quantized_psum_mean(a, "pod", b), axis_name="pod")
    m, e = (jax.jit(f) if jit else f)(jnp.asarray(x), jnp.asarray(err))
    return np.asarray(m), np.asarray(e)


@pytest.mark.parametrize("pods,shape", [(2, (130,)), (3, (130,)), (3, (5, 300)), (2, (7, 128))])
def test_ef_mean_matches_reference(pods, shape):
    x, err = _pods(pods, shape, seed=pods * 10 + len(shape))
    mean, new_err = compress.ef_quantized_mean_plain(torch.as_tensor(x), torch.as_tensor(err))
    assert mean.shape == shape and new_err.shape == (pods,) + shape
    # op by op: bit for bit
    want_m, want_e = _reference_ef(x, err, jit=False)
    for p in range(pods):
        np.testing.assert_array_equal(mean.numpy(), want_m[p])
    np.testing.assert_array_equal(new_err.numpy(), want_e)
    # jitted: reciprocal multiplies and a fused multiply-add move the
    # scale, the mean and the error by a few ulps of the group's max |g|
    want_m, want_e = _reference_ef(x, err, jit=True)
    n = x[0].size
    g = np.pad((x + err).reshape(pods, -1), ((0, 0), (0, (-n) % 128))).reshape(pods, -1, 128)
    ulp = np.repeat(np.spacing(np.abs(g).max(axis=(0, 2))), 128)[:n].reshape(shape)
    assert (np.abs(mean.numpy() - want_m[0]) <= JIT_ULPS * ulp).all()
    assert (np.abs(new_err.numpy() - want_e) <= JIT_ULPS * ulp).all()
    # the int8 bound: each group's error at most half a step of its scale
    assert np.abs(mean.numpy() - (x + err).mean(0)).max() <= np.abs(x + err).max() / 127


def test_tree_mean_equals_per_leaf():
    """`compressed_pod_mean_plain` (all leaves in one reduction, bf16
    leaves cast to f32) gives each leaf's `ef_quantized_mean_plain`
    bits."""
    rng = np.random.default_rng(5)
    grads = {"a": torch.as_tensor(rng.normal(size=(3, 4, 40)), dtype=torch.float32),
             "b": [torch.as_tensor(rng.normal(size=(3, 130)), dtype=torch.bfloat16),
                   torch.as_tensor(rng.normal(size=(3, 1)), dtype=torch.float32)]}
    errors = tree.tree_map(lambda g: torch.as_tensor(
        rng.normal(size=tuple(g.shape)) * 1e-2, dtype=torch.float32), grads)
    means, errs = compress.compressed_pod_mean_plain(grads, errors)
    for path, g in tree.flatten(grads).items():
        m, e = compress.ef_quantized_mean_plain(g, tree.flatten(errors)[path])
        assert torch.equal(tree.flatten(means)[path], m)
        assert torch.equal(tree.flatten(errs)[path], e)
        assert m.dtype == torch.float32
    zeros_m, _ = compress.compressed_pod_mean_plain(grads)
    assert torch.equal(zeros_m["a"], compress.ef_quantized_mean_plain(
        grads["a"], torch.zeros(3, 4, 40))[0])


def test_one_rank_group_equals_plain(group):
    """The collective forms on the fixture's one-rank group: the plain
    form with one pod, bit for bit."""
    rng = np.random.default_rng(6)
    grads = {"w": torch.as_tensor(rng.normal(size=(5, 77)), dtype=torch.float32),
             "v": torch.as_tensor(rng.normal(size=(130,)), dtype=torch.bfloat16)}
    means, errs = compress.compressed_pod_mean(grads, dist.group.WORLD)
    for k, g in grads.items():
        m, e = compress.ef_quantized_mean_plain(g[None], torch.zeros((1,) + g.shape))
        assert torch.equal(means[k], m) and torch.equal(errs[k], e[0])
        m1, e1 = compress.ef_quantized_psum_mean(g, dist.group.WORLD, torch.zeros(g.shape))
        assert torch.equal(m1, m) and torch.equal(e1, e[0])
    assert compress.maybe_compressed_pod_mean(grads) is grads


WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed import compress

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
rng = np.random.default_rng(11)
x = rng.normal(size=(2, 130)) * rng.uniform(0.1, 10, size=(2, 130))
err = rng.normal(size=(2, 130)) * 1e-3
tree = {"x": torch.as_tensor(x[rank], dtype=torch.float32),
        "y": torch.as_tensor(rng.normal(size=(2, 3, 50))[rank], dtype=torch.float32)}
errors = {"x": torch.as_tensor(err[rank], dtype=torch.float32), "y": torch.zeros(3, 50)}
leaf = compress.ef_quantized_psum_mean(tree["x"], dist.group.WORLD, errors["x"])
means, errs = compress.compressed_pod_mean(tree, dist.group.WORLD, errors)
torch.save({"leaf": leaf, "means": means, "errs": errs}, out)
dist.destroy_process_group()
"""


def test_gloo_two_ranks_equal_plain(tmp_path):
    """Two spawned gloo ranks (a file store), each one pod: every rank's
    mean is the plain form's, its error the plain form's row."""
    init = f"file://{tmp_path / 'store'}"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), init,
                               str(tmp_path / f"{r}.pt")], env=env,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=60)
        assert p.returncode == 0, err[-2000:]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 130)) * rng.uniform(0.1, 10, size=(2, 130))
    err = rng.normal(size=(2, 130)) * 1e-3
    tree_ = {"x": torch.as_tensor(x, dtype=torch.float32),
             "y": torch.as_tensor(rng.normal(size=(2, 3, 50)), dtype=torch.float32)}
    errors = {"x": torch.as_tensor(err, dtype=torch.float32), "y": torch.zeros(2, 3, 50)}
    means, errs = compress.compressed_pod_mean_plain(tree_, errors)
    for r in range(2):
        got = torch.load(tmp_path / f"{r}.pt")
        assert torch.equal(got["leaf"][0], means["x"]) and torch.equal(got["leaf"][1],
                                                                      errs["x"][r])
        for k in tree_:
            assert torch.equal(got["means"][k], means[k])
            assert torch.equal(got["errs"][k], errs[k][r])


# --------------------------------------------------------------------------
# elastic restore
# --------------------------------------------------------------------------
def test_elastic_restore_resharding(tmp_path, group):
    """Save unsharded, restore onto a one-rank mesh sharding (the
    reference's test); then a qwen-smoke int8 train state through
    `param_shardings`, bit-equal to the plain restore."""
    ck = Checkpointer(str(tmp_path))
    tree_ = {"w": torch.arange(16.0).reshape(4, 4)}
    ck.save(1, tree_)
    sh = {"w": sharding.NamedSharding(group, ("data", None))}
    got = ck.restore(1, tree_, shardings=sh)
    assert isinstance(got["w"], DTensor) and got["w"].placements == sh["w"].placements
    assert got["w"].device_mesh == group
    np.testing.assert_array_equal(got["w"].full_tensor().numpy(), tree_["w"].numpy())

    cfg = configs.get_smoke("qwen1_5_0_5b")
    model = lm.init_params(cfg, torch.Generator().manual_seed(0))
    params = lm.param_tree(model)
    ocfg = opt.AdamWConfig(state_dtype="int8")
    grads = tree.tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator()
                                                .manual_seed(p.numel())).to(p.dtype), params)
    _, state, _ = opt.apply_updates(ocfg, params, grads, opt.init_state(ocfg, params))
    full = {"params": params, "opt": state}
    ck.save(2, full)
    plain = ck.restore(2, full)
    placed = ck.restore(2, full, shardings=sharding.param_shardings(full, group))
    flat_plain, flat_placed = tree.flatten(plain), tree.flatten(placed)
    assert flat_plain.keys() == flat_placed.keys()
    for path, want in flat_plain.items():
        got = flat_placed[path]
        assert isinstance(got, DTensor) and got.dtype == want.dtype, path
        assert torch.equal(got.full_tensor(), want), path
    assert flat_placed["params/embed/table"].placements == (Shard(1), Shard(0))
