"""The port's training path vs the JAX reference, on the CPU.

Held across the two packages, on the same numpy inputs:

  * `train.optimizer.apply_updates`, 3 steps given equal grads, for each
    state dtype, against the reference run op by op: ``lr`` and
    ``grad_norm`` at ``rtol=1e-6`` (f32 arithmetic in another summation
    order), f32 moments at ``rtol=1e-6`` (with an ``atol`` of 1e-6 of the
    tensor's largest element: a moment that cancels to near zero keeps
    its operands' absolute error), bf16 parameters and bf16
    moments at most one bf16 step apart, int8 ``q`` within ±1 and their
    scales at ``rtol=1e-6`` (a moment an ulp away from a rounding
    boundary may round the other way).  The reference squares each bf16
    grad in bf16 before its f32 sum, as the port does; jitted on XLA:CPU
    the square fuses into the reduction and loses that rounding, which
    moves the norm (and the clip scale) by about 3e-5 here: against the
    jitted reference ``grad_norm`` is held at ``rtol=1e-4``;
  * `lm.chunked_ce` (with a chunk that forces the padding) and
    `lm.loss_fn` on carried qwen-smoke (MHA, tied head), yi-6b-smoke
    (GQA, untied head), mixtral-smoke (experts, a window), mamba2-smoke
    (SSD blocks) and, in f32, deepseek-smoke (MLA, a leading dense
    layer, shared experts) and rg-smoke (RG-LRU blocks, local MQA
    attention, a ragged tail) weights,
    with and without ``loss_weights``: the loss and the router's
    ``lb_loss`` and ``z_loss`` at ``rtol=1e-3`` and each gradient leaf
    within a relative L2 error of ``5e-2`` (the reference's own jitted
    and op-by-op lowerings of this bf16 backward differ by up to 4.0e-2);
    with f32 weights and activations in both, the loss at ``rtol=1e-5``
    and each leaf at ``1e-4``.  Where bf16 rounding routes a token to
    other experts (``LOSS_FLIPS``), the gradients are taken on the
    reference's routing;
  * `carry.train_state` of a deepseek-smoke int8 state (``lead``, the
    experts, MLA) bit for bit;
  * `train.steps.make_train_step` from `carry.lm_params` +
    `carry.train_state` (bit for bit) of the reference's state after its
    first step, with 1 and 2 microbatches: 2 steps with f32 states, the
    first with int8 states (see the test): losses at ``rtol=2e-2`` (the
    reference's resume tolerance, `tests/test_substrate.py`), ``lr`` at
    ``rtol=1e-6``; so too on whisper-smoke and internvl-smoke batches that
    carry ``enc_frames`` or ``img_embeds``, and with
    ``compress_pod_grads``, whose step also equals the step without it
    bit for bit (the one-process hook is the identity, as the
    reference's);

and on the port alone: remat on and off give the same loss and grads
bit for bit, the loss and grads are finite on every dense smoke config,
rg-smoke and mamba2-smoke (the reference's `tests/test_arch_smoke.py::
test_forward_loss_grad`), a resumed run replays the uninterrupted run's
losses (the reference's `test_train_resume_matches_uninterrupted`, on
its own arch mamba2-smoke and on qwen-smoke), and a ``cuda`` request
without a GPU raises.  The smoke sequences are 16 tokens, inside one kv
chunk, so the masked-row NaN of `ROADMAP.md` § 3 is out of reach.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.train import optimizer as ref_opt
from repro.train import steps as ref_steps
from repro_torch import carry, configs
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import steps
from repro_torch.train import tree
from test_torch_lm import _first_flips, reference_params
from test_torch_moe import PortRouting, ReferenceRouting, force_routing
import torch_threads

torch_threads.cap_under_xdist()

BF16_STEP = 2.0 ** -7  # one bf16 step relative to the value (8 significant bits)
LOSS_RTOL = 1e-3
DENSE = ("qwen1_5_0_5b", "yi_6b", "llama3_405b")


def _batch(cfg, seed, b=4, s=16, weights=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1))
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if weights:
        out["loss_weights"] = rng.uniform(0.2, 2.0, b).astype(np.float32)
    return out


def _ref_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if k != "loss_weights" else jnp.float32)
            for k, v in batch.items()}


def _port_batch(batch):
    return train.batch_tensors(batch, "cpu")


def _np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# --------------------------------------------------------------------------
# the optimizer: 3 steps on equal grads
# --------------------------------------------------------------------------
def _toy(rng, dtype):
    return {"slots": ({"w": rng.standard_normal((6, 16, 32)).astype(dtype)},),
            "head": rng.standard_normal((16, 8)).astype(dtype)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_matches_reference(state_dtype):
    rng = np.random.default_rng(0)
    ref_cfg = ref_opt.AdamWConfig(peak_lr=0.05, warmup_steps=2, total_steps=5,
                                  state_dtype=state_dtype)
    cfg = opt.AdamWConfig(peak_lr=0.05, warmup_steps=2, total_steps=5, state_dtype=state_dtype)
    start = jax.tree.map(partial(jnp.asarray, dtype=jnp.bfloat16), _toy(rng, np.float32))
    ref_params, ref_state = start, ref_opt.init_state(ref_cfg, start)
    params = jax.tree.map(carry.lm_tensor, start)
    state = opt.init_state(cfg, params)
    for _ in range(3):
        g = jax.tree.map(partial(jnp.asarray, dtype=jnp.bfloat16), _toy(rng, np.float32))
        jitted_norm = jax.jit(ref_opt._global_norm)(g)
        with jax.disable_jit():
            ref_params, ref_state, ref_m = ref_opt.apply_updates(ref_cfg, ref_params, g,
                                                                 ref_state)
        params, state, m = opt.apply_updates(cfg, params, jax.tree.map(carry.lm_tensor, g),
                                             state)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jitted_norm), rtol=1e-4)
        # bf16 parameters at most one bf16 step apart
        for got, want in zip(tree.leaves(params), jax.tree.leaves(ref_params)):
            np.testing.assert_allclose(_np32(got), _np32(want), rtol=BF16_STEP, atol=0)
        assert int(state["step"]) == int(ref_state["step"])
        for mv in ("m", "v"):
            got, want = tree.flatten(state[mv]), tree.flatten(jax.tree.map(np.asarray, ref_state[mv]))
            assert got.keys() == want.keys()
            for path in want:
                a, b = got[path], want[path]
                if state_dtype == "float32":
                    np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                               atol=1e-6 * np.abs(b).max())
                elif state_dtype == "bfloat16":
                    np.testing.assert_allclose(_np32(a), _np32(b), rtol=BF16_STEP, atol=0)
                elif path.endswith("/0"):  # int8 q
                    assert a.dtype == torch.int8
                    assert np.abs(a.numpy().astype(int) - b.astype(int)).max() <= 1
                else:  # its f32 scale
                    np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_sliced_update_equals_whole(state_dtype, monkeypatch):
    """A leaf larger than ``UPDATE_CHUNK`` is updated in slices along its
    first axis: parameters and moments bit-equal to the whole-leaf update
    (a chunk of 3 rows over a (7, 5, 4) leaf: slices of 3, 3 and 1)."""
    rng = np.random.default_rng(4)
    cfg = opt.AdamWConfig(peak_lr=0.05, warmup_steps=1, total_steps=5, state_dtype=state_dtype)

    def tree_of(scale):
        return {"w": torch.as_tensor(rng.normal(size=(7, 5, 4)) * scale, dtype=torch.bfloat16),
                "b": torch.as_tensor(rng.normal(size=(6,)) * scale, dtype=torch.bfloat16)}

    start, grads = tree_of(1.0), [tree_of(0.1) for _ in range(2)]
    out = []
    for chunk in (opt.UPDATE_CHUNK, 3 * 5 * 4):
        monkeypatch.setattr(opt, "UPDATE_CHUNK", chunk)
        params = {k: v.clone() for k, v in start.items()}
        state = opt.init_state(cfg, params)
        for g in grads:
            params, state, _ = opt.apply_updates(cfg, params, g, state)
        out.append(tree.flatten({"p": params, "s": state}))
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        assert out[0][k].dtype == out[1][k].dtype and torch.equal(out[0][k], out[1][k]), k


def test_schedule_matches_reference():
    cfg = opt.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=50)
    ref_cfg = ref_opt.AdamWConfig(peak_lr=3e-3, warmup_steps=10, total_steps=50)
    steps_ = np.arange(0, 60, dtype=np.int32)
    got = opt.schedule(cfg, torch.as_tensor(steps_))
    want = np.asarray(jax.jit(partial(ref_opt.schedule, ref_cfg))(jnp.asarray(steps_)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------
def _rel_l2(got, want):
    got, want = _np32(got).ravel().astype(np.float64), _np32(want).ravel().astype(np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("weights", [True, False])
def test_chunked_ce_matches_reference(weights):
    """A chunk of 5 over 12 positions: 3 padded positions the mask drops."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((3, 12, 16)).astype(np.float32)
    head = (rng.standard_normal((16, 40)) / 4).astype(np.float32)
    tgt = rng.integers(0, 40, (3, 12))
    w = rng.uniform(0.1, 3.0, 3).astype(np.float32) if weights else None
    hj, headj = jnp.asarray(h, jnp.bfloat16), jnp.asarray(head, jnp.bfloat16)

    def ref(hh, hd):
        nll, zl = ref_lm.chunked_ce(hh, hd, jnp.asarray(tgt, jnp.int32),
                                    None if w is None else jnp.asarray(w), chunk=5)
        return nll + zl, (nll, zl)

    (_, (nll, zl)), (gh, ghead) = jax.jit(jax.value_and_grad(ref, (0, 1), has_aux=True))(
        hj, headj)
    ht = carry.lm_tensor(hj).requires_grad_(True)
    headt = carry.lm_tensor(headj).requires_grad_(True)
    pn, pz = lm.chunked_ce(ht, headt, torch.as_tensor(tgt),
                           None if w is None else torch.as_tensor(w), chunk=5)
    gph, gphead = torch.autograd.grad(pn + pz, (ht, headt))
    np.testing.assert_allclose(float(pn), float(nll), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pz), float(zl), rtol=LOSS_RTOL)
    assert _rel_l2(gph, gh) <= 1e-2 and _rel_l2(gphead, ghead) <= 1e-2


LOSS_CASES = {  # name → (arch, loss_weights, dtype of the weights and activations)
    "qwen-weighted": ("qwen1_5_0_5b", True, "bf16"),
    "qwen-unweighted": ("qwen1_5_0_5b", False, "bf16"),
    "yi-weighted": ("yi_6b", True, "bf16"),
    "qwen-f32": ("qwen1_5_0_5b", True, "f32"),
    "yi-f32": ("yi_6b", True, "f32"),
    "mixtral-weighted": ("mixtral_8x22b", True, "bf16"),
    "mixtral-f32": ("mixtral_8x22b", True, "f32"),
    "deepseek-f32": ("deepseek_v2_236b", True, "f32"),
    "rg-f32": ("recurrentgemma_9b", True, "f32"),
    "mamba2-weighted": ("mamba2_130m", True, "bf16"),
    "mamba2-f32": ("mamba2_130m", True, "f32"),
}
# bf16: the reference's own two lowerings of this backward (jitted against
# op by op under `jax.disable_jit`) differ by up to 4.0e-2 relative L2 on
# a leaf of these inputs (1 to 4% on every leaf; the port sits as far from
# an f32 oracle as the jitted reference does), so a bf16 leaf is held at
# 5e-2.  f32: the same function in another summation order.
GRAD_TOL = {"bf16": 5e-2, "f32": 1e-4}
LOSS_TOL = {"bf16": LOSS_RTOL, "f32": 1e-5}
# Tokens that the two packages route to different expert sets (a near tie
# of the router that bf16 rounding breaks; ROADMAP.md § 3), the first of
# each row as (MoE call, row, position): mixtral-smoke's layer 2 routes
# rows 0 and 1 at tokens 0 and 8 to experts {0, 1} in the reference and
# {0, 3} in the port (probabilities 0.2265 and 0.2228, 0.1572 and 0.1550).
# A flip moves the expert counts, so the router's lb_loss and z_loss are
# then not compared (the loss, whose share of them is 0.01·lb + 1e-4·z,
# still is), and it moves every gradient upstream of it (blocks.1.mix.wo
# at 5.07e-2 here): the gradients are then those of the port's model on
# the reference's routing (`test_torch_moe.force_routing`).
LOSS_FLIPS = {"mixtral-weighted": [(2, 0, 0), (2, 1, 8)]}


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_fn_matches_reference(case, monkeypatch):
    """The loss and every gradient leaf on the reference's weights; the
    f32 cases run both packages with f32 weights and activations (the
    module-level ``DTYPE`` of each set to f32)."""
    import repro.models.layers as ref_layers

    arch, weighted, dtype = LOSS_CASES[case]
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    params = reference_params(ref_cfg, seed=0)
    if dtype == "f32":
        for mod in (ref_layers, ref_lm):
            monkeypatch.setattr(mod, "DTYPE", jnp.float32)
        monkeypatch.setattr(lm, "DTYPE", torch.float32)
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    batch = _batch(ref_cfg, 7, weights=weighted)
    ref_routing = ReferenceRouting(monkeypatch)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        partial(ref_lm.loss_fn, ref_cfg), has_aux=True))(params, _ref_batch(batch))

    ref_calls = ref_routing.take()[0]
    model = carry.lm_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    if dtype == "f32":
        model = model.float()
        model.load_state_dict({k: torch.as_tensor(v) for k, v in _named(params).items()})
    model.requires_grad_(True)
    port = PortRouting(monkeypatch)
    got, aux = lm.loss_fn(cfg, model, _port_batch(batch))
    flips = _first_flips(ref_calls, port.take()[0], *batch["tokens"].shape)[1]
    assert flips == LOSS_FLIPS.get(case, []), flips
    np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(aux["ce"]), float(metrics["ce"]), rtol=LOSS_TOL[dtype])
    for k in ("lb_loss", "z_loss"):  # the router's terms: zeros without experts
        if not flips:
            np.testing.assert_allclose(float(aux[k]), float(metrics[k]), rtol=LOSS_TOL[dtype])
        assert (float(metrics[k]) == 0.0) == (not cfg.is_moe)
    names, leaves = zip(*model.named_parameters())
    if flips:
        force_routing(monkeypatch, ref_calls)
        got, _ = lm.loss_fn(cfg, model, _port_batch(batch))
        np.testing.assert_allclose(float(got), float(loss), rtol=LOSS_TOL[dtype])
    port_grads = torch.autograd.grad(got, leaves)
    want = _named(grads)  # the grads in the port's layout
    assert set(names) == set(want)
    for name, g in zip(names, port_grads):
        assert g.dtype == leaves[names.index(name)].dtype
        assert _rel_l2(g, want[name]) <= GRAD_TOL[dtype], name


def _named(ref_tree) -> dict:
    """The reference's param-shaped tree as the port's state-dict names →
    f32 numpy (``slots`` unstacked into blocks, ``lead`` as ``lead.i``)."""
    out = {}
    for k, v in ref_tree.items():
        if k == "slots":
            for j, slot in enumerate(v):
                for name, a in carry._flat(slot):
                    for u in range(a.shape[0]):
                        out[f"blocks.{u * len(v) + j}.{name}"] = np.asarray(a[u], np.float32)
        elif isinstance(v, (dict, list)):
            for name, a in carry._flat(v):
                out[f"{k}.{name}"] = np.asarray(a, np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def test_remat_leaves_loss_and_grads_unchanged():
    cfg = configs.get_smoke("yi_6b")
    model = lm.init_params(cfg, torch.Generator().manual_seed(2)).requires_grad_(True)
    batch = _port_batch(_batch(cfg, 3))
    out = []
    for remat_units in (False, True):
        loss, _ = lm.loss_fn(cfg, model, batch, remat_units=remat_units)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", DENSE + ("recurrentgemma_9b", "mamba2_130m"))
def test_forward_loss_grad(arch):
    cfg = configs.get_smoke(arch)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0)).requires_grad_(True)
    loss, _ = lm.loss_fn(cfg, model, _port_batch(_batch(cfg, 0, b=2, s=16, weights=False)))
    assert np.isfinite(float(loss)), arch
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads), arch


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro, state_dtype):
    """Two steps from the reference's state after its first.  With int8
    states only the first is compared: each takes its loss on the carried
    parameters and updates from the carried int8 moments, but the int8
    second moment rounds small entries to 0, whose update is ``m̂/eps``
    (the reference's own run diverges: `ROADMAP.md` § 3), so a ±1
    difference in one ``q`` — from grads that differ by bf16 rounding —
    moves a parameter by orders of magnitude, and the next loss is not a
    parity check."""
    arch = "qwen1_5_0_5b"
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6, state_dtype=state_dtype)
    ref_step = jax.jit(ref_steps.make_train_step(
        ref_cfg, ref_opt.AdamWConfig(**kw),
        ref_steps.TrainOptions(num_microbatches=micro, remat=False)))
    params = reference_params(ref_cfg, seed=1)
    state = ref_opt.init_state(ref_opt.AdamWConfig(**kw), params)
    batches = [_batch(cfg, 10 + i) for i in range(3)]
    params, state, _ = ref_step(params, state, _ref_batch(batches[0]))
    np_params, np_state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)

    model = carry.lm_params(np_params, cfg, "cpu")
    port_state = carry.train_state(np_params, np_state, cfg, "cpu")
    fresh = opt.init_state(opt.AdamWConfig(**kw), lm.param_tree(model))
    assert tree.flatten(port_state).keys() == tree.flatten(fresh).keys()
    for mv in ("m", "v"):  # the carry is bit for bit
        got = tree.flatten(port_state[mv])
        for path, a in tree.flatten(np_state[mv]).items():
            if path.startswith("slots/0/"):
                parts = path.split("/")
                for u in range(a.shape[0]):
                    b = got["/".join(["blocks", str(u)] + parts[2:])]
                    np.testing.assert_array_equal(b.float().numpy(), np.asarray(a[u], np.float32))
            else:
                np.testing.assert_array_equal(got[path].float().numpy(), np.asarray(a, np.float32))
    assert int(port_state["step"]) == 1
    port_step = steps.make_train_step(cfg, opt.AdamWConfig(**kw),
                                      steps.TrainOptions(num_microbatches=micro, remat=False))
    compared = batches[1:] if state_dtype == "float32" else batches[1:2]
    for batch in compared:
        params, state, want = ref_step(params, state, _ref_batch(batch))
        model, port_state, got = port_step(model, port_state, _port_batch(batch))
        assert set(got) == {"loss", "ce", "lb_loss", "z_loss", "grad_norm", "lr"} == set(want)
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-2)
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]), rtol=1e-6)
    assert int(port_state["step"]) == 1 + len(compared)


def test_train_state_carries_lead_and_experts():
    """`carry.train_state` of a deepseek-smoke int8 AdamW state after one
    update (nonzero moments, ``(q, scale)`` pairs): the tree of
    `lm.param_tree` (``lead``, the f32 router, the experts, MLA), every
    leaf bit for bit."""
    arch, state_dtype = "deepseek_v2_236b", "int8"
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    ocfg = ref_opt.AdamWConfig(state_dtype=state_dtype)
    params = reference_params(ref_cfg, seed=2)
    grads = reference_params(ref_cfg, seed=3)
    _, state, _ = jax.jit(partial(ref_opt.apply_updates, ocfg))(
        params, grads, ref_opt.init_state(ocfg, params))
    np_params, np_state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    model = carry.lm_params(np_params, cfg, "cpu")
    port_state = carry.train_state(np_params, np_state, cfg, "cpu")
    fresh = opt.init_state(opt.AdamWConfig(state_dtype=state_dtype), lm.param_tree(model))
    assert tree.flatten(port_state).keys() == tree.flatten(fresh).keys()
    assert any(path.startswith("m/lead/0/mix/wukv") for path in tree.flatten(port_state))
    for mv in ("m", "v"):
        got = tree.flatten(port_state[mv])
        for path, a in tree.flatten(np_state[mv]).items():
            parts = path.split("/")
            if parts[0] == "slots":
                for u in range(a.shape[0]):
                    b = got["/".join(["blocks", str(u)] + parts[2:])]
                    np.testing.assert_array_equal(b.numpy(), np.asarray(a[u]))
            else:
                np.testing.assert_array_equal(got[path].numpy(), np.asarray(a))


def test_compress_pod_grads_matches_reference():
    """``compress_pod_grads``: the step's hook, `distributed.compress.
    maybe_compressed_pod_mean`, is the identity on one process, as the
    reference's is.  Two qwen-smoke steps with the option equal two
    without it bit for bit (parameters, state and metrics), and the
    reference's jitted step with the option at ``rtol=2e-2``."""
    arch = "qwen1_5_0_5b"
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6)
    ref_step = jax.jit(ref_steps.make_train_step(
        ref_cfg, ref_opt.AdamWConfig(**kw),
        ref_steps.TrainOptions(remat=False, compress_pod_grads=True)))
    params = reference_params(ref_cfg, seed=4)
    state = ref_opt.init_state(ref_opt.AdamWConfig(**kw), params)
    np_params, np_state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    batches = [_batch(cfg, 20 + i) for i in range(2)]
    runs = {}
    for on in (False, True):
        model = carry.lm_params(np_params, cfg, "cpu")
        port_state = carry.train_state(np_params, np_state, cfg, "cpu")
        step = steps.make_train_step(cfg, opt.AdamWConfig(**kw),
                                     steps.TrainOptions(remat=False, compress_pod_grads=on))
        metrics = []
        for batch in batches:
            model, port_state, m = step(model, port_state, _port_batch(batch))
            metrics.append(m)
        runs[on] = (lm.param_tree(model), port_state, metrics)
    for a, b in zip(*(tree.leaves(runs[on][:2]) for on in (False, True))):
        assert torch.equal(a, b)
    for a, b in zip(runs[False][2], runs[True][2]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    for batch, got in zip(batches, runs[True][2]):
        params, state, want = ref_step(params, state, _ref_batch(batch))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-2)
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]), rtol=1e-6)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ["whisper_small", "internvl2_26b"])
def test_extras_train_step_matches_reference(arch, micro):
    """`make_train_step` on batches that carry whisper's ``enc_frames`` or
    internvl's ``img_embeds`` (drawn as `launch/serve.py` draws them),
    with 1 and 2 microbatches (the extras sliced with the tokens) and f32
    states: two steps from the reference's state after its first, as
    `test_train_step_matches_reference` holds qwen — losses at
    ``rtol=2e-2``, ``lr`` at ``rtol=1e-6``."""
    from test_torch_encdec_vlm import _extras, _port_extras, _ref_extras

    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6)
    ref_step = jax.jit(ref_steps.make_train_step(
        ref_cfg, ref_opt.AdamWConfig(**kw),
        ref_steps.TrainOptions(num_microbatches=micro, remat=False)))
    params = reference_params(ref_cfg, seed=1)
    state = ref_opt.init_state(ref_opt.AdamWConfig(**kw), params)
    rng = np.random.default_rng(30)
    batches = []
    for i in range(3):
        base = _batch(cfg, 30 + i)
        batches.append((base, _extras(cfg, rng, b=base["tokens"].shape[0])))
    base, extras = batches[0]
    params, state, _ = ref_step(params, state, {**_ref_batch(base), **_ref_extras(extras)})
    np_params, np_state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    model = carry.lm_params(np_params, cfg, "cpu")
    port_state = carry.train_state(np_params, np_state, cfg, "cpu")
    port_step = steps.make_train_step(cfg, opt.AdamWConfig(**kw),
                                      steps.TrainOptions(num_microbatches=micro, remat=False))
    for base, extras in batches[1:]:
        params, state, want = ref_step(params, state, {**_ref_batch(base),
                                                       **_ref_extras(extras)})
        model, port_state, got = port_step(model, port_state, {**_port_batch(base),
                                                               **_port_extras(extras)})
        assert set(got) == set(want)
        assert np.isfinite(float(got["loss"]))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-2)
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]), rtol=1e-6)
    assert int(port_state["step"]) == 3


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def _main(ckpt_dir, n_steps, *extra, arch="qwen1.5-0.5b"):
    return train.main(["--arch", arch, "--smoke", "--device", "cpu", "--eval-backend", "host",
                       "--steps", str(n_steps), "--batch", "4", "--ckpt-dir", str(ckpt_dir),
                       "--ckpt-every", "2", *extra])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_train_resume_matches_uninterrupted(tmp_path, arch):
    """The reference's test on its own arch (mamba2) and on qwen."""
    run = partial(_main, arch=arch)
    a = run(tmp_path / "a", 4)
    # crash after 2 steps: run to 2, then resume to 4 in a new call
    b1 = run(tmp_path / "b", 2)
    b2 = run(tmp_path / "b", 4, "--resume")
    assert len(a) == 4 and len(b2) == 2
    np.testing.assert_allclose(b1, a[:2], rtol=2e-2, atol=2e-2)
    # the resumed tail reproduces the uninterrupted run's losses
    np.testing.assert_allclose(b2, a[2:], rtol=2e-2, atol=2e-2)
    assert all(np.isfinite(a))


def test_main_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
