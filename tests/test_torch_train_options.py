"""The reference's own train options on the port, on the CPU.

Held, on the same numpy inputs:

  * `train.optimizer.apply_updates` updates the state it is given in
    place, as the reference's dry run donates it: for f32, bf16 and int8
    states, on whole leaves and on ``UPDATE_CHUNK`` slices, the returned
    state is the passed dict and every moment (an int8 leaf's ``q`` and
    ``scale``) and the step keep their storage (``data_ptr``), with the
    values of the reference's `apply_updates` run op by op at
    `tests/test_torch_train.py`'s tolerances;
  * `train.steps.make_train_step` adds each microbatch's gradients into
    its accumulator in place: the gradients it hands to the update are
    bit-equal to the written form ``(a + g.to(adt)).to(adt)`` then
    ``a / n`` over `torch.autograd.grad` of each microbatch, for f32 and
    bf16 accumulators, with and without remat, and no ``.grad`` is left;
  * `train.steps.dryrun_train_options` against the reference dry run's
    `_microbatches` and its state-dtype and accumulator thresholds, for
    all ten configs;
  * one step of the reference's `make_train_step` and of the port's under
    the dry-run options of mixtral-8x22b and deepseek-v2-236b (int8
    states, 8 microbatches, remat, a bf16 accumulator) and of
    internvl2-26b (f32 states and accumulator, 8 microbatches, remat) on
    the smoke configs, batches of 8 rows: the loss and each accumulated
    gradient leaf.  The MoE cases run with f32 weights and activations,
    since bf16 rounding routes some tokens of these inputs to other
    experts (`ROADMAP.md` § 3); their bf16 accumulators then differ by at
    most about one bf16 step where the two f32 gradients straddle a
    rounding boundary (``BF16_STEP``; 6.1e-4 observed).  internvl runs in
    bf16, at the bf16 gradient tolerance of `tests/test_torch_train.py`
    (5e-2; 2.3e-2 observed).

`tests/test_torch_options_gap.py` derives the tolerance of
`chip_smoke.py`'s check (e) from the reference; deepseek's cases of both
are in `tests/test_torch_options_mla.py`.
"""
import inspect
import os
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
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import steps
from repro_torch.train import tree
from test_torch_encdec_vlm import _extras, _port_extras, _ref_extras
from test_torch_lm import reference_params
from test_torch_train import (BF16_STEP, GRAD_TOL, LOSS_TOL, _batch, _named, _np32, _port_batch,
                              _ref_batch, _rel_l2)
import torch_threads

torch_threads.cap_under_xdist()


# --------------------------------------------------------------------------
# the update, in place
# --------------------------------------------------------------------------
def _toy(rng):
    return {"slots": ({"w": rng.standard_normal((6, 16, 32))},),
            "head": rng.standard_normal((16, 8))}


def _storage(state) -> list:
    return [x.data_ptr() for x in tree.leaves(state)]


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_update_writes_the_passed_state(state_dtype, sliced, monkeypatch):
    """Sliced: a chunk of 4 rows of (16, 32) over the (6, 16, 32) leaf,
    slices of 4 and 2 rows."""
    if sliced:
        monkeypatch.setattr(opt, "UPDATE_CHUNK", 4 * 16 * 32)
    rng = np.random.default_rng(5)
    kw = dict(peak_lr=0.05, warmup_steps=2, total_steps=5, state_dtype=state_dtype)
    ref_cfg, cfg = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    start = jax.tree.map(partial(jnp.asarray, dtype=jnp.bfloat16), _toy(rng))
    ref_params, ref_state = start, ref_opt.init_state(ref_cfg, start)
    params = jax.tree.map(carry.lm_tensor, start)
    state = opt.init_state(cfg, params)
    where = _storage(state)
    for _ in range(3):
        g = jax.tree.map(partial(jnp.asarray, dtype=jnp.bfloat16), _toy(rng))
        with jax.disable_jit():
            ref_params, ref_state, _ = ref_opt.apply_updates(ref_cfg, ref_params, g, ref_state)
        _, out, _ = opt.apply_updates(cfg, params, jax.tree.map(carry.lm_tensor, g), state)
        assert out is state and _storage(out) == where
        assert int(state["step"]) == int(ref_state["step"])
        for got, want in zip(tree.leaves(params), jax.tree.leaves(ref_params)):
            np.testing.assert_allclose(_np32(got), _np32(want), rtol=BF16_STEP, atol=0)
        for mv in ("m", "v"):
            got = tree.flatten(state[mv])
            want = tree.flatten(jax.tree.map(np.asarray, ref_state[mv]))
            assert got.keys() == want.keys()
            for path, b in want.items():
                a = got[path]
                if state_dtype == "float32":
                    np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                               atol=1e-6 * np.abs(b).max())
                elif state_dtype == "bfloat16":
                    np.testing.assert_allclose(_np32(a), _np32(b), rtol=BF16_STEP, atol=0)
                elif path.endswith("/0"):  # int8 q: ±1 at a rounding boundary
                    assert np.abs(a.numpy().astype(int) - b.astype(int)).max() <= 1
                else:  # its f32 scale
                    np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the microbatch accumulation, in place
# --------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("accum_dtype", ["float32", "bfloat16"])
def test_accumulation_equals_written_form(accum_dtype, remat, monkeypatch):
    """4 microbatches of a weighted qwen-smoke batch of 8 rows."""
    cfg = configs.get_smoke("qwen1_5_0_5b")
    n, adt = 4, {"float32": torch.float32, "bfloat16": torch.bfloat16}[accum_dtype]
    model = lm.init_params(cfg, torch.Generator().manual_seed(3))
    leaves = tree.leaves(lm.param_tree(model))
    for p in leaves:
        p.requires_grad_(True)
    batch = _port_batch(_batch(cfg, 11, b=8))
    acc = [torch.zeros(p.shape, dtype=adt) for p in leaves]
    for i in range(n):
        micro = {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
        loss, _ = lm.loss_fn(cfg, model, micro, remat_units=remat)
        g = torch.autograd.grad(loss, leaves)
        acc = [(a + b.to(adt)).to(adt) for a, b in zip(acc, g)]
    want = [a / n for a in acc]

    seen = []
    real = opt.apply_updates

    def capture(ocfg, params, grads, state):
        seen.append([g.clone() for g in tree.leaves(grads)])
        return real(ocfg, params, grads, state)

    monkeypatch.setattr(opt, "apply_updates", capture)
    ocfg = opt.AdamWConfig()
    step = steps.make_train_step(cfg, ocfg, steps.TrainOptions(
        num_microbatches=n, remat=remat, accum_dtype=accum_dtype))
    step(model, opt.init_state(ocfg, lm.param_tree(model)), batch)
    (got,) = seen
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == adt and torch.equal(a, b)
    assert all(p.grad is None for p in leaves)


# --------------------------------------------------------------------------
# the dry run's options
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dryrun():
    """`repro.launch.dryrun`, whose import sets ``XLA_FLAGS`` for 512
    host devices: imported once the backend is up (the flags then no
    longer apply), with the variable put back."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as module
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return module


@pytest.mark.parametrize("arch", configs.all_archs())
def test_dryrun_train_options_match_reference(arch, dryrun):
    ref_cfg = ref_configs.get_config(arch)
    state_dtype, topts = steps.dryrun_train_options(configs.get_config(arch))
    big = ref_cfg.param_count() > 1e11
    assert state_dtype == ("int8" if big else "float32")
    assert topts == steps.TrainOptions(
        num_microbatches=dryrun._microbatches(ref_cfg, "train_4k"), remat=True,
        accum_dtype="bfloat16" if big else "float32")
    # the thresholds as the reference's lower_cell writes them
    src = inspect.getsource(dryrun.lower_cell)
    assert 'state_dtype="int8" if cfg.param_count() > 1e11 else "float32"' in src
    assert 'accum_dtype="bfloat16" if cfg.param_count() > 1e11 else "float32"' in src
    assert "remat=True" in src


# --------------------------------------------------------------------------
# one step under the dry-run options, against the reference
# --------------------------------------------------------------------------
DRYRUN_CASES = {  # name → (arch, dtype of the weights and activations)
    "mixtral-f32": ("mixtral_8x22b", "f32"),
    "deepseek-f32": ("deepseek_v2_236b", "f32"),
    "internvl-bf16": ("internvl2_26b", "bf16"),
}
# f32: the same f32 gradients to 1e-6, each microbatch's sum rounded to
# the bf16 accumulator; bf16: `tests/test_torch_train.py`'s GRAD_TOL
DRYRUN_GRAD_TOL = {"f32": BF16_STEP, "bf16": GRAD_TOL["bf16"]}


def reference_grads(ref_cfg, ocfg, topts, params, state, batch, monkeypatch):
    """One jitted step of the reference's `make_train_step` → (metrics,
    the gradients it hands to `apply_updates`, as the port's names)."""
    real = ref_opt.apply_updates

    def capture(c, p, g, s):
        p, s, m = real(c, p, g, s)
        return p, s, {**m, "grads": g}

    monkeypatch.setattr(ref_opt, "apply_updates", capture)
    # make_train_step sets the module-global REMAT_UNITS: restored after
    monkeypatch.setattr(ref_lm, "REMAT_UNITS", ref_lm.REMAT_UNITS)
    _, _, metrics = jax.jit(ref_steps.make_train_step(ref_cfg, ocfg, topts))(params, state,
                                                                             batch)
    monkeypatch.setattr(ref_opt, "apply_updates", real)
    return metrics, _named(metrics["grads"])


def port_grads(cfg, ocfg, topts, model, state, batch, monkeypatch):
    """One step of the port's `make_train_step` → (metrics, the gradients
    it hands to `apply_updates`, by parameter name)."""
    names = {id(p): n for n, p in model.named_parameters()}
    seen = {}
    real = opt.apply_updates

    def capture(c, p, g, s):
        seen.update({names[id(q)]: x.float().clone()
                     for q, x in zip(tree.leaves(p), tree.leaves(g))})
        return real(c, p, g, s)

    monkeypatch.setattr(opt, "apply_updates", capture)
    _, _, metrics = steps.make_train_step(cfg, ocfg, topts)(model, state, batch)
    monkeypatch.setattr(opt, "apply_updates", real)
    return metrics, seen


@pytest.mark.parametrize("case", ["mixtral-f32", "internvl-bf16"])
def test_dryrun_step_matches_reference(case, monkeypatch):
    check_dryrun_step(case, monkeypatch)


def check_dryrun_step(case: str, monkeypatch) -> None:
    """`DRYRUN_CASES`' ``case`` (deepseek's in `tests/test_torch_options_mla.py`)."""
    import repro.models.layers as ref_layers

    arch, dtype = DRYRUN_CASES[case]
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    state_dtype, topts = steps.dryrun_train_options(configs.get_config(arch))
    assert topts.num_microbatches == 8 and topts.remat
    ref_topts = ref_steps.TrainOptions(num_microbatches=topts.num_microbatches,
                                       remat=topts.remat, accum_dtype=topts.accum_dtype)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6, state_dtype=state_dtype)
    params = reference_params(ref_cfg, seed=0)
    if dtype == "f32":
        for mod in (ref_layers, ref_lm):
            monkeypatch.setattr(mod, "DTYPE", jnp.float32)
        monkeypatch.setattr(lm, "DTYPE", torch.float32)
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    base = _batch(cfg, 5, b=8)
    extras = _extras(cfg, np.random.default_rng(5), b=8) if cfg.family == "vlm" else {}
    want, want_g = reference_grads(
        ref_cfg, ref_opt.AdamWConfig(**kw), ref_topts, params,
        ref_opt.init_state(ref_opt.AdamWConfig(**kw), params),
        {**_ref_batch(base), **_ref_extras(extras)}, monkeypatch)

    model = carry.lm_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    if dtype == "f32":
        model = model.float()
        model.load_state_dict({k: torch.as_tensor(v) for k, v in _named(params).items()})
    ocfg = opt.AdamWConfig(**kw)
    got, got_g = port_grads(cfg, ocfg, topts, model, opt.init_state(ocfg, lm.param_tree(model)),
                            {**_port_batch(base), **_port_extras(extras)}, monkeypatch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(got["lr"]), float(want["lr"]), rtol=1e-6)
    assert got_g.keys() == want_g.keys()
    for name, g in got_g.items():
        assert _rel_l2(g, want_g[name]) <= DRYRUN_GRAD_TOL[dtype], name
