"""The port's MoE and MLA modules (`repro_torch.models.{moe,mla}`) vs the JAX reference.

Held across the two packages, on the CPU, on the same numpy inputs and
weights (normal × 1/sqrt(fan_in), norm scales about 1):

  * `moe.moe_apply` at the mixtral-smoke and deepseek-smoke shapes (the
    latter with a shared expert), at 8 tokens, where the capacity floor of
    8 slots holds every token, and at 64 tokens about one hot direction,
    where the capacity binds and slots are dropped: the routed expert ids
    (``idx``), the buffer rows (``dest``) and ``keep`` equal as integers,
    ``drop_frac`` equal, ``lb_loss`` and ``z_loss`` within 1e-5 relative,
    and ``y`` at the reference's tolerance for two lowerings
    (``rtol=5e-2, atol=5e-2``, `tests/test_arch_smoke.py`);
  * `mla.mla_apply` (the decompressed prefill) and the absorbed
    `mla.mla_decode` from the reference's own cache, within two bf16
    steps as the attention tests are, and the cache written in place;
    and the decode against the prefill: another function of the same
    weights in both packages (the two read ``wukv`` in two layouts,
    `ROADMAP.md` § 3), the same one where the layouts agree.

The reference's routing is read with spies on its own module's
`jax.lax.top_k` and `jnp.where` (ordered `jax.debug.callback`s, so the
jitted reference runs unchanged); `ReferenceRouting`, `PortRouting` and
`force_routing` also serve the model and loss tests of
`tests/test_torch_{lm,train}.py`.
"""
import dataclasses
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro_torch import carry, configs
from repro_torch.models import mla, moe
import torch_threads

torch_threads.cap_under_xdist()

TOL = dict(rtol=5e-2, atol=5e-2)  # `tests/test_arch_smoke.py::test_decode_matches_forward`
BF16_STEP = 2.0 ** -7  # one bf16 step relative to the value (8 significant bits)
MOE_ARCHS = ("mixtral_8x22b", "deepseek_v2_236b")


# --------------------------------------------------------------------------
# routing capture
# --------------------------------------------------------------------------
class ReferenceRouting:
    """Records every call of the reference's `moe_apply`, jitted or not:
    its top-k expert ids (T, k) in ``idx`` and its buffer rows (T·k,) in
    ``dest``, in call order.  Installed on ``repro.models.moe``'s module
    globals by ``monkeypatch`` before the reference is traced."""

    def __init__(self, monkeypatch):
        self.idx, self.dest = [], []
        real_top_k, real_where = jax.lax.top_k, jnp.where

        def record(sink, a):
            jax.debug.callback(lambda v: sink.append(np.asarray(v)), a, ordered=True)
            return a

        def top_k(x, k):
            gates, idx = real_top_k(x, k)
            return gates, record(self.idx, idx)

        def where(*args):
            return record(self.dest, real_where(*args))

        spy_jax = types.SimpleNamespace(nn=jax.nn, lax=types.SimpleNamespace(top_k=top_k))
        spy_jnp = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                           if not n.startswith("_")})
        spy_jnp.where = where
        monkeypatch.setattr(ref_moe, "jax", spy_jax)
        monkeypatch.setattr(ref_moe, "jnp", spy_jnp)

    def take(self):
        """The calls recorded since the last `take` → (idx list, dest list)."""
        jax.effects_barrier()
        out = (self.idx[:], self.dest[:])
        self.idx.clear()
        self.dest.clear()
        return out


class PortRouting:
    """Records every call of the port's `moe.moe_apply` (through
    `moe.route` and `moe.dispatch`): its expert ids, buffer rows and aux
    (``drop_frac`` included), in call order."""

    def __init__(self, monkeypatch):
        self.idx, self.dest, self.aux = [], [], []
        real_route, real_dispatch, real_apply = moe.route, moe.dispatch, moe.moe_apply

        def route(*args):
            out = real_route(*args)
            self.idx.append(out[3].numpy().copy())
            return out

        def dispatch(*args):
            counts, keep, dest = real_dispatch(*args)
            self.dest.append(dest.numpy().copy())
            return counts, keep, dest

        def moe_apply(*args):
            y, aux = real_apply(*args)
            self.aux.append({k: float(v) for k, v in aux.items()})
            return y, aux

        monkeypatch.setattr(moe, "route", route)
        monkeypatch.setattr(moe, "dispatch", dispatch)
        monkeypatch.setattr(moe, "moe_apply", moe_apply)

    def take(self):
        out = (self.idx[:], self.dest[:], self.aux[:])
        for sink in (self.idx, self.dest, self.aux):
            sink.clear()
        return out


def force_routing(monkeypatch, ref_idx: list):
    """The port's `moe.route` made to pick, call by call, the experts that
    the reference picked (its own probabilities gathered at those ids and
    renormalised): the port's model on the reference's routing."""
    calls = iter(ref_idx)
    real_route = moe.route

    def route(p, xt, cfg):
        logits, probs, _, _ = real_route(p, xt, cfg)
        idx = torch.as_tensor(next(calls), device=xt.device).long()
        gates = torch.gather(probs, 1, idx)
        return logits, probs, gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9), idx

    monkeypatch.setattr(moe, "route", route)


def flipped_tokens(ref_idx: list, port_idx: list) -> list[tuple[int, int]]:
    """(call, token) wherever the two sides routed a token to another set
    of experts (the order within the top-k is not compared: a near tie
    between two chosen experts changes only the order of the sum)."""
    assert len(ref_idx) == len(port_idx)
    out = []
    for call, (a, b) in enumerate(zip(ref_idx, port_idx)):
        assert a.shape == b.shape
        diff = (np.sort(a, axis=1) != np.sort(b, axis=1)).any(axis=1)
        out += [(call, int(t)) for t in np.flatnonzero(diff)]
    return out


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------
def fill(shapes, seed):
    """A reference param tree of ``shapes`` filled from numpy: normal ×
    1/sqrt(fan_in) (the second-to-last axis), norm scales about 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        if path[-1].key == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        else:
            a = rng.standard_normal(spec.shape) / np.sqrt(spec.shape[-2])
        return jnp.asarray(a, spec.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(module, ref_params):
    module.load_state_dict({name: carry.lm_tensor(a) for name, a in carry._flat(
        jax.tree.map(np.asarray, ref_params))}, strict=True)
    return module


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _cfgs(arch):
    return configs.get_smoke(arch), ref_configs.get_smoke(arch)


def _tokens(cfg, b, s, hot: bool, seed: int):
    """(B, S, d) bf16 activations: unit normals, or a shared direction plus
    small noise (``hot``: most tokens pick the same experts)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model))
    if hot:
        x = 0.3 * x + 2.0 * rng.standard_normal(cfg.d_model)
    return jnp.asarray(x, jnp.bfloat16)


# --------------------------------------------------------------------------
# moe_apply
# --------------------------------------------------------------------------
CAPACITY_CASES = {  # name → (B, S, hot): 8 tokens never drop (cap 8 ≥ T)
    "fits": (2, 4, False),
    "binds": (4, 16, True),
}


@pytest.mark.parametrize("case", CAPACITY_CASES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, case, monkeypatch):
    cfg, ref_cfg = _cfgs(arch)
    b, s, hot = CAPACITY_CASES[case]
    params = fill(jax.eval_shape(partial(ref_moe.moe_init, cfg=ref_cfg), jax.random.PRNGKey(0)),
                  seed=1)
    x = _tokens(cfg, b, s, hot, seed=2)
    ref_routing = ReferenceRouting(monkeypatch)
    y, aux = jax.jit(partial(ref_moe.moe_apply, cfg=ref_cfg))(params, x)
    (want_idx,), (want_dest,) = ref_routing.take()

    block = _load(moe.MoE(cfg, device="cpu"), params)
    assert block.router.dtype == torch.float32 and (block.shared is not None) == (
        cfg.n_shared_experts > 0)
    port = PortRouting(monkeypatch)
    got, got_aux = moe.moe_apply(block, carry.lm_tensor(np.asarray(x)), cfg)
    (idx,), (dest,), _ = port.take()
    keep = dest < cfg.n_experts * moe.capacity(cfg, b * s)

    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(dest, want_dest)
    np.testing.assert_array_equal(keep, want_dest < cfg.n_experts * moe.capacity(cfg, b * s))
    assert float(got_aux["drop_frac"]) == float(aux["drop_frac"]) == 1.0 - keep.mean()
    assert (float(aux["drop_frac"]) > 0) == (case == "binds")
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(got_aux[k]), float(aux[k]), rtol=1e-5)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_allclose(_np(got), _np(y), **TOL)
    assert np.corrcoef(_np(got).ravel(), _np(y).ravel())[0, 1] > 0.999


def test_dispatch_keeps_token_order_within_an_expert():
    """The stable sort: an expert's slots go to its first ``cap`` tokens
    in token order, the rest to the overflow row ``E·cap``."""
    idx = torch.tensor([[1, 0], [1, 2], [1, 0], [2, 1]])
    counts, keep, dest = moe.dispatch(idx, 3, 2)
    assert counts.tolist() == [2, 4, 2]
    assert dest.tolist() == [2, 0, 3, 4, 6, 1, 5, 6]
    assert keep.tolist() == [True, True, True, True, False, True, True, False]


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------
def _mla_inputs():
    cfg, ref_cfg = _cfgs("deepseek_v2_236b")
    params = fill(jax.eval_shape(partial(ref_mla.mla_init, cfg=ref_cfg), jax.random.PRNGKey(0)),
                  seed=3)
    return cfg, ref_cfg, params, _load(mla.MLA(cfg, device="cpu"), params)


def test_mla_apply_matches_reference():
    cfg, ref_cfg, params, block = _mla_inputs()
    x = _tokens(cfg, 2, 12, False, seed=4)
    out, (ckv, kpe) = jax.jit(partial(ref_mla.mla_apply, cfg=ref_cfg))(params, x)
    got, (gckv, gkpe) = mla.mla_apply(block, carry.lm_tensor(np.asarray(x)), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == out.shape
    np.testing.assert_allclose(_np(gckv), _np(ckv), rtol=2 * BF16_STEP, atol=1e-2)
    np.testing.assert_allclose(_np(gkpe), _np(kpe), rtol=2 * BF16_STEP, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(out), rtol=2 * BF16_STEP, atol=1e-2)


def test_mla_decode_matches_reference():
    """One token at position 9 against the reference's own 16-slot cache
    (random bf16 rows, the slots past 9 included: the mask must hide
    them)."""
    cfg, ref_cfg, params, block = _mla_inputs()
    rng = np.random.default_rng(5)
    cc = jnp.asarray(rng.standard_normal((2, 16, cfg.kv_lora_rank)), jnp.bfloat16)
    ck = jnp.asarray(rng.standard_normal((2, 16, cfg.qk_rope_head_dim)), jnp.bfloat16)
    x = _tokens(cfg, 2, 1, False, seed=6)
    pos = 9
    decode = jax.jit(ref_mla.mla_decode, static_argnums=(2, 5))
    out, ncc, nck = decode(params, x, ref_cfg, cc, ck, pos)
    pcc, pck = carry.lm_tensor(np.asarray(cc)), carry.lm_tensor(np.asarray(ck))
    got, gcc, gck = mla.mla_decode(block, carry.lm_tensor(np.asarray(x)), cfg, pcc, pck, pos)
    assert gcc is pcc and gck is pck  # written in place
    np.testing.assert_allclose(_np(got), _np(out), rtol=2 * BF16_STEP, atol=1e-2)
    np.testing.assert_allclose(_np(gcc), _np(ncc), rtol=2 * BF16_STEP, atol=1e-2)
    np.testing.assert_allclose(_np(gck), _np(nck), rtol=2 * BF16_STEP, atol=1e-2)
    untouched = np.r_[0:pos, pos + 1:16]
    np.testing.assert_array_equal(_np(gcc)[:, untouched], _np(cc)[:, untouched])
    with pytest.raises(IndexError):
        mla.mla_decode(block, carry.lm_tensor(np.asarray(x)), cfg, pcc, pck, 16)


@pytest.mark.parametrize("layout", ["published", "agreeing"])
def test_mla_decode_against_prefill(layout):
    """The absorbed decode of token 8 from the prefill's cache of tokens
    0–7, against the prefill's own output at token 8, in both packages.
    The reference's decode reads ``wukv`` as all heads' nope columns, then
    all heads' v columns; its prefill reads it per head, nope then v
    (`ROADMAP.md` § 3, mirrored): on random weights the two disagree in
    both packages alike; with one block repeated for every head's nope
    and v columns (``agreeing``) both layouts read the same matrices and
    the decode matches the prefill."""
    cfg, ref_cfg, params, block = _mla_inputs()
    if layout == "agreeing":
        w = np.asarray(params["wukv"])
        params = {**params, "wukv": jnp.asarray(np.tile(w[:, :cfg.qk_nope_head_dim],
                                                         (1, 2 * cfg.n_heads)))}
        block = _load(mla.MLA(cfg, device="cpu"), params)
    x = _tokens(cfg, 2, 9, False, seed=7)
    full, (ckv, kpe) = jax.jit(partial(ref_mla.mla_apply, cfg=ref_cfg))(params, x)
    pad = [(0, 0), (0, 7), (0, 0)]  # a 16-slot cache holding tokens 0-7
    cc, ck = jnp.pad(ckv[:, :8], pad), jnp.pad(kpe[:, :8], pad)
    want, _, _ = jax.jit(ref_mla.mla_decode, static_argnums=(2, 5))(
        params, x[:, 8:], ref_cfg, cc, ck, 8)
    got, _, _ = mla.mla_decode(block, carry.lm_tensor(np.asarray(x[:, 8:])), cfg,
                               carry.lm_tensor(np.asarray(cc)), carry.lm_tensor(np.asarray(ck)), 8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 * BF16_STEP, atol=1e-2)
    last = _np(full)[:, 8:]
    corr = np.corrcoef(last.ravel(), _np(want).ravel())[0, 1]
    if layout == "agreeing":
        np.testing.assert_allclose(_np(got), last, **TOL)
        assert corr > 0.999
    else:
        assert corr < 0.5  # another function of the same weights


def test_capacity_matches_reference_expression():
    for arch in MOE_ARCHS:
        for cfg in (configs.get_config(arch), configs.get_smoke(arch)):
            for t in (1, 4, 128, 192, 4096):
                want = max(8, int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))
                assert moe.capacity(cfg, t) == want
            nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            assert all(moe.capacity(nodrop, t) >= t for t in range(1, 300))
