"""The port's recurrent mixers (`repro_torch.models.{rglru,ssd}`) vs the JAX reference.

Held across the two packages, on the CPU, on the same numpy inputs:

  * the RG-LRU's scan alone (`rglru.associative_scan`) on f32 ``(a, u)``
    against `jax.lax.associative_scan` with the reference's combine, at
    lengths 1, 12 and 33 (odd and even levels of the recursion), with and
    without a carried state folded into step 0: ``rtol=1e-5, atol=1e-6``
    (the same products in the same order; XLA may contract ``a'·u + u'``
    into one fused multiply-add);
  * `ssd.ssd_scan` alone on f32 inputs against the reference's, at a
    chunk multiple, at a length below one chunk and padded to a chunk
    multiple with ``dt = 0`` steps as `ssd_apply` pads: ``rtol=1e-4,
    atol=1e-5`` (f32 einsums contracted in another order); and against
    the sequential recurrence that `ssd.ssd_decode` steps, on the port
    alone, at the same tolerance (the reference's "identical math to the
    sequential scan"): the padded steps leave the final state unchanged;
  * `rglru_apply`/`ssd_apply` from a zero state and `rglru_decode`/
    `ssd_decode` from their states, on the reference's weights carried
    bit for bit: bf16 outputs within two bf16 steps and ``atol=1e-2`` (the
    attention tests' rule, `tests/test_torch_lm.py`); the bf16 conv
    rings bit for bit (the block's own bf16 inputs: the input projection
    rounds alike); the f32 states at ``STATE_TOL`` (one bf16 step and
    ``atol=1e-3``): the RG-LRU's state sums gates made from bf16
    block-diagonal products, which the two lowerings' dots round one bf16
    step apart at some elements (up to 4.6e-3 absolute here); the SSD's
    states, whose inputs agree bit for bit, differ by f32 summation order
    alone (under 4e-6);
  * the causal conv bit for bit against the reference's unjitted bf16
    sum, the SiLU and tanh-GELU (`layers.silu`, `layers.gelu`) bit for
    bit against `jax.nn`'s on bf16 inputs, and `layers.softplus` on f32
    within 2 f32 ulps.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import rglru as ref_rglru
from repro.models import ssd as ref_ssd
from repro_torch import carry, configs
from repro_torch.models import layers, rglru, ssd

BF16_STEP = 2.0 ** -7  # one bf16 step relative to the value (8 significant bits)
OUT_TOL = dict(rtol=2 * BF16_STEP, atol=1e-2)
STATE_TOL = dict(rtol=BF16_STEP, atol=1e-3)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
SSD_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _to_port(a):
    return carry.lm_tensor(np.asarray(a))


def _carry(module, ref_params):
    module.load_state_dict({k: _to_port(v) for k, v in carry._flat(ref_params)}, strict=True)
    return module


# --------------------------------------------------------------------------
# the RG-LRU scan
# --------------------------------------------------------------------------
def _ref_comb(l, r):
    return l[0] * r[0], r[0] * l[1] + r[1]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("length", [1, 12, 33])
def test_associative_scan_matches_reference(length, carried):
    rng = np.random.default_rng(length)
    a = rng.uniform(0.5, 1.0, (2, length, 24)).astype(np.float32)
    u = rng.normal(size=(2, length, 24)).astype(np.float32)
    if carried:  # rglru_apply's fold of a carried state into step 0
        u[:, 0] += a[:, 0] * rng.normal(size=(2, 24)).astype(np.float32)
    want_a, want_h = jax.jit(partial(jax.lax.associative_scan, _ref_comb, axis=1))(
        (jnp.asarray(a), jnp.asarray(u)))
    got_a, got_h = rglru.associative_scan(torch.as_tensor(a), torch.as_tensor(u))
    np.testing.assert_allclose(_np(got_a), _np(want_a), **SCAN_TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **SCAN_TOL)
    # the recurrence itself, stepped in f64
    h = np.zeros((2, 24))
    for t in range(length):
        h = a[:, t] * h + u[:, t]
    np.testing.assert_allclose(_np(got_h)[:, -1], h, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the SSD chunked scan
# --------------------------------------------------------------------------
SSD_CASES = {  # name → (L, chunk, true length (the rest padded with dt = 0), H, G)
    "chunk_multiple": (32, 8, 32, 4, 2),
    "below_one_chunk": (6, 16, 6, 4, 1),
    "padded": (24, 8, 19, 4, 2),
}


def _ssd_inputs(length, true_len, h, g, seed=0, p=8, n=6):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(2, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, length, h)))).astype(np.float32)
    bmat = rng.normal(size=(2, length, g, n)).astype(np.float32)
    cmat = rng.normal(size=(2, length, g, n)).astype(np.float32)
    xh[:, true_len:] = dt[:, true_len:] = bmat[:, true_len:] = cmat[:, true_len:] = 0
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32)) * 0.5
    return xh, dt, bmat, cmat, a_log


def _sequential(xh, dt, bmat, cmat, a_log):
    """`ssd.ssd_decode`'s recurrence stepped over the sequence (f32)."""
    b, l, h, p_ = xh.shape
    rep = h // bmat.shape[2]
    bm = torch.repeat_interleave(bmat, rep, dim=2)
    cm = torch.repeat_interleave(cmat, rep, dim=2)
    state = torch.zeros((b, h, p_, bmat.shape[3]))
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * -torch.exp(a_log)[None, :])
        upd = torch.einsum("bhn,bh,bhp->bhpn", bm[:, t], dt[:, t], xh[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", cm[:, t], state))
    return torch.stack(ys, dim=1), state


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_reference(case):
    length, chunk, true_len, h, g = SSD_CASES[case]
    inputs = _ssd_inputs(length, true_len, h, g)
    want_y, want_state = jax.jit(ref_ssd.ssd_scan, static_argnums=5)(
        *map(jnp.asarray, inputs), chunk)
    got_y, got_state = ssd.ssd_scan(*map(torch.as_tensor, inputs), chunk)
    np.testing.assert_allclose(_np(got_y), _np(want_y), **SSD_TOL)
    np.testing.assert_allclose(_np(got_state), _np(want_state), **SSD_TOL)
    # the chunked form is the sequential recurrence; padding adds nothing
    seq_y, seq_state = _sequential(*(torch.as_tensor(a[:, :true_len]) if a.ndim > 1
                                     else torch.as_tensor(a) for a in inputs))
    np.testing.assert_allclose(_np(got_y)[:, :true_len], _np(seq_y), **SSD_TOL)
    np.testing.assert_allclose(_np(got_state), _np(seq_state), **SSD_TOL)


# --------------------------------------------------------------------------
# the blocks on carried weights
# --------------------------------------------------------------------------
def _cfgs(arch):
    return configs.get_smoke(arch), ref_configs.get_smoke(arch)


@pytest.mark.parametrize("length", [1, 12])
@torch.inference_mode()
def test_rglru_matches_reference(length):
    """`rglru_apply` from a zero state (the prefill) and `rglru_decode`
    from its states (one token)."""
    cfg, ref_cfg = _cfgs("recurrentgemma_9b")
    params = ref_rglru.rglru_init(jax.random.PRNGKey(0), ref_cfg)
    mod = _carry(rglru.RGLRU(cfg, device="cpu"), params)
    assert mod.lam.dtype == torch.float32
    rng = np.random.default_rng(1)
    x = _bf16(rng.normal(size=(2, length, cfg.d_model)))
    out, (conv, rec) = jax.jit(ref_rglru.rglru_apply, static_argnums=2)(params, x, ref_cfg)
    got, (gconv, grec) = rglru.rglru_apply(mod, _to_port(x), cfg)
    np.testing.assert_allclose(_np(got), _np(out), **OUT_TOL)
    np.testing.assert_array_equal(_np(gconv), _np(conv))
    np.testing.assert_allclose(_np(grec), _np(rec), **STATE_TOL)
    assert gconv.dtype == torch.bfloat16 and grec.dtype == torch.float32

    x1 = _bf16(rng.normal(size=(2, 1, cfg.d_model)))
    got, (gconv, grec) = rglru.rglru_decode(mod, _to_port(x1), cfg, _to_port(conv),
                                            _to_port(rec))
    out, (conv, rec) = jax.jit(ref_rglru.rglru_decode, static_argnums=2)(
        params, x1, ref_cfg, conv, rec)
    np.testing.assert_allclose(_np(got), _np(out), **OUT_TOL)
    np.testing.assert_array_equal(_np(gconv), _np(conv))
    np.testing.assert_allclose(_np(grec), _np(rec), **STATE_TOL)


def _ssd_params(ref_cfg, seed):
    """The reference's init with ``a_log``, ``d_skip`` and ``dt_bias``
    moved off their constants (log(1..h), ones, zeros)."""
    params = ref_ssd.ssd_init(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(seed)
    h = params["a_log"].shape[0]
    return {**params,
            "a_log": jnp.asarray(params["a_log"] + 0.1 * rng.normal(size=h), jnp.float32),
            "d_skip": jnp.asarray(1.0 + 0.1 * rng.normal(size=h), jnp.float32),
            "dt_bias": jnp.asarray(0.1 * rng.normal(size=h), jnp.float32)}


@pytest.mark.parametrize("length", [5, 21])  # below one chunk; past it, padded
@torch.inference_mode()
def test_ssd_matches_reference(length):
    """`ssd_apply` from a zero state (mamba2-smoke's chunk is 16) and
    `ssd_decode` from its states; a carried ``ssm_state`` in `ssd_apply`
    raises in both packages."""
    cfg, ref_cfg = _cfgs("mamba2_130m")
    params = _ssd_params(ref_cfg, 0)
    mod = _carry(ssd.SSD(cfg, device="cpu"), params)
    assert {mod.a_log.dtype, mod.d_skip.dtype, mod.dt_bias.dtype} == {torch.float32}
    rng = np.random.default_rng(2)
    x = _bf16(rng.normal(size=(2, length, cfg.d_model)))
    out, (conv, st) = jax.jit(ref_ssd.ssd_apply, static_argnums=2)(params, x, ref_cfg)
    got, (gconv, gst) = ssd.ssd_apply(mod, _to_port(x), cfg)
    np.testing.assert_allclose(_np(got), _np(out), **OUT_TOL)
    np.testing.assert_array_equal(_np(gconv), _np(conv))
    np.testing.assert_allclose(_np(gst), _np(st), **STATE_TOL)
    assert gconv.dtype == torch.bfloat16 and gst.dtype == torch.float32

    x1 = _bf16(rng.normal(size=(2, 1, cfg.d_model)))
    got, (gconv, gst) = ssd.ssd_decode(mod, _to_port(x1), cfg, _to_port(conv), _to_port(st))
    out, (conv, st) = jax.jit(ref_ssd.ssd_decode, static_argnums=2)(params, x1, ref_cfg, conv, st)
    np.testing.assert_allclose(_np(got), _np(out), **OUT_TOL)
    np.testing.assert_array_equal(_np(gconv), _np(conv))
    np.testing.assert_allclose(_np(gst), _np(st), **STATE_TOL)

    with pytest.raises(NotImplementedError):
        ssd.ssd_apply(mod, _to_port(x), cfg, ssm_state=gst)
    with pytest.raises(NotImplementedError):
        ref_ssd.ssd_apply(params, x, ref_cfg, ssm_state=st)


def test_conv_is_the_bf16_sum_in_tap_order():
    """The causal conv rounds each product and add to bf16 in tap order
    (the reference's Python ``sum``), which `F.conv1d`'s f32 accumulation
    does not: the two differ on these inputs, and the port equals the
    reference's unjitted sum bit for bit."""
    rng = np.random.default_rng(5)
    conv = _bf16(rng.normal(size=(4, 64)))
    x = _bf16(rng.normal(size=(2, 9, 64)))
    state = _bf16(rng.normal(size=(2, 3, 64)))
    with jax.disable_jit():
        want, want_state = ref_rglru._causal_conv(conv, x, state)
    got, got_state = rglru.causal_conv(_to_port(conv), _to_port(x), _to_port(state))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_state), _np(want_state))
    xp = torch.cat([_to_port(state), _to_port(x)], dim=1).float().transpose(1, 2)
    f32 = torch.nn.functional.conv1d(xp, _to_port(conv).float().t()[:, None, :], groups=64)
    assert not torch.equal(f32.transpose(1, 2).to(torch.bfloat16), got)



@pytest.mark.parametrize("name", ["silu", "gelu", "softplus"])
def test_activations_match_jax_nn(name):
    """`jax.nn`'s SiLU and GELU round each op to bf16 (its bf16 logistic is
    ``1/(1 + e^(−x))`` op by op, its GELU's constants are bf16), which
    `F.silu` and `F.gelu` do not; softplus is f32 in both blocks."""
    x = np.random.default_rng(6).normal(size=(4096,)).astype(np.float32) * 4
    want = getattr(jax.nn, name)(jnp.asarray(x, jnp.float32 if name == "softplus"
                                              else jnp.bfloat16))
    got = getattr(layers, name)(torch.as_tensor(x) if name == "softplus"
                                else _to_port(_bf16(x)))
    if name == "softplus":
        np.testing.assert_allclose(_np(got), _np(want), rtol=2.4e-7, atol=0)
        return
    np.testing.assert_array_equal(_np(got), _np(want))
    x = _to_port(_bf16(x))
    fused = (torch.nn.functional.silu(x) if name == "silu"
             else torch.nn.functional.gelu(x, approximate="tanh"))
    assert not torch.equal(fused, got)  # one rounding gives other bits
