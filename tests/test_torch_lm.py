"""The port's LM substrate (`repro_torch.models`, `configs`) vs the JAX reference.

Held across the two packages, on the CPU:

  * the config registry: every arch's full and smoke config field for
    field, with equal parameter counts and applicable shapes;
  * the carry (`carry.lm_params`, `carry.lm_cache`) bit for bit;
  * `rope`, `rmsnorm`, `chunked_attention` and `attn_decode` on the same
    numpy inputs, within one or two bf16 steps (their f32 internals agree
    up to summation order and the f32 transcendentals);
  * `forward`, `prefill`, three `decode_step`s and `make_prefill_step` on
    the same weights (numpy, in the reference's param pytree) for the
    dense smoke configs (and one with a sliding window, prompt ≤ window),
    the MoE smoke configs (mixtral: experts and a window; deepseek:
    MLA, a leading dense layer and shared experts), rg-smoke (RG-LRU
    blocks beside local MQA attention, a ragged tail) and mamba2-smoke
    (SSD blocks), at the reference's own tolerance for two lowerings of
    the same model (``rtol=5e-2, atol=5e-2`` and a correlation above
    0.999, `tests/test_arch_smoke.py`; ``atol=0.15`` for the hybrid, whose
    recurrence accumulates bf16 gate noise across layers, as there):
    XLA rounds a fused chain of bf16 ops once, torch once per op; the
    router's ``lb_loss`` and ``z_loss`` at 1e-5 relative.  Both sides'
    routing is captured per MoE call (`test_torch_moe.ReferenceRouting`,
    `PortRouting`): a token routed to another expert set (a near tie of
    the router that the two lowerings' rounding breaks either way) must
    be one that ``FLIPS`` names, and the logits of its row from its
    position on are not compared;
  * the port's own decode-matches-forward contract, on its own init (the
    MoE configs at a capacity that drops nothing: the forward routes
    B·S tokens and a decode step B, and their capacities differ).

The prefill caches (K/V, MLA's pair, the recurrent blocks' conv rings
and f32 states, a ragged tail's zeros) carry bit for bit.  A block kind
that no family has raises `ValueError`, as the reference's does.  The
encoder-decoder and VLM families are held in `test_torch_encdec_vlm.py`.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import config as ref_config
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.train import steps as ref_steps
from repro_torch import carry, configs
from repro_torch.models import config, layers, lm
from repro_torch.train import steps
from test_torch_moe import PortRouting, ReferenceRouting, flipped_tokens

DENSE = ("qwen1_5_0_5b", "yi_6b", "llama3_405b")
MOE = ("mixtral_8x22b", "deepseek_v2_236b")
RECURRENT = ("recurrentgemma_9b", "mamba2_130m")
TOL = dict(rtol=5e-2, atol=5e-2)  # `tests/test_arch_smoke.py::test_decode_matches_forward`
HYBRID_TOL = dict(rtol=5e-2, atol=0.15)  # the same test's atol for the hybrid family
BF16_STEP = 2.0 ** -7  # one bf16 step relative to the value (8 significant bits)


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _to_port(a):
    """The same bits in torch (bf16 by int16 view)."""
    return carry.lm_tensor(np.asarray(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(ref, port, **tol):
    a, b = _np(ref), _np(port)
    np.testing.assert_allclose(b, a, **(tol or TOL))
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999


def _tol(cfg):
    return HYBRID_TOL if cfg.family == "hybrid" else TOL


# --------------------------------------------------------------------------
# the config registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.all_archs())
def test_config_matches_reference(arch):
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_smoke, ref_configs.get_smoke)):
        port, ref = get(arch), ref_get(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert config.applicable_shapes(port) == ref_config.applicable_shapes(ref)
        assert (port.blocks, port.is_moe, port.is_mla, port.attention_free, port.sub_quadratic) \
            == (ref.blocks, ref.is_moe, ref.is_mla, ref.attention_free, ref.sub_quadratic)


def test_registry_matches_reference():
    assert configs.all_archs() == ref_configs.all_archs()
    assert config.SHAPES == {k: config.ShapeSpec(**dataclasses.asdict(v))
                             for k, v in ref_config.SHAPES.items()}
    # dashed public ids resolve as the reference's do
    for public in ("qwen1.5-0.5b", "yi-6b", "llama3-405b", "mixtral-8x22b"):
        assert configs.get_config(public).name == ref_configs.get_config(public).name


def test_unknown_block_kind_raises():
    """The reference's ``_mix_init`` raises `ValueError` on a kind it does
    not know; so does the port's `Block`, before drawing any weight."""
    cfg = dataclasses.replace(configs.get_smoke("qwen1_5_0_5b"), block_pattern=("attn", "mlp"))
    ref_cfg = dataclasses.replace(ref_configs.get_smoke("qwen1_5_0_5b"),
                                  block_pattern=("attn", "mlp"))
    with pytest.raises(ValueError, match="mlp"):
        ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="mlp"):
        lm.LM(cfg, torch.Generator().manual_seed(0), device="cpu")


# --------------------------------------------------------------------------
# the layers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_and_rmsnorm_match_reference(theta):
    rng = np.random.default_rng(0)
    x = _bf16(rng.normal(size=(2, 9, 3, 16)))
    pos = np.broadcast_to(np.arange(40, 49), (2, 9))
    got = layers.rope(_to_port(x), torch.as_tensor(pos), theta)
    want = ref_layers.rope(x, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP, atol=1e-6)

    scale = _bf16(rng.normal(size=(16,)))
    norm = layers.RMSNorm(16, device="cpu")
    norm.scale.copy_(_to_port(scale))
    got = layers.rmsnorm(norm, _to_port(x), 1e-5)
    want = ref_layers.rmsnorm({"scale": scale}, x, 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_STEP, atol=1e-6)


ATTN_CASES = {  # name → (Sq, Sk, H, K, kwargs of chunked_attention)
    "causal": (12, 12, 4, 4, {}),
    "window": (12, 12, 4, 4, dict(window=5)),
    "gqa": (12, 12, 4, 2, {}),
    "q_offset": (4, 12, 4, 2, dict(q_offset=8)),
    "small_chunks": (10, 10, 4, 2, dict(opts=layers.AttnOptions(4, 4, True))),
    "full_no_skip": (10, 10, 4, 2, dict(causal=False, opts=layers.AttnOptions(4, 4, False))),
    # a row that the mask covers whole in a visited kv chunk is NaN in both
    # packages (`ROADMAP.md` § 3, shared with the reference): a q chunk
    # wider than the kv chunk, and a window that starts inside a kv chunk
    "nan_wide_q_chunk": (16, 16, 4, 2, dict(opts=layers.AttnOptions(8, 4, True))),
    "nan_window": (10, 10, 4, 2, dict(window=4, opts=layers.AttnOptions(4, 4, True))),
}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_matches_reference(case):
    sq, sk, h, kh, kw = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    q = _bf16(rng.normal(size=(2, sq, h, 16)))
    k = _bf16(rng.normal(size=(2, sk, kh, 16)))
    v = _bf16(rng.normal(size=(2, sk, kh, 16)))
    ref_kw = dict(kw)
    if "opts" in kw:
        o = kw["opts"]
        ref_kw["opts"] = ref_layers.AttnOptions(o.q_chunk, o.kv_chunk, o.triangle_skip)
    got = _np(layers.chunked_attention(_to_port(q), _to_port(k), _to_port(v), **kw))
    want = _np(jax.jit(partial(ref_layers.chunked_attention, **ref_kw))(q, k, v))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() == case.startswith("nan_")
    np.testing.assert_allclose(got, want, rtol=2 * BF16_STEP, atol=1e-2)


@pytest.mark.parametrize("window", [0, 6])
def test_attn_decode_matches_reference(window):
    """One token against a filled cache; ``window`` 6 is a ring of 6 slots
    that has wrapped (position 9 at slot 3)."""
    cfg = dataclasses.replace(configs.get_smoke("llama3_405b"), window=window, qkv_bias=True)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke("llama3_405b"), window=window,
                                  qkv_bias=True)
    rng = np.random.default_rng(2)
    p = ref_layers.attn_init(jax.random.PRNGKey(0), ref_cfg)
    p = {**p, **{b: _bf16(rng.normal(size=p[b].shape) * 0.1) for b in ("bq", "bk", "bv")}}
    attn = layers.Attention(cfg, device="cpu")
    for name, a in p.items():
        getattr(attn, name).copy_(_to_port(a))
    s_max = window or 16
    ck = _bf16(rng.normal(size=(2, s_max, cfg.n_kv_heads, cfg.d_head)))
    cv = _bf16(rng.normal(size=(2, s_max, cfg.n_kv_heads, cfg.d_head)))
    x = _bf16(rng.normal(size=(2, 1, cfg.d_model)))
    pos = 9
    decode = jax.jit(ref_layers.attn_decode, static_argnums=2, static_argnames="window")
    out, nk, nv = decode(p, x, ref_cfg, ck, cv, pos, window=window)
    pk, pv = _to_port(ck), _to_port(cv)
    got, gk, gv = layers.attn_decode(attn, _to_port(x), cfg, pk, pv, pos, window=window)
    assert gk is pk and gv is pv  # written in place
    np.testing.assert_allclose(_np(got), _np(out), rtol=2 * BF16_STEP, atol=1e-2)
    np.testing.assert_allclose(_np(gk), _np(nk), rtol=BF16_STEP, atol=1e-6)
    np.testing.assert_array_equal(_np(gv), _np(nv))


# --------------------------------------------------------------------------
# the model on the reference's weights
# --------------------------------------------------------------------------
MODELS = DENSE + ("llama3_405b+window",) + MOE + RECURRENT


def _cfgs(name):
    arch, _, variant = name.partition("+")
    cfg, ref_cfg = configs.get_smoke(arch), ref_configs.get_smoke(arch)
    if variant == "window":  # a ring of 14 slots: the third decode step wraps
        cfg, ref_cfg = (dataclasses.replace(c, window=14) for c in (cfg, ref_cfg))
    return cfg, ref_cfg


def reference_params(cfg, seed):
    """The reference's param pytree (`lm.param_shapes`) filled from numpy:
    normal × 1/sqrt(fan_in) weights (the embedding's fan-in is d), norm
    scales about 1 and small biases, so that no weight is a plain 0 or 1.
    The recurrent blocks' 1-D leaves take the reference's own ranges:
    ``lam`` U[2, 4), ``a_log`` about log(1..h), ``d_skip`` about 1 and a
    small ``dt_bias`` (dt stays positive, every decay below 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name = path[-1].key
        if name == "scale" or name == "d_skip":
            a = 1.0 + 0.1 * rng.standard_normal(spec.shape)
        elif name in ("bq", "bk", "bv", "dt_bias"):
            a = 0.1 * rng.standard_normal(spec.shape)
        elif name == "lam":
            a = rng.uniform(2.0, 4.0, spec.shape)
        elif name == "a_log":
            a = np.log(np.arange(1, spec.shape[-1] + 1)) + 0.1 * rng.standard_normal(spec.shape)
        else:
            fan_in = spec.shape[-1] if name == "table" else spec.shape[-2]
            a = rng.standard_normal(spec.shape) / np.sqrt(fan_in)
        return jnp.asarray(a, spec.dtype)

    return jax.tree_util.tree_map_with_path(leaf, ref_lm.param_shapes(cfg))


# Models held to the reference compiled with XLA's excess precision off,
# so that it rounds each bf16 op as its op-by-op run and torch do (a
# fused chain otherwise rounds once): mamba2-smoke's default jitted
# forward is farther from its own op-by-op run than ``TOL`` (3 of 12,288
# logits outside, 0.078 apart), where the port's forward equals the
# op-by-op run bit for bit and this compile within 1e-6 (`ROADMAP.md`
# § 3).
ROUND_EACH_OP = ("mamba2_130m",)


def _ref_jit(name, fn, static_argnums=()):
    """``fn`` jitted (called with its dynamic arguments after the first
    call's static ones), compiled per call without excess precision for
    the models of ``ROUND_EACH_OP``."""
    jitted = jax.jit(fn, static_argnums=static_argnums)
    if name not in ROUND_EACH_OP:
        return jitted

    def call(*args):
        compiled = jitted.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
        return compiled(*(a for i, a in enumerate(args) if i not in static_argnums))

    return call


@pytest.fixture(scope="module")
def reference_runs():
    """name → the reference's weights, tokens, forward/prefill logits and
    aux, three greedy decode steps (jitted: one compile each; `_ref_jit`)
    and the routing of every MoE call of each (``routing``: ``forward``,
    ``prefill`` and one list per step)."""
    runs = {}

    def run(name):
        if name in runs:
            return runs[name]
        _, cfg = _cfgs(name)
        params = reference_params(cfg, seed=0)
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))
        t = jnp.asarray(toks, jnp.int32)
        with pytest.MonkeyPatch.context() as mp:
            spy = ReferenceRouting(mp)
            full, aux = _ref_jit(name, partial(ref_lm.forward, cfg))(params, t)
            routing = {"forward": spy.take()[0]}
            pf, cache = _ref_jit(name, partial(ref_lm.prefill, cfg), (2,))(params, t, 20)
            routing["prefill"] = spy.take()[0]
            first_cache = jax.tree.map(np.asarray, cache)
            step = _ref_jit(name, ref_steps.make_serve_step(cfg))
            tok, steps_out = jnp.argmax(pf[:, -1:], axis=-1).astype(jnp.int32), []
            routing["steps"] = []
            for i in range(3):
                logits, cache = step(params, cache, tok, 12 + i)
                steps_out.append((np.asarray(tok), logits))
                routing["steps"].append(spy.take()[0])
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        runs[name] = dict(params=jax.tree.map(np.asarray, params), tokens=toks, forward=full,
                          aux=jax.tree.map(float, aux), prefill=pf, cache=first_cache,
                          steps=steps_out, routing=routing)
        return runs[name]

    return run


def _layer_caches(ref_cache):
    """The reference's cache as per-layer dicts in the port's layer order:
    ``lead`` first, then unit u's slot j (``slots[j][name][u]``) at layer
    ``u·period + j``, the ragged tail's padded slots included."""
    slots = ref_cache["slots"]
    n_units = next(iter(slots[0].values())).shape[0]
    return list(ref_cache.get("lead", [])) + [
        {k: v[u] for k, v in slots[j].items()} for u in range(n_units) for j in range(len(slots))]


CACHE_NAMES = {"rglru": {"conv", "rec"}, "ssd": {"conv", "ssm"}}


def _bits(a):
    """An array's bits as integers (bf16 and f32 alike)."""
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32}[a.element_size()]).numpy()
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("name", DENSE + MOE + RECURRENT)
def test_carry_is_bit_exact(name, reference_runs):
    """Every leaf: ``slots`` unstacked into blocks, ``lead`` (deepseek's
    leading dense layer), the f32 router, the experts, MLA and the
    recurrent blocks (``lam``, ``a_log``, ``d_skip`` and ``dt_bias`` f32);
    then the prefill's cache (``k``/``v``, MLA's ``ckv``/``kpe``, or the
    conv ring and ``rec``/``ssm`` state), a ragged tail's padded slot
    included."""
    cfg, _ = _cfgs(name)
    ref = reference_runs(name)
    model = carry.lm_params(ref["params"], cfg, "cpu")
    state = model.state_dict(keep_vars=True)
    want = dict(carry._flat({k: v for k, v in ref["params"].items() if k != "slots"}))
    slots = ref["params"]["slots"]
    for j, slot in enumerate(slots):
        for leaf, a in carry._flat(slot):
            for u in range(a.shape[0]):
                want[f"blocks.{u * len(slots) + j}.{leaf}"] = a[u]
    assert set(want) == set(state)
    for key, a in want.items():
        assert str(state[key].dtype).split(".")[1] == a.dtype.name, key
        np.testing.assert_array_equal(_bits(state[key].detach()), _bits(a), err_msg=key)
    if cfg.is_moe:
        assert all(blk.ffn.router.dtype == torch.float32 for blk in model.blocks)
    assert lm.param_bytes(model) == sum(a.nbytes for a in jax.tree.leaves(ref["params"]))
    cache = carry.lm_cache(ref["cache"], cfg, "cpu")
    layers_ = lm._layers(model)
    assert len(cache) == len(layers_) >= cfg.n_layers
    for blk, c, w in zip(layers_, cache, _layer_caches(ref["cache"])):
        names = CACHE_NAMES.get(blk.kind, {"ckv", "kpe"} if cfg.is_mla else {"k", "v"})
        assert set(c) == set(w) == names
        for k in c:
            assert str(c[k].dtype).split(".")[1] == w[k].dtype.name, k
            np.testing.assert_array_equal(_bits(c[k]), _bits(w[k]))


# Tokens that the two packages route to different expert sets, by model:
# (section, MoE call, row, position), the first of each row.  Each is a
# near tie of the router that the lowerings' rounding breaks either way
# (ROADMAP.md § 3): here the reference's second and third experts of
# deepseek-smoke's first MoE layer at row 1, token 4 (experts 2 and 4,
# 0.12852 and 0.12800; the port's 0.127259 and 0.127233).
FLIPS = {"deepseek_v2_236b": [("forward", 0, 1, 4), ("prefill", 0, 1, 4)]}


def _first_flips(ref_calls, port_calls, b, s):
    """Each row's first flipped position (``s`` where none) and the flips
    that start a row's divergence, as (call, row, position); a flip in a
    later layer at or after a row's first is its consequence."""
    first = np.full(b, s)
    flips = []
    for call, tok in flipped_tokens(ref_calls, port_calls):
        row, pos = divmod(tok, s)
        if pos < first[row]:
            first[row] = pos
            flips.append((call, row, pos))
    return first, flips


def _close_rows(want, got, first, **tol):
    """`_close` on the positions (B, S, ...) before each row's first flip."""
    a, b = _np(want), _np(got)
    keep = np.arange(a.shape[1])[None, :] < first[:, None]
    _close(a[keep], b[keep], **tol)


@pytest.mark.parametrize("name", MODELS)
@torch.inference_mode()
def test_lm_matches_reference(name, reference_runs, monkeypatch):
    cfg, _ = _cfgs(name)
    tol = _tol(cfg)
    ref = reference_runs(name)
    b, s = ref["tokens"].shape
    model = carry.lm_params(ref["params"], cfg, "cpu")
    tokens = torch.as_tensor(ref["tokens"])
    port = PortRouting(monkeypatch)
    found = []

    def first_flips(section, ref_calls, n=s):
        first, flips = _first_flips(ref_calls, port.take()[0], b, n)
        found.extend((section, *f) for f in flips)
        return first

    logits, aux = lm.forward(cfg, model, tokens)
    first = first_flips("forward", ref["routing"]["forward"])
    _close_rows(ref["forward"], logits, first, **tol)
    # the router reads hidden states that the lowerings round differently
    # (1e-5 on equal inputs: `tests/test_torch_moe.py`); a flipped token
    # moves the expert counts themselves
    for k in ("lb_loss", "z_loss"):
        if (first == s).all():
            np.testing.assert_allclose(float(aux[k]), ref["aux"][k], rtol=1e-3, atol=0)
        assert (float(aux[k]) == 0.0) == (not cfg.is_moe)
    # the reference's prefill_step is its forward's last row
    last = steps.make_prefill_step(cfg)(model, {"tokens": tokens})
    port.take()
    _close(_np(ref["forward"])[first == s, -1], _np(last)[first == s], **tol)
    pf, cache = lm.prefill(cfg, model, tokens, 20)
    first = first_flips("prefill", ref["routing"]["prefill"])
    _close_rows(ref["prefill"], pf, first, **tol)
    # the prefill's cache (a ragged tail's padded slot is skipped and stays
    # zero in both), and decoding from the reference's own cache
    for blk, c, want in zip(lm._layers(model), cache, _layer_caches(ref["cache"])):
        assert set(c) == set(want)
        for k in want:
            if not blk.active:
                assert not want[k].any() and not c[k].any()
            elif blk.kind in CACHE_NAMES:  # a conv ring and an f32 state
                _close(want[k], c[k], **tol)
            else:
                _close_rows(want[k][:, :s], c[k][:, :s], first, **tol)
    ref_cache = carry.lm_cache(ref["cache"], cfg, "cpu")
    serve_step = steps.make_serve_step(cfg)
    own = first == s  # rows whose own prefill cache routed as the reference
    from_ref = np.ones(b, bool)
    for i, (tok, want) in enumerate(ref["steps"]):
        tok = torch.as_tensor(tok, dtype=torch.int64)
        ref_calls = ref["routing"]["steps"][i]
        got, cache = serve_step(model, cache, tok, 12 + i)
        own &= first_flips(f"step {i}", ref_calls, 1) == 1
        _close(_np(want)[own], _np(got)[own], **tol)
        got, ref_cache = lm.decode_step(cfg, model, ref_cache, tok, 12 + i)
        from_ref &= first_flips(f"step {i} (reference cache)", ref_calls, 1) == 1
        _close(_np(want)[from_ref], _np(got)[from_ref], **tol)
    assert found == FLIPS.get(name, []), found
    assert own.any() and from_ref.any()


def _no_drop(cfg):
    """``cfg`` at a capacity factor of E/k: capacity ≥ T for any T tokens."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k) if cfg.is_moe \
        else cfg


def agreeing_wukv(model, cfg):
    """Each MLA layer's ``wukv`` made of its first (kv_lora × nope) block
    repeated for every head's nope and v columns (nope = v), so that the
    absorbed decode's reading of it (all heads' nope, then all heads' v)
    and the prefill's (per head: nope, then v) give the same matrices —
    the two packages' decode otherwise departs from their forward
    (`ROADMAP.md` § 3)."""
    assert cfg.qk_nope_head_dim == cfg.v_head_dim
    for blk in [*model.lead, *model.blocks]:
        w = blk.mix.wukv
        w.copy_(w[:, :cfg.qk_nope_head_dim].repeat(1, 2 * cfg.n_heads))


def fan_in_experts(model):
    """The experts redrawn at 1/sqrt(fan_in) (the test weights' scale).
    The reference's init scales them by 1/sqrt(E), which makes an
    expert's output about 100 times the residual at the smoke widths; the
    lowerings' bf16 rounding of that residual then leaves a few logits
    outside the tolerance in the reference's own decode against its
    forward (1 to 426 of 2,560 over PRNGKey 0 to 3, mixtral-smoke)."""
    for blk in model.blocks:
        for name in ("wi", "wg", "wo"):
            w = getattr(blk.ffn, name)
            w.copy_((w.float() * np.sqrt(w.shape[0] / w.shape[1])).to(w.dtype))


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
@torch.inference_mode()
def test_decode_matches_forward(arch, monkeypatch):
    """Greedy (prefill + decode) logits == the full forward's, on the
    port's own init (the reference's contract, `tests/test_arch_smoke.py`).
    The MoE configs run at a capacity that drops nothing (`_no_drop`):
    capacity follows the token count, which is B·S in the forward and B
    in a decode step, so at the published capacity a forward that drops
    tokens is not what decoding computes; their experts are scaled by
    fan-in (`fan_in_experts`) and deepseek's ``wukv`` has one layout
    (`agreeing_wukv`).  A token that the forward and the decode route
    differently (a near tie of the router) is named in ``FLIPS`` and its
    row is compared only before it; every MoE call drops nothing.  The
    hybrid is held at its ``atol`` of 0.15, as the reference holds it."""
    cfg = _no_drop(configs.get_smoke(arch))
    model = lm.init_params(cfg, torch.Generator().manual_seed(3))
    if cfg.is_moe:
        fan_in_experts(model)
    if cfg.is_mla:
        agreeing_wukv(model, cfg)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab, (1, 12)))
    port = PortRouting(monkeypatch)
    pf, cache = lm.prefill(cfg, model, tokens, 32)
    seq, steps_out = tokens, []
    tok = torch.argmax(pf[:, -1:], dim=-1)
    for i in range(4):
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = lm.decode_step(cfg, model, cache, tok, 12 + i)
        steps_out.append(logits[:, 0])
        tok = torch.argmax(logits, dim=-1)
    served_idx, _, served_aux = port.take()
    full, _ = lm.forward(cfg, model, seq)
    full_idx, _, full_aux = port.take()
    assert all(a["drop_frac"] == 0.0 for a in served_aux + full_aux)
    # the served routing, per MoE layer, as (16, k): 12 prompt tokens, 4 steps
    n = len(full_idx)
    served = [np.concatenate([served_idx[j]] + served_idx[n + j::n]) for j in range(n)]
    first, flips = _first_flips(full_idx, served, 1, 16)
    assert [("decode vs forward", *f) for f in flips] == FLIPS.get(arch + "+own", []), flips
    outs = [pf[:, -1]] + steps_out
    for i, got in enumerate(outs):
        if 11 + i < first[0]:
            _close(full[:, 11 + i], got, **_tol(cfg))
