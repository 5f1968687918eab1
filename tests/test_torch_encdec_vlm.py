"""The encoder-decoder (whisper) and VLM (internvl) families of the port vs the JAX reference.

Held across the two packages on the CPU, on the smoke configs, with the
stub frontends' inputs drawn as `launch/serve.py` draws them (normal ×
0.02 in bf16: whisper's (B, enc_positions, d) frame embeddings,
internvl's (B, n_img_tokens, d) image embeddings):

  * the carry (`carry.lm_params`, `carry.lm_cache`, `carry.train_state`)
    bit for bit: every leaf, whisper's stacked ``encoder.layers`` and
    ``cross`` trees unstacked per layer, the prefill's ``cross_k`` and
    ``cross_v`` per decoder layer, and an int8 AdamW state;
  * whisper's encoder (`lm._encode`), then `forward`, `prefill` (its
    logits over internvl's image positions too), three jitted
    `decode_step`s from the port's own cache and from the reference's
    carried one, and `make_prefill_step`, at the reference's tolerance
    for two lowerings of one model (``TOL``, `tests/test_arch_smoke.py`);
  * `lm.loss_fn` and every gradient leaf, in bf16 (loss at 1e-3, leaves
    at 5e-2 relative L2) and in f32 (1e-5, 1e-4), as
    `tests/test_torch_train.py` holds the other families;
  * `launch/serve.main --smoke --device cpu` on the reference's weights:
    the reference's `main`'s greedy tokens, a token apart only at a near
    tie of the logits; and the VLM's cache-length refusal on both sides
    (the reference fails in its prefill, the port's `main` raises a
    `ValueError` naming the length), beside the one design difference: a
    decode past the cache, which the reference clamps to its last slot
    and the port refuses (`ROADMAP.md` § 3);

and on the port alone: decoding matches the full forward on its own init
for both models, and `launch/train.py` refuses both families (the token
plane gives no frames or images).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.train import optimizer as ref_opt
from repro.train import steps as ref_steps
from repro_torch import carry, configs
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import steps, tree
from test_torch_lm import TOL, _close, reference_params
import torch_threads

torch_threads.cap_under_xdist()

ARCHS = ("whisper_small", "internvl2_26b")
B, S, GEN = 2, 12, 3
# the reference's stacked trees (by their flattened path) → the port's lists
STACKS = {"slots/0": "blocks", "encoder/layers": "encoder/layers", "cross": "cross"}


def _extras(cfg, rng, b=B) -> dict:
    """`serve.draw_extras`'s numpy draw: the family's stub input, f64."""
    if cfg.family == "vlm":
        return {"img_embeds": rng.normal(size=(b, cfg.n_img_tokens, cfg.d_model)) * 0.02}
    return {"enc_frames": rng.normal(size=(b, cfg.enc_positions, cfg.d_model)) * 0.02}


def _ref_extras(extras):
    return {k: jnp.asarray(v, jnp.bfloat16) for k, v in extras.items()}


def _port_extras(extras):
    return {k: carry.lm_tensor(v) for k, v in _ref_extras(extras).items()}


def _port_paths(ref_tree) -> dict:
    """The reference's tree flattened (`train.tree.flatten` paths) with
    its stacked leaves split per layer into the port's paths."""
    out = {}
    for path, a in tree.flatten(ref_tree).items():
        for ref_prefix, port_prefix in STACKS.items():
            if path.startswith(ref_prefix + "/"):
                rest = path[len(ref_prefix) + 1:]
                out.update({f"{port_prefix}/{i}/{rest}": np.asarray(a)[i]
                            for i in range(np.asarray(a).shape[0])})
                break
        else:
            out[path] = np.asarray(a)
    return out


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32, 1: torch.int8}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 1: np.int8}[a.dtype.itemsize])


@pytest.fixture(scope="module")
def reference_runs():
    """arch → the reference's weights, tokens, extras, encoder output,
    forward and prefill logits, prefill cache and three greedy jitted
    decode steps."""
    runs = {}

    def run(arch):
        if arch in runs:
            return runs[arch]
        cfg = ref_configs.get_smoke(arch)
        params = reference_params(cfg, seed=0)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, cfg.vocab, (B, S))
        extras = _extras(cfg, rng)
        t, ex = jnp.asarray(toks, jnp.int32), _ref_extras(extras)
        full, _ = jax.jit(partial(ref_lm.forward, cfg))(params, t, **ex)
        max_len = serve.prefix_len(cfg) + S + GEN
        pf, cache = jax.jit(partial(ref_lm.prefill, cfg), static_argnums=2)(
            params, t, max_len, **ex)
        first_cache = jax.tree.map(np.asarray, cache)
        step = jax.jit(ref_steps.make_serve_step(cfg))
        tok, steps_out = jnp.argmax(pf[:, -1:], axis=-1).astype(jnp.int32), []
        for i in range(GEN):
            logits, cache = step(params, cache, tok, serve.prefix_len(cfg) + S + i)
            steps_out.append((np.asarray(tok), np.asarray(logits, np.float32)))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        enc = None
        if cfg.family == "encdec":
            enc = np.asarray(jax.jit(partial(ref_lm._encode, cfg))(params, ex["enc_frames"]),
                             np.float32)
        runs[arch] = dict(params=jax.tree.map(np.asarray, params), tokens=toks, extras=extras,
                          encoded=enc, forward=np.asarray(full, np.float32),
                          prefill=np.asarray(pf, np.float32), cache=first_cache,
                          steps=steps_out, max_len=max_len)
        return runs[arch]

    return run


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_is_bit_exact(arch, reference_runs):
    """Every leaf of `lm.param_tree` against the reference's tree split per
    layer (whisper: ``encoder/layers/i``, ``encoder/norm``,
    ``encoder/pos``, ``cross/i/{norm,attn}``), then the prefill's
    per-layer cache (whisper: ``cross_k``/``cross_v`` beside K/V)."""
    cfg = configs.get_smoke(arch)
    ref = reference_runs(arch)
    model = carry.lm_params(ref["params"], cfg, "cpu")
    got = tree.flatten(lm.param_tree(model))
    want = _port_paths(ref["params"])
    assert got.keys() == want.keys()
    if cfg.family == "encdec":
        assert {"encoder/pos", "encoder/norm/scale", "cross/1/attn/wk",
                f"encoder/layers/{cfg.n_enc_layers - 1}/mix/wq"} <= got.keys()
    for path, a in want.items():
        assert str(got[path].dtype).split(".")[1] == a.dtype.name, path
        np.testing.assert_array_equal(_bits(got[path]), _bits(a), err_msg=path)
    cache = carry.lm_cache(ref["cache"], cfg, "cpu")
    names = {"k", "v", "cross_k", "cross_v"} if cfg.family == "encdec" else {"k", "v"}
    assert len(cache) == cfg.n_layers and all(set(c) == names for c in cache)
    for i, c in enumerate(cache):
        for k in ("k", "v"):
            np.testing.assert_array_equal(_bits(c[k]), _bits(ref["cache"]["slots"][0][k][i]))
        for k in names - {"k", "v"}:
            assert c[k].shape == (B, cfg.enc_positions, cfg.n_kv_heads, cfg.d_head)
            np.testing.assert_array_equal(_bits(c[k]), _bits(ref["cache"][k][i]))


def test_encoder_matches_reference(reference_runs):
    cfg = configs.get_smoke("whisper_small")
    ref = reference_runs("whisper_small")
    model = carry.lm_params(ref["params"], cfg, "cpu")
    with torch.inference_mode():
        got = lm._encode(cfg, model, _port_extras(ref["extras"])["enc_frames"])
    assert got.dtype == torch.bfloat16 and got.shape == (B, cfg.enc_positions, cfg.d_model)
    _close(ref["encoded"], got)


@pytest.mark.parametrize("arch", ARCHS)
@torch.inference_mode()
def test_lm_matches_reference(arch, reference_runs):
    cfg = configs.get_smoke(arch)
    ref = reference_runs(arch)
    model = carry.lm_params(ref["params"], cfg, "cpu")
    tokens, extras = torch.as_tensor(ref["tokens"]), _port_extras(ref["extras"])
    logits, aux = lm.forward(cfg, model, tokens, **extras)
    assert logits.shape == (B, S, cfg.vocab)  # the image positions stripped
    assert float(aux["lb_loss"]) == float(aux["z_loss"]) == 0.0
    _close(ref["forward"], logits)
    last = steps.make_prefill_step(cfg)(model, {"tokens": tokens, **extras})
    _close(ref["forward"][:, -1], last)
    pf, cache = lm.prefill(cfg, model, tokens, ref["max_len"], **extras)
    assert pf.shape == (B, serve.prefix_len(cfg) + S, cfg.vocab)
    _close(ref["prefill"], pf)
    for c, k, v in zip(cache, ref["cache"]["slots"][0]["k"], ref["cache"]["slots"][0]["v"]):
        n = serve.prefix_len(cfg) + S
        _close(k[:, :n], c["k"][:, :n])
        _close(v[:, :n], c["v"][:, :n])
    for i, c in enumerate(cache if cfg.family == "encdec" else ()):
        _close(ref["cache"]["cross_k"][i], c["cross_k"])
        _close(ref["cache"]["cross_v"][i], c["cross_v"])
    ref_cache = carry.lm_cache(ref["cache"], cfg, "cpu")
    serve_step = steps.make_serve_step(cfg)
    for i, (tok, want) in enumerate(ref["steps"]):
        tok = torch.tensor(tok, dtype=torch.int64)
        pos = serve.prefix_len(cfg) + S + i
        got, cache = serve_step(model, cache, tok, pos)
        _close(want, got)
        got, ref_cache = lm.decode_step(cfg, model, ref_cache, tok, pos)
        _close(want, got)


@pytest.mark.parametrize("arch", ARCHS)
@torch.inference_mode()
def test_decode_matches_forward(arch):
    """Greedy (prefill + decode) logits == the full forward's over the
    prompt and the generated tokens, with the same extras, on the port's
    own init (the reference's contract, `tests/test_arch_smoke.py`)."""
    cfg = configs.get_smoke(arch)
    model = lm.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)))
    extras = _port_extras(_extras(cfg, rng, b=1))
    pf, cache = lm.prefill(cfg, model, tokens, serve.prefix_len(cfg) + S + 4, **extras)
    seq, outs = tokens, [pf[:, -1]]
    tok = torch.argmax(pf[:, -1:], dim=-1)
    for i in range(4):
        seq = torch.cat([seq, tok], dim=1)
        logits, cache = lm.decode_step(cfg, model, cache, tok, serve.prefix_len(cfg) + S + i)
        outs.append(logits[:, 0])
        tok = torch.argmax(logits, dim=-1)
    full, _ = lm.forward(cfg, model, seq, **extras)
    for i, got in enumerate(outs):
        _close(full[:, S - 1 + i], got)


LOSS_CASES = {  # name → (arch, dtype of the weights and activations)
    "whisper-bf16": ("whisper_small", "bf16"),
    "whisper-f32": ("whisper_small", "f32"),
    "internvl-bf16": ("internvl2_26b", "bf16"),
    "internvl-f32": ("internvl2_26b", "f32"),
}
GRAD_TOL = {"bf16": 5e-2, "f32": 1e-4}  # `tests/test_torch_train.py`
LOSS_TOL = {"bf16": 1e-3, "f32": 1e-5}


def _rel_l2(got, want):
    got = got.float().numpy().ravel().astype(np.float64)
    want = np.asarray(want, np.float32).ravel().astype(np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_fn_matches_reference(case, monkeypatch):
    """The weighted loss over the batch's extras and every gradient leaf
    on the reference's weights; the f32 cases run both packages with f32
    weights and activations (each module's ``DTYPE`` set to f32)."""
    arch, dtype = LOSS_CASES[case]
    ref_cfg, cfg = ref_configs.get_smoke(arch), configs.get_smoke(arch)
    params = reference_params(ref_cfg, seed=0)
    if dtype == "f32":
        for mod in (ref_layers, ref_lm):
            monkeypatch.setattr(mod, "DTYPE", jnp.float32)
        monkeypatch.setattr(lm, "DTYPE", torch.float32)
        params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (4, 17))
    weights = rng.uniform(0.2, 2.0, 4).astype(np.float32)
    extras = _extras(cfg, rng, b=4)
    ref_batch = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                 "targets": jnp.asarray(toks[:, 1:], jnp.int32),
                 "loss_weights": jnp.asarray(weights), **_ref_extras(extras)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        partial(ref_lm.loss_fn, ref_cfg), has_aux=True))(params, ref_batch)
    model = carry.lm_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    if dtype == "f32":
        model = model.float()
    params_tree = lm.param_tree(model.requires_grad_(True))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]), "targets": torch.as_tensor(toks[:, 1:]),
             "loss_weights": torch.as_tensor(weights), **_port_extras(extras)}
    got, aux = lm.loss_fn(cfg, model, batch)
    np.testing.assert_allclose(got.item(), float(loss), rtol=LOSS_TOL[dtype])
    np.testing.assert_allclose(aux["ce"].item(), float(metrics["ce"]), rtol=LOSS_TOL[dtype])
    paths, leaves = zip(*tree.flatten(params_tree).items())
    want = _port_paths(grads)
    assert set(paths) == set(want)
    for path, g in zip(paths, torch.autograd.grad(got, leaves)):
        assert _rel_l2(g, want[path]) <= GRAD_TOL[dtype], path


def test_train_state_carries_encoder_and_cross():
    """`carry.train_state` of a whisper-smoke int8 AdamW state after one
    update (nonzero moments, ``(q, scale)`` pairs): the tree of
    `lm.param_tree`, ``encoder/layers/i`` and ``cross/i`` included, every
    leaf bit for bit."""
    ref_cfg, cfg = ref_configs.get_smoke("whisper_small"), configs.get_smoke("whisper_small")
    ocfg = ref_opt.AdamWConfig(state_dtype="int8")
    params = reference_params(ref_cfg, seed=2)
    _, state, _ = jax.jit(partial(ref_opt.apply_updates, ocfg))(
        params, reference_params(ref_cfg, seed=3), ref_opt.init_state(ocfg, params))
    np_params, np_state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    model = carry.lm_params(np_params, cfg, "cpu")
    port_state = carry.train_state(np_params, np_state, cfg, "cpu")
    fresh = opt.init_state(opt.AdamWConfig(state_dtype="int8"), lm.param_tree(model))
    assert tree.flatten(port_state).keys() == tree.flatten(fresh).keys()
    for mv in ("m", "v"):
        got = tree.flatten(port_state[mv])
        want = _port_paths(np_state[mv])
        assert got.keys() == want.keys()
        assert "cross/1/attn/wo/0" in got and "encoder/layers/1/ffn/wi/1" in got
        for path, a in want.items():
            np.testing.assert_array_equal(_bits(got[path]), _bits(a), err_msg=path)


# --------------------------------------------------------------------------
# the entry point
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-26b"])
def test_main_matches_reference_tokens(arch, monkeypatch, capsys):
    """Both `main`s at ``--smoke --batch 2 --prompt-len 8 --gen 3`` (and
    internvl's cache of image, prompt and gen): the port's on the
    reference's own `PRNGKey(0)` weights, the prompts and extras each
    draws from ``--seed``.  A row's greedy token may differ only where the
    port's top-2 logits lie within the tolerance of each other (a near
    tie that the two lowerings' bf16 rounding can break either way:
    `test_torch_serve_launch.test_serve_loop_matches_reference_tokens`'s
    rule); after it the row follows other tokens and is not compared."""
    cfg = configs.get_smoke(arch)
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "3",
            "--max-len", str(serve.prefix_len(cfg) + 8 + 3)]
    made = {}
    real_init = ref_serve.lm.init_params
    monkeypatch.setattr(ref_serve.lm, "init_params",
                        lambda c, key: made.setdefault("params", real_init(c, key)))
    want = ref_serve.main(argv)
    ref_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(lm, "init_params", lambda c, g, d: carry.lm_params(
        jax.tree.map(np.asarray, made["params"]), c, d))
    run = serve.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ref_out[0] == f"arch={cfg.name} batch=2 prompt=8 gen=3"
    assert set(run.extras) == {"img_embeds" if cfg.family == "vlm" else "enc_frames"}
    assert run.served.prefill_logits.shape == (2, serve.prefix_len(cfg) + 8, cfg.vocab)
    got = run.served.tokens
    assert got.shape == want.shape == (2, 4)
    seen = [run.served.prefill_logits[:, -1]] + [s[:, 0] for s in run.served.step_logits]
    top2 = torch.stack(seen, dim=1).float().topk(2, dim=-1).values.numpy()
    inside = top2[..., 0] - top2[..., 1] <= TOL["atol"] + TOL["rtol"] * np.abs(top2[..., 0])
    compared = 0
    for row in range(2):
        for t in range(4):
            if got[row, t] != want[row, t]:
                assert inside[row, t], (row, t)
                break
            compared += 1
    assert compared >= 4


def test_vlm_cache_length_and_decode_past_it(reference_runs):
    """The reference's default cache (prompt + gen + 8 positions) cannot
    hold internvl's image prefix: its prefill fails, and the port's `main`
    refuses with the length needed.  A decode past a full cache (as the
    reference's `tests/test_arch_smoke.py::test_prefill_decode` runs
    internvl-smoke: 24 positions in 24 slots, then decode steps) is
    clamped by the reference into the last slot and refused by the port
    (`ROADMAP.md` § 3, a design difference)."""
    argv = ["--arch", "internvl2-26b", "--smoke", "--batch", "1", "--prompt-len", "8",
            "--gen", "2"]
    with pytest.raises(TypeError, match="dynamic_update_slice"):
        ref_serve.main(argv)
    with pytest.raises(ValueError, match="--max-len 26 or more"):
        serve.main([*argv, "--device", "cpu"])

    ref_cfg, cfg = ref_configs.get_smoke("internvl2_26b"), configs.get_smoke("internvl2_26b")
    ref = reference_runs("internvl2_26b")
    tok, _ = ref["steps"][0]
    past = ref["max_len"]  # the cache's slots are 0 .. max_len - 1
    logits, _ = jax.jit(ref_steps.make_serve_step(ref_cfg))(
        jax.tree.map(jnp.asarray, ref["params"]), jax.tree.map(jnp.asarray, ref["cache"]),
        jnp.asarray(tok), past)
    assert np.isfinite(np.asarray(logits, np.float32)).all()  # clamped, not refused
    model = carry.lm_params(ref["params"], cfg, "cpu")
    cache = carry.lm_cache(ref["cache"], cfg, "cpu")
    with torch.inference_mode(), pytest.raises(IndexError, match=f"past the cache's {past} slots"):
        lm.decode_step(cfg, model, cache, torch.tensor(tok, dtype=torch.int64), past)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-26b"])
def test_train_main_refuses(arch, tmp_path):
    """The token plane gives no frames or images (the reference's trainer
    fails in `_encode(..., None)` for whisper): the refusal names the
    entry point that trains these families."""
    with pytest.raises(NotImplementedError, match=r"make_train_step takes batches that carry"):
        train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
