"""`repro_torch.launch.serve` (both modes) vs the reference's `repro.launch.serve`.

  * LM mode: the port's decode loop (`serve_loop`) on weights carried
    from the reference gives the reference loop's greedy tokens
    (`repro/launch/serve.py`'s prefill, then its jitted serve step) on
    the qwen smoke config.  A token may differ only where the reference's
    top-2 logit margin lies inside the logits' tolerance (``rtol=5e-2,
    atol=5e-2`` of the top logit): a near tie that the two lowerings'
    bf16 rounding can break either way (`ROADMAP.md` § 3 records the one
    this seed shows).  After a row diverges its later tokens follow other
    prompts and are not compared.
  * ``--aqp`` at 16 × 256 with 4 queries prints the reference's
    ``mean reads`` and ``modes``.
  * ``main`` in LM mode on the CPU prints the reference's two lines (the
    qwen smoke config, and mixtral-smoke for the MoE family, rg-smoke for
    the hybrid and mamba2-smoke for the SSM, whose tokens a second run
    repeats); a ``cuda`` request without a GPU raises in both modes.
"""
import argparse
import dataclasses
import re
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.launch import serve as ref_serve
from repro.models import lm as ref_lm
from repro.train import steps as ref_steps
from repro_torch import carry
from repro_torch.configs import get_smoke
from repro_torch.launch import serve

RTOL = ATOL = 5e-2  # `tests/test_arch_smoke.py::test_decode_matches_forward`


def _reference_loop(cfg, params, prompts, gen, max_len):
    """`repro/launch/serve.py`'s loop (lines 204-220) on given weights;
    returns the tokens (B, 1 + gen) and the logits each token came from."""
    logits, cache = jax.jit(partial(ref_lm.prefill, cfg), static_argnums=2)(
        params, jnp.asarray(prompts, jnp.int32), max_len)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    serve_step = jax.jit(ref_steps.make_serve_step(cfg))
    out, seen = [tok], [logits[:, -1]]
    for i in range(gen):
        logits, cache = serve_step(params, cache, tok, jnp.asarray(prompts.shape[1] + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out.append(tok)
        seen.append(logits[:, 0])
    tokens = np.concatenate([np.asarray(t) for t in out], axis=1)
    return tokens, np.stack([np.asarray(s, np.float32) for s in seen], axis=1)


def test_serve_loop_matches_reference_tokens():
    arch, b, s, gen = "qwen1_5_0_5b", 4, 32, 16
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    params = jax.jit(partial(ref_lm.init_params, ref_cfg))(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (b, s))
    want, logits = _reference_loop(ref_cfg, params, prompts, gen, s + gen + 8)

    model = carry.lm_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    got = serve.serve_loop(cfg, model, torch.as_tensor(prompts), gen, s + gen + 8).tokens
    assert got.shape == want.shape == (b, gen + 1)

    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    inside = margin <= ATOL + RTOL * np.abs(top2[..., 1])
    compared, diverged = 0, []
    for row in range(b):
        for t in range(gen + 1):
            if got[row, t] != want[row, t]:
                assert inside[row, t], (row, t, margin[row, t])
                diverged.append((row, t, float(margin[row, t])))
                break
            compared += 1
    # each divergence is a near tie of the reference's logits (this seed
    # shows one, an exact bf16 tie: ROADMAP.md § 3)
    assert compared >= 3 * (gen + 1), diverged


def _aqp_line(text):
    line = next(li for li in text.splitlines() if "mean reads" in li)
    return re.search(r"mean reads .*$", line).group(0)


def test_aqp_main_matches_reference(capsys):
    args = ["--partitions", "16", "--rows", "256", "--queries", "4"]
    assert serve.main(["--aqp", "--device", "cpu", *args]) is None
    port = _aqp_line(capsys.readouterr().out)
    ns = argparse.Namespace(dataset="tpch", partitions=16, rows=256, seed=0, error_bound=0.05,
                            queries=4)
    ref_serve.aqp_main(ns)
    ref = _aqp_line(capsys.readouterr().out)
    assert port == ref  # "mean reads 15.8/16; modes {'exact': 4}" at this size


def test_main_lm_mode_on_cpu(capsys):
    run = serve.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--gen", "3",
                      "--batch", "2", "--prompt-len", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=qwen-smoke batch=2 prompt=8 gen=3"
    assert re.fullmatch(r"prefill \d+ms; decode \d+ms \([\d.]+ tok/s\); sample: \[.*\]", out[1])
    assert run.served.tokens.shape == (2, 4)
    assert run.served.prefill_logits.shape == (2, 8, run.cfg.vocab)
    assert len(run.served.step_logits) == 3
    assert all(p.device.type == "cpu" for p in run.model.parameters())
    again = serve.serve_loop(run.cfg, run.model, run.prompts, 3, 8 + 3 + 8)
    np.testing.assert_array_equal(again.tokens, run.served.tokens)
    assert dataclasses.asdict(run.cfg) == dataclasses.asdict(ref_get_smoke("qwen1.5-0.5b"))


def test_main_moe_mode_on_cpu(capsys):
    """The MoE family through the entry point: mixtral-smoke (experts, a
    sliding window), its greedy tokens the same on a second run."""
    run = serve.main(["--arch", "mixtral-8x22b", "--smoke", "--device", "cpu", "--gen", "3",
                      "--batch", "2", "--prompt-len", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=mixtral-smoke batch=2 prompt=8 gen=3"
    assert run.served.tokens.shape == (2, 4)
    assert all(np.isfinite(s.float().numpy()).all() for s in run.served.step_logits)
    again = serve.serve_loop(run.cfg, run.model, run.prompts, 3, 8 + 3 + 8)
    np.testing.assert_array_equal(again.tokens, run.served.tokens)
    assert dataclasses.asdict(run.cfg) == dataclasses.asdict(ref_get_smoke("mixtral-8x22b"))


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m"])
def test_main_recurrent_mode_on_cpu(arch, capsys):
    """The hybrid (RG-LRU blocks, local MQA attention, a ragged tail) and
    the SSM through the entry point, with no extras: finite logits, and
    the same greedy tokens on a second run."""
    run = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--gen", "3",
                      "--batch", "2", "--prompt-len", "8"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={run.cfg.name} batch=2 prompt=8 gen=3"
    assert run.served.tokens.shape == (2, 4)
    assert run.served.prefill_logits.shape == (2, 8, run.cfg.vocab)
    assert all(np.isfinite(s.float().numpy()).all() for s in run.served.step_logits)
    again = serve.serve_loop(run.cfg, run.model, run.prompts, 3, 8 + 3 + 8)
    np.testing.assert_array_equal(again.tokens, run.served.tokens)
    assert dataclasses.asdict(run.cfg) == dataclasses.asdict(ref_get_smoke(arch))


@pytest.mark.parametrize("argv", [["--smoke"], ["--aqp"]], ids=["lm", "aqp"])
def test_cuda_request_without_gpu_raises(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([*argv, "--device", "cuda"])
