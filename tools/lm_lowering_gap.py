"""How far two lowerings of one bf16 LM disagree, in the reference and in the port.

The reference holds its prefill to its forward at ``rtol=5e-2, atol=5e-2``
with a correlation above 0.999 (`tests/test_arch_smoke.py`), at smoke
shapes.  This script measures that gap at a config's full width on the
CPU, on one set of weights (the reference's init, carried bit for bit
into the port by `repro_torch.carry.lm_params`): for each package, the
prefill's last logits and ``--gen`` greedy decode steps against the full
forward over prompt and generated tokens (teacher-forced with the
reference's tokens), as the max and mean absolute error, the count of
logits outside the tolerance and the correlation; and the port's forward
against the reference's.  The encoder-decoder and the VLM take their
stub inputs as `launch/serve.py` draws them (after the prompts, from the
seed); ``--layers N`` keeps the first N decoder layers (and as many
encoder layers) at full width.  Needs JAX and both packages; about 30 s
and a few GB for qwen1.5-0.5b or whisper-small, about 10 GB for
internvl2-26b on 2 layers at batch 1:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/lm_lowering_gap.py --arch qwen1.5-0.5b
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/lm_lowering_gap.py --arch internvl2-26b \
        --layers 2 --batch 1
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
from functools import partial

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

RTOL = ATOL = 5e-2


def gap(tag: str, want, got) -> None:
    import numpy as np

    a, b = np.asarray(want, np.float32), np.asarray(got, np.float32)
    err = np.abs(a - b)
    outside = int((~(err <= ATOL + RTOL * np.abs(a))).sum())
    corr = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    print(f"{tag}: max_abs_err {err.max():.4g}, mean {err.mean():.4g}, outside {outside} of "
          f"{a.size} ({outside / a.size:.3%}), correlation {corr:.6f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="the first N decoder (and encoder) layers only; 0 keeps them all")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as ref_get_config
    from repro.models import lm as ref_lm
    from repro.train import steps as ref_steps
    from repro_torch import carry
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    ref_cfg, cfg = ref_get_config(args.arch), get_config(args.arch)
    if args.layers:
        ref_cfg, cfg = (dataclasses.replace(c, n_layers=args.layers,
                                            n_enc_layers=min(c.n_enc_layers, args.layers))
                        for c in (ref_cfg, cfg))
    b, s, gen = args.batch, args.prompt_len, args.gen
    params = jax.jit(partial(ref_lm.init_params, ref_cfg))(jax.random.PRNGKey(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (b, s))
    port_extras = serve.draw_extras(cfg, rng, b, "cpu")
    extras = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in port_extras.items()}
    pos0 = serve.prefix_len(cfg) + s

    pf, cache = jax.jit(partial(ref_lm.prefill, ref_cfg), static_argnums=2)(
        params, jnp.asarray(prompts, jnp.int32), pos0 + gen, **extras)
    step = jax.jit(ref_steps.make_serve_step(ref_cfg))
    tok = jnp.argmax(pf[:, -1:], axis=-1).astype(jnp.int32)
    toks, ref_steps_out = [np.asarray(tok)], []
    for i in range(gen):
        logits, cache = step(params, cache, tok, jnp.asarray(pos0 + i))
        ref_steps_out.append(np.asarray(logits[:, 0], np.float32))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    seq = np.concatenate([prompts] + toks[:-1], axis=1)
    ref_full, _ = jax.jit(partial(ref_lm.forward, ref_cfg))(
        params, jnp.asarray(seq, jnp.int32), **extras)
    ref_full = np.asarray(ref_full, np.float32)
    print(f"{cfg.name}: {cfg.n_layers} layers, batch {b}, prompt {s} after "
          f"{serve.prefix_len(cfg)} image positions, {gen} decode steps, vocab {cfg.vocab}, "
          f"extras {sorted(extras)}, seed {args.seed}; the tolerance rtol {RTOL} atol {ATOL}",
          flush=True)
    gap("reference prefill vs forward, last prompt position", ref_full[:, s - 1], pf[:, -1])
    for i, got in enumerate(ref_steps_out):
        gap(f"reference decode step {i} vs forward", ref_full[:, s + i], got)

    model = carry.lm_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    del params, cache
    with torch.inference_mode():
        full, _ = lm.forward(cfg, model, torch.as_tensor(seq), **port_extras)
        ppf, pcache = lm.prefill(cfg, model, torch.as_tensor(prompts), pos0 + gen, **port_extras)
        full = full.float().numpy()
        gap("port prefill vs forward, last prompt position", full[:, s - 1], ppf[:, -1].float())
        for i in range(gen):
            got, pcache = lm.decode_step(cfg, model, pcache, torch.tensor(toks[i]), pos0 + i)
            gap(f"port decode step {i} vs forward", full[:, s + i], got[:, 0].float())
    gap("port forward vs reference forward, every position", ref_full, full)


if __name__ == "__main__":
    main()
