"""How far the port's bf16 decode departs from its forward as an LM gets deeper, on the card.

`chip_smoke.py` check (a) holds the prefill and decode logits to the full
forward over the prompt and the generated tokens at ``rtol=5e-2,
atol=5e-2``, allowing a share ``LM_OUTSIDE`` of a position's logits
outside.  This script serves an arch at full width through
`launch/serve.main` (seed 0, batch 4, prompt 32, gen 16, its extras),
then measures that gap on the whole model and on its first N layers
(`chip_smoke.cut_model`), in bf16 and, on the cuts that fit beside the
model, in f32; last, on the whole model with each decode step's scaled
query rounded to bf16 as the forward's chunked attention rounds it.
Needs one NVIDIA GPU (internvl2-26b: 39.7 GB of weights, about 71 GB at
its peak); about a minute with the machine:

    PYTHONPATH=src python3 tools/lm_depth_gap.py --arch internvl2-26b --max-len 312
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internvl2-26b")
    ap.add_argument("--max-len", type=int, default=312)
    ap.add_argument("--depths", type=int, nargs="*", default=[32, 24, 16, 8, 4, 2])
    ap.add_argument("--f32-depths", type=int, nargs="*", default=[16, 8, 2])
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    run = serve.main(["--arch", args.arch, *cs.LM_FLAGS, "--max-len", str(args.max_len)])
    prompts, p, gen = run.prompts, run.prompts.shape[1], cs.LM_GEN

    def gaps(model, tag: str) -> None:
        seen, fed, _ = cs.run_fed(model.cfg, model, prompts, run.max_len, gen,
                                  extras=run.extras)
        seq = torch.cat([prompts, *fed], dim=1)
        with torch.inference_mode():
            full, _ = lm.forward(model.cfg, model, seq, **run.extras)
        outs = [seen[0][:, -1]] + [s[:, 0] for s in seen[1:]]
        g = [cs.gap_of(full[:, p - 1 + i], o, cs.LM_TOL) for i, o in enumerate(outs)]
        print(f"[gap] {tag}: shares outside by position (the prefill's last, then each step) "
              f"{[round(x[2], 6) for x in g]}, max_abs_err {max(x[0] for x in g):.4g}, min "
              f"correlation {min(x[3] for x in g):.6f}", flush=True)

    gaps(run.model, f"bf16, {run.cfg.n_layers} layers")
    for n in args.depths:
        gaps(cs.cut_model(run.model, n, prompts.device), f"bf16, {n} layers")
        torch.cuda.empty_cache()
    for n in args.f32_depths:
        with mock.patch.object(lm, "DTYPE", torch.float32):
            gaps(cs.cut_model(run.model, n, prompts.device).float(), f"f32, {n} layers")
        torch.cuda.empty_cache()

    real_qkv, scale = layers.attn_qkv, layers._inv_sqrt(run.cfg.d_head)

    def rounded_query(p_, x, cfg, positions, with_rope=True):
        q, k, v = real_qkv(p_, x, cfg, positions, with_rope)
        if x.shape[1] == 1:  # a decode step: attn_decode scales q in f32 and keeps it
            q = (q.float() * scale).to(q.dtype).float() / scale
        return q, k, v

    with mock.patch.object(layers, "attn_qkv", rounded_query):
        gaps(run.model, f"bf16, {run.cfg.n_layers} layers, the decode's scaled query rounded "
                        "to bf16")
    print(f"[gap] peak {torch.cuda.max_memory_allocated()} bytes; card {card}", flush=True)


if __name__ == "__main__":
    main()
