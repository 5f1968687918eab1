"""The serving entry point: batched prefill + greedy decode on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --batch 4 --prompt-len 32 --gen 16 [--device cuda]

AQP mode serves error-bounded analytics queries through the unified
`repro_torch.api.Session` instead of the LM decode loop:

    PYTHONPATH=src python -m repro_torch.launch.serve --aqp --error-bound 0.05

``--device`` is ``cuda`` by default; ``cpu`` runs the plain versions (the
tests).  A ``cuda`` request without a GPU raises: nothing continues on
the CPU.  Every family of `repro_torch.models.lm` serves.  The
encoder-decoder (whisper) is fed (B, enc_positions, d) frame embeddings
and the VLM (internvl) (B, n_img_tokens, d) image embeddings, both
drawn from ``--seed`` after the prompts, as the reference draws them
(the modality frontends are stubs).  The VLM's cache holds its image
positions too: ``--max-len`` must hold the image, the prompt and
``--gen``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.backends import ExecOptions
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import lm
from repro_torch.train import steps as steps_mod


def aqp_main(args) -> None:
    """Error-bounded AQP serving loop over the Session facade."""
    import repro_torch.api as ps3
    from repro_torch.core.picker import PickerConfig
    from repro_torch.data.datasets import make_dataset
    from repro_torch.queries.generator import WorkloadSpec

    options = ExecOptions(device=args.device)
    options.torch_device()  # a cuda request without a GPU raises here
    table = make_dataset(args.dataset, num_partitions=args.partitions,
                         rows_per_partition=args.rows, seed=args.seed)
    sess = ps3.Session(table, options=options)
    t0 = time.perf_counter()
    sess.prepare(WorkloadSpec(table, seed=args.seed), num_train_queries=32,
                 picker_config=PickerConfig(num_trees=16, tree_depth=4,
                                            feature_selection=False))
    print(f"[aqp] prepared in {time.perf_counter() - t0:.1f}s "
          f"({table.num_partitions} partitions)")
    queries = WorkloadSpec(table, seed=args.seed + 777).sample_workload(args.queries)
    t1 = time.perf_counter()
    answers = sess.execute_batch(
        [ps3.QuerySpec(q, error_bound=args.error_bound) for q in queries]
    )
    dt = time.perf_counter() - t1
    reads = [a.partitions_read for a in answers]
    modes = {}
    for a in answers:
        modes[a.plan.mode] = modes.get(a.plan.mode, 0) + 1
    print(f"[aqp] {len(answers)} queries in {dt:.1f}s @ "
          f"{args.error_bound:.0%} error bound; "
          f"mean reads {np.mean(reads):.1f}/{table.num_partitions}; modes {modes}")
    print(f"[aqp] session stats: {sess.stats()}")


@dataclasses.dataclass
class Served:
    """One run of the decode loop: the greedy tokens (B, 1 + gen) as
    numpy, the prefill logits (B, S, V), each decode step's logits
    (B, 1, V), and the two walls in seconds (the device synchronised)."""

    tokens: np.ndarray
    prefill_logits: torch.Tensor
    step_logits: list
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefix_len(cfg) -> int:
    """The positions before the prompt: a VLM's image tokens."""
    return cfg.n_img_tokens if cfg.family == "vlm" else 0


@torch.inference_mode()
def serve_loop(cfg, model, prompts: torch.Tensor, gen: int, max_len: int,
               extras: dict | None = None) -> Served:
    """Prefill ``prompts`` (B, S) with ``extras`` (`lm.prefill`'s
    ``img_embeds``/``enc_frames``), then ``gen`` greedy decode steps from
    the position after the image prefix and the prompt."""
    device = prompts.device
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, model, prompts, max_len, **(extras or {}))
    tok = torch.argmax(logits[:, -1:], dim=-1)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    serve_step = steps_mod.make_serve_step(cfg)
    pos0 = prefix_len(cfg) + prompts.shape[1]
    out_tokens, step_logits = [tok], []
    t1 = time.perf_counter()
    for i in range(gen):
        step, cache = serve_step(model, cache, tok, pos0 + i)
        tok = torch.argmax(step, dim=-1)
        out_tokens.append(tok)
        step_logits.append(step)
    _sync(device)
    t_decode = time.perf_counter() - t1
    tokens = torch.cat(out_tokens, dim=1).cpu().numpy()
    return Served(tokens, logits, step_logits, t_prefill, t_decode)


@dataclasses.dataclass
class LMRun:
    """`main`'s LM mode: the config, the model, the prompts, the extras
    (``img_embeds``/``enc_frames``, empty for a text-only family), the
    cache length and the run."""

    cfg: object
    model: lm.LM
    prompts: torch.Tensor
    extras: dict
    max_len: int
    served: Served


def draw_extras(cfg, rng: np.random.Generator, batch: int, device) -> dict:
    """The stub frontends' bf16 inputs from ``rng``, after the prompts, in
    the reference's order, shapes and scale: image embeddings (B,
    n_img_tokens, d) for the VLM, frame embeddings (B, enc_positions, d)
    for the encoder-decoder."""
    extras = {}
    if cfg.family == "vlm":
        extras["img_embeds"] = rng.normal(size=(batch, cfg.n_img_tokens, cfg.d_model)) * 0.02
    if cfg.family == "encdec":
        extras["enc_frames"] = rng.normal(size=(batch, cfg.enc_positions, cfg.d_model)) * 0.02
    return {k: torch.as_tensor(v, device=device).to(torch.bfloat16) for k, v in extras.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--aqp", action="store_true",
                    help="serve analytics queries via repro_torch.api.Session")
    ap.add_argument("--dataset", default="tpch")
    ap.add_argument("--partitions", type=int, default=64)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--error-bound", type=float, default=0.05)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu for the tests)")
    return ap.parse_args(argv)


def main(argv=None) -> LMRun | None:
    args = parse_args(argv)
    if args.aqp:
        return aqp_main(args)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = ExecOptions(device=args.device).torch_device()
    rng = np.random.default_rng(args.seed)
    max_len = args.max_len or (args.prompt_len + args.gen + 8)
    need = prefix_len(cfg) + args.prompt_len + args.gen
    if prefix_len(cfg) and max_len < need:
        raise ValueError(
            f"{cfg.name}: a cache of {max_len} positions cannot hold the {prefix_len(cfg)} "
            f"image tokens, the {args.prompt_len}-token prompt and {args.gen} generated "
            f"tokens; pass --max-len {need} or more")

    model = lm.init_params(cfg, torch.Generator(device).manual_seed(args.seed), device)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
                              device=device)
    extras = draw_extras(cfg, rng, args.batch, device)
    served = serve_loop(cfg, model, prompts, args.gen, max_len, extras)

    gen = served.tokens
    tput = args.batch * args.gen / served.decode_s
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill {served.prefill_s*1e3:.0f}ms; decode {served.decode_s*1e3:.0f}ms "
          f"({tput:.1f} tok/s); sample: {gen[0, :8].tolist()}")
    return LMRun(cfg, model, prompts, extras, max_len, served)


if __name__ == "__main__":
    main()
