"""Training driver: PS³ data plane + fault-tolerant loop on one device.

Features exercised: PS³ shard selection + weighted loss, checkpoint/resume
(crash-safe, keep-k), straggler watchdog with shard substitution, metrics.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --steps 100 --ckpt-dir ckpt [--device cuda]

``--device`` is ``cuda`` by default; ``cpu`` runs the plain versions (the
tests, with ``--smoke``).  A ``cuda`` request without a GPU raises:
nothing continues on the CPU.  The dense, MoE, hybrid and SSM families
train (`repro_torch.models.lm`), each held to the reference on the CPU
and to the CPU on the card.  The encoder-decoder and VLM families raise
`NotImplementedError`, as the reference's trainer fails: the token plane
gives them no frames or images (`train.steps.make_train_step` trains
them on batches that carry ``enc_frames`` or ``img_embeds``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.backends import ExecOptions
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.tokens import PS3DataPlane, make_token_store
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import steps as steps_mod
from repro_torch.train import tree as tree_mod
from repro_torch.train.checkpoint import Checkpointer


class StepWatchdog:
    """Flags straggler steps (> k× trailing median) for shard substitution."""

    def __init__(self, factor: float = 3.0, window: int = 20):
        self.times: list[float] = []
        self.factor = factor
        self.window = window

    def observe(self, dt: float) -> bool:
        hist = self.times[-self.window :]
        self.times.append(dt)
        if len(hist) < 5:
            return False
        return dt > self.factor * float(np.median(hist))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-backend", default=None, choices=("host", "device"),
                    help="offline-plane backend for picker training "
                    "(sketches, labels, GBDT fit); default: the device backend")
    ap.add_argument("--mesh", default=None,
                    help="partition-axis device count for the offline data "
                    "plane ('auto' = all local devices, 0 = single-device; "
                    "default: REPRO_MESH env)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda by default; cpu for the tests)")
    return ap.parse_args(argv)


def batch_tensors(batch: dict, device) -> dict:
    """The plane's numpy batch on ``device``: int64 token ids, f32 weights."""
    return {k: torch.as_tensor(v, device=device).long() if k != "loss_weights"
            else torch.as_tensor(v, device=device) for k, v in batch.items()}


def main(argv=None) -> list[float]:
    args = parse_args(argv)
    device = ExecOptions(device=args.device).torch_device()  # cuda without a GPU raises
    if args.mesh is not None:
        # env, not plumbing: every EvalCache / build_statistics below this
        # point resolves its partition plane through the REPRO_MESH policy
        os.environ["REPRO_MESH"] = str(args.mesh)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("encdec", "vlm"):
        # the reference's trainer fails here too, in `_encode(..., None)`
        # for whisper
        raise NotImplementedError(
            f"{cfg.name}: the PS³ token plane yields tokens only, and the {cfg.family} "
            "family needs frame or image embeddings beside them (train.steps."
            "make_train_step takes batches that carry them)")
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M")

    store = make_token_store(seq_len=129, vocab=cfg.vocab, seed=args.seed)
    plane = PS3DataPlane(store, seed=args.seed, backend=args.eval_backend,
                         device=args.device)
    est, truth = plane.mixture_estimate()
    print(f"data plane: {len(plane.shard_ids)}/{store.n_shards} shards selected; "
          f"mixture groups covered: {np.isfinite(est[:, 0]).mean():.0%}")

    # drawn on the CPU: the same weights on every device
    model = lm.init_params(cfg, torch.Generator().manual_seed(args.seed)).to(device)
    params = lm.param_tree(model)
    ocfg = opt.AdamWConfig(peak_lr=args.lr, warmup_steps=10, total_steps=args.steps)
    state = opt.init_state(ocfg, params)
    topts = steps_mod.TrainOptions(num_microbatches=args.microbatches, remat=False)
    train_step = steps_mod.make_train_step(cfg, ocfg, topts)

    ckpt = Checkpointer(args.ckpt_dir, keep_last=3)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        tree = ckpt.restore(start, {"params": params, "opt": state})
        with torch.no_grad():
            for p, saved in zip(tree_mod.leaves(params), tree_mod.leaves(tree["params"])):
                p.copy_(saved)
        state = tree["opt"]
        print(f"resumed from step {start}")

    watchdog = StepWatchdog()
    losses = []
    gen = plane.batches(args.batch, args.steps - start, seed=args.seed, start=start)
    for step, batch in enumerate(gen, start=start + 1):
        t0 = time.perf_counter()
        model, state, metrics = train_step(model, state, batch_tensors(batch, device))
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        if watchdog.observe(dt):
            victim = int(plane.shard_ids[0])
            repl = plane.substitute(victim)
            print(f"step {step}: straggler ({dt:.2f}s) — shard {victim}→{repl}")
        if step % 10 == 0 or step == start + 1:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if step % args.ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": state}, blocking=False)
    ckpt.wait()
    ckpt.save(args.steps, {"params": params, "opt": state})
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"ckpt steps: {ckpt.all_steps()}")
    return losses


if __name__ == "__main__":
    main()
