"""train_step / serve_step / prefill_step: the step functions the drivers
execute.

train_step: microbatched grad accumulation (a loop over microbatches;
accumulators in ``accum_dtype``), optional unit-level remat, the
optional int8 error-feedback compressed cross-pod gradient mean
(`distributed.compress`), AdamW update.  The model's parameters are
trained in place.

serve_step: one decode token against the KV cache (written in place);
prefill_step: the full-prompt forward, returning the next-token logits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import compress
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt
from repro_torch.train import tree


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    num_microbatches: int = 1
    remat: bool = True
    compress_pod_grads: bool = False  # int8 EF all-reduce across "pod"
    accum_dtype: str = "float32"  # microbatch grad accumulator ("bfloat16"
    # halves the accumulator tree for ≥100B configs)


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, topts: TrainOptions):
    """Returns train_step(model, opt_state, batch) → (model, state, metrics).

    ``batch`` holds tensors {tokens, targets, loss_weights?} on the
    model's device; the metrics are 0-d tensors {loss, ce, lb_loss,
    z_loss, grad_norm, lr}, ``aux`` from the last microbatch.  The remat
    flag goes to each `lm.loss_fn` call, where the reference sets its
    module-global ``lm.REMAT_UNITS``.
    """
    adt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[topts.accum_dtype]

    def value_and_grad(model, leaves, micro):
        loss, aux = lm.loss_fn(cfg, model, micro, remat_units=topts.remat)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def grads_of(model, leaves, batch):
        n = topts.num_microbatches
        if n == 1:
            return value_and_grad(model, leaves, batch)
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n):
            micro = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                     for k, v in batch.items()}
            loss, aux, g = value_and_grad(model, leaves, micro)
            acc = [(a + b.to(adt)).to(adt) for a, b in zip(acc, g)]
            lsum = lsum + loss
        return lsum / n, aux, [a / n for a in acc]

    def train_step(model, opt_state, batch):
        params = lm.param_tree(model)
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, aux, g = grads_of(model, leaves, batch)
        grads = tree.unflatten(params, g)
        if topts.compress_pod_grads:
            grads = compress.maybe_compressed_pod_mean(grads)
        _, opt_state, om = opt.apply_updates(ocfg, params, grads, opt_state)
        metrics = {"loss": loss, **aux, **om}
        return model, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens, pos) → (logits, cache)."""

    def serve_step(params, cache, tokens, pos):
        return lm.decode_step(cfg, params, cache, tokens, pos)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) → the next-token logits (B, V) of
    ``batch["tokens"]`` (after ``batch["img_embeds"]``, over
    ``batch["enc_frames"]``, where the family takes them)."""

    def prefill_step(params, batch):
        logits, _ = lm.forward(cfg, params, batch["tokens"], img_embeds=batch.get("img_embeds"),
                               enc_frames=batch.get("enc_frames"))
        return logits[:, -1]

    return prefill_step
