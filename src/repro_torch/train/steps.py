"""train_step / serve_step / prefill_step: the step functions the drivers
execute.

train_step: microbatched grad accumulation (a loop over microbatches;
accumulators in ``accum_dtype``, each microbatch's gradients added in
place as autograd produces them), optional unit-level remat, the
optional int8 error-feedback compressed cross-pod gradient mean
(`distributed.compress`), AdamW update.  The model's parameters and the
optimizer state are updated in place.  `dryrun_train_options` gives the
reference dry run's options for a config.

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


def dryrun_train_options(cfg: ModelConfig) -> tuple[str, TrainOptions]:
    """The options the reference's dry run trains ``cfg`` with at its
    ``train_4k`` shape → (the AdamW ``state_dtype``, `TrainOptions`).

    ``cfg`` is the full config: a layer cut takes its full model's
    options.  A copy of `src/repro/launch/dryrun.py` lines 32-41
    (`_microbatches`) and 66-74: int8 states and a bf16 accumulator
    above 1e11 parameters, f32 at or below; 16 microbatches where
    ``d_model * n_layers`` exceeds 1e6, 8 where it exceeds 2.5e5, else
    1; remat on."""
    act_cost = cfg.d_model * cfg.n_layers
    micro = 16 if act_cost > 1e6 else 8 if act_cost > 2.5e5 else 1
    big = cfg.param_count() > 1e11
    return ("int8" if big else "float32",
            TrainOptions(num_microbatches=micro, remat=True,
                         accum_dtype="bfloat16" if big else "float32"))


def make_grad_fn(cfg: ModelConfig, topts: TrainOptions):
    """Returns grad_fn(model, batch) → (loss, aux, grads): the train
    step's loss (the microbatches' mean), ``aux`` from the last
    microbatch and the gradients it hands to the update, a list over the
    leaves of `lm.param_tree` (in ``accum_dtype`` with microbatches, the
    parameters' dtype without).  The remat flag goes to each
    `lm.loss_fn` call, where the reference sets its module-global
    ``lm.REMAT_UNITS``.

    With microbatches, a hook on each parameter adds its gradient into
    the accumulator as soon as autograd has it and drops it, so no
    second gradient tree is held: ``a.add_(g.to(adt))`` rounds as the
    reference's ``(a + g.astype(adt)).astype(adt)`` does.
    """
    adt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[topts.accum_dtype]
    n = topts.num_microbatches

    def add_into(a):
        def hook(p):
            a.add_(p.grad.to(adt))
            p.grad = None
        return hook

    def grad_fn(model, batch):
        leaves = tree.leaves(lm.param_tree(model))
        for p in leaves:
            p.requires_grad_(True)
        if n == 1:
            loss, aux = lm.loss_fn(cfg, model, batch, remat_units=topts.remat)
            grads = list(torch.autograd.grad(loss, leaves))
            return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in leaves]
        for p in leaves:
            p.grad = None
        hooks = [p.register_post_accumulate_grad_hook(add_into(a))
                 for p, a in zip(leaves, acc)]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        try:
            for i in range(n):
                micro = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                         for k, v in batch.items()}
                loss, aux = lm.loss_fn(cfg, model, micro, remat_units=topts.remat)
                loss.backward()
                lsum = lsum + loss.detach()
        finally:
            for h in hooks:
                h.remove()
        for a in acc:
            a.div_(n)
        return lsum / n, {k: v.detach() for k, v in aux.items()}, acc

    return grad_fn


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, topts: TrainOptions):
    """Returns train_step(model, opt_state, batch) → (model, state, metrics).

    ``batch`` holds tensors {tokens, targets, loss_weights?} on the
    model's device; the metrics are 0-d tensors {loss, ce, lb_loss,
    z_loss, grad_norm, lr} (`make_grad_fn`'s loss and aux).
    ``opt_state`` is consumed (`optimizer.apply_updates`).
    """
    grad_fn = make_grad_fn(cfg, topts)

    def train_step(model, opt_state, batch):
        params = lm.param_tree(model)
        loss, aux, g = grad_fn(model, batch)
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
