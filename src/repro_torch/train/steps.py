"""serve_step / prefill_step: the step functions of `launch/serve.py`.

serve_step: one decode token against the KV cache (written in place);
prefill_step: the full-prompt forward, returning the next-token logits.
The training half (`TrainOptions`, `make_train_step`) waits for the
training slice (`ROADMAP.md` § 1 item 10).
"""
from __future__ import annotations

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens, pos) → (logits, cache)."""

    def serve_step(params, cache, tokens, pos):
        return lm.decode_step(cfg, params, cache, tokens, pos)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) → the next-token logits (B, V) of
    ``batch["tokens"]``."""

    def prefill_step(params, batch):
        logits, _ = lm.forward(cfg, params, batch["tokens"])
        return logits[:, -1]

    return prefill_step
