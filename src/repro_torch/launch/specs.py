"""input_specs(): the stand-in inputs of every (arch × shape) cell.

The reference's `repro.launch.specs` for the port: its
``ShapeDtypeStruct``s become tensors made by the caller, under a
`FakeTensorMode` (`launch.dryrun`), so nothing is allocated.  The same
modality stubs: whisper gets precomputed (B, 1500, d) frame embeddings,
internvl (B, 256, d) patch embeddings with text of ``seq_len −
n_img_tokens``; ``loss_weights`` is f32.  The decode cache is
`models.lm.init_cache`'s.

Two departures from the reference, both the port's own types: token ids
are int64 (the port's tokens everywhere: the token plane's batches,
``serve``'s prompts, ``argmax``), where the reference's are ``int32``;
and the decode position is a Python int (`lm.decode_step` takes one:
the slot is chosen on the host), where the reference's is a 0-d
``int32`` argument.  The position is the cache's last slot.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import SHAPES, ModelConfig, ShapeSpec

TOKENS = torch.int64
BF16 = torch.bfloat16
F32 = torch.float32


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, device=None) -> dict:
    b, s = shape.global_batch, shape.seq_len

    def empty(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)

    batch = {}
    if cfg.family == "vlm":
        s -= cfg.n_img_tokens
        batch["img_embeds"] = empty((b, cfg.n_img_tokens, cfg.d_model), BF16)
    elif cfg.family == "encdec":
        batch["enc_frames"] = empty((b, cfg.enc_positions, cfg.d_model), BF16)
    batch["tokens"] = empty((b, s), TOKENS)
    batch["targets"] = empty((b, s), TOKENS)
    batch["loss_weights"] = empty((b,), F32)  # PS³ data-plane weights
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, device=None):
    """serve_step inputs: one new token per sequence, a cache of
    ``seq_len`` and the position (its last slot)."""
    b, s = shape.global_batch, shape.seq_len
    cache = lm.init_cache(cfg, b, s, device)
    tokens = torch.empty((b, 1), dtype=TOKENS, device=device)
    return cache, tokens, s - 1


def input_specs(cfg: ModelConfig, shape: str | ShapeSpec, device=None) -> dict:
    """The cell's inputs: ``{"batch"}``, or ``{"cache", "tokens", "pos"}``
    for a decode shape (``shape`` a `SHAPES` name or a `ShapeSpec`)."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape, device)}
    if shape.kind == "prefill":
        batch = train_batch_specs(cfg, shape, device)
        del batch["targets"], batch["loss_weights"]
        return {"batch": batch}
    cache, tokens, pos = decode_specs(cfg, shape, device)
    return {"cache": cache, "tokens": tokens, "pos": pos}
