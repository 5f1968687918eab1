"""Llama-3 405B [arXiv:2407.21783] — dense GQA, 128k vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_ff=53248,
        vocab=128256,
        rope_theta=5e5,
        block_pattern=("attn",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke",
        family="dense",
        n_layers=4,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=384,
        vocab=512,
        block_pattern=("attn",),
    )
