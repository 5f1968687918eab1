"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — QKV bias, 152k vocab.

24L d_model=1024 16H (kv=16, MHA) d_ff=2816 vocab=151936.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        block_pattern=("attn",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke",
        family="dense",
        n_layers=3,
        d_model=96,
        n_heads=4,
        n_kv_heads=4,
        d_ff=192,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
        block_pattern=("attn",),
    )
