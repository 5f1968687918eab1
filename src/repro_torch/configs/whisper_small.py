"""Whisper-small [arXiv:2212.04356] — enc-dec; conv frontend STUBBED.

12L enc + 12L dec, d_model=768 12H d_ff=3072 vocab=51865; encoder consumes
precomputed 1500-frame embeddings per the assignment (modality frontend is
a stub supplying (B, 1500, 768) frame embeddings via input_specs()).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=51865,
        enc_positions=1500,
        block_pattern=("attn",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=96,
        n_heads=4,
        n_kv_heads=4,
        d_ff=192,
        vocab=512,
        enc_positions=64,
        block_pattern=("attn",),
    )
