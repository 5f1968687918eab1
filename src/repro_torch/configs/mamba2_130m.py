"""Mamba2-130M [arXiv:2405.21060] — SSD (state-space duality), attn-free.

24L d_model=768, ssm_state=128, vocab=50280; expand=2 (d_inner 1536),
head_dim 64 ⇒ 24 SSD heads; chunked SSD with chunk 64.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=1,  # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab=50280,
        d_head=64,
        ssm_state=128,
        ssm_chunk=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        tie_embeddings=True,
        block_pattern=("ssd",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=3,
        d_model=128,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=512,
        d_head=32,
        ssm_state=32,
        ssm_chunk=16,
        ssm_head_dim=32,
        ssm_expand=2,
        ssm_groups=1,
        tie_embeddings=True,
        block_pattern=("ssd",),
    )
