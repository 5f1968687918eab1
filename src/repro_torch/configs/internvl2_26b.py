"""InternVL2-26B [arXiv:2404.16821; hf] — InternViT (stub) + InternLM2-20B.

Backbone: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  The
vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (256 tokens/tile) prepended to the text.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=92553,
        n_img_tokens=256,
        block_pattern=("attn",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl-smoke",
        family="vlm",
        n_layers=3,
        d_model=96,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=512,
        n_img_tokens=16,
        block_pattern=("attn",),
    )
