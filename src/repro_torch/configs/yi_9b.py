"""Yi-9B [arXiv:2403.04652; hf] — llama-arch GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64000,
        block_pattern=("attn",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi9b-smoke",
        family="dense",
        n_layers=3,
        d_model=96,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
        block_pattern=("attn",),
    )
