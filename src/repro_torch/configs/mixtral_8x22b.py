"""Mixtral 8x22B [arXiv:2401.04088; hf] — MoE 8 experts top-2, SWA.

56L d_model=6144 48H (GQA kv=8) d_ff=16384(per expert) vocab=32768.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        window=4096,  # sliding-window attention (assignment: SWA)
        n_experts=8,
        top_k=2,
        d_ff_expert=16384,
        block_pattern=("moe",),
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke",
        family="moe",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        window=64,
        n_experts=4,
        top_k=2,
        d_ff_expert=256,
        block_pattern=("moe",),
    )
