"""RecurrentGemma-9B [arXiv:2402.19427 Griffin] — RG-LRU + local attn 1:2.

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; lru width 4096;
local attention window 2048; pattern (rec, rec, attn).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        d_ff=12288,
        vocab=256000,
        window=2048,  # local attention
        rglru_width=4096,
        conv1d_width=4,
        block_pattern=("rglru", "rglru", "attn"),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rg-smoke",
        family="hybrid",
        n_layers=5,  # exercises the ragged tail (5 = 1×3 + 2)
        d_model=128,
        n_heads=4,
        n_kv_heads=1,
        d_ff=256,
        vocab=512,
        window=32,
        rglru_width=128,
        conv1d_width=4,
        block_pattern=("rglru", "rglru", "attn"),
    )
