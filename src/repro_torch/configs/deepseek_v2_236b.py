"""DeepSeek-V2 236B [arXiv:2405.04434; hf] — MLA + 2 shared/160 routed top-6.

60L d_model=5120 128H (kv=128 per assignment; MLA kv_lora=512)
d_ff=1536 (per routed expert) vocab=102400; dense d_ff=12288 for the first
layer (first_k_dense_replace=1); q_lora=1536, rope_head=64, nope=128, v=128.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,  # dense-layer FFN width
        vocab=102400,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1536,
        first_dense_layers=1,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_rope_head_dim=64,
        qk_nope_head_dim=128,
        v_head_dim=128,
        d_head=192,  # nope + rope
        block_pattern=("moe",),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke",
        family="moe",
        n_layers=3,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab=512,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        d_ff_expert=64,
        first_dense_layers=1,
        q_lora_rank=64,
        kv_lora_rank=32,
        qk_rope_head_dim=16,
        qk_nope_head_dim=32,
        v_head_dim=32,
        d_head=48,
        block_pattern=("moe",),
    )
