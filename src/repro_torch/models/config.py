"""Model configuration schema for the assigned architecture pool.

One `ModelConfig` covers all 10 assigned families (dense / MoE / MLA /
hybrid RG-LRU / SSM / enc-dec audio / VLM); the block types present are
derived from the fields set.  Every config module in `repro_torch.configs`
instantiates exactly one of these with the published numbers, plus a
`smoke()` reduction of the same family for CPU tests.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # defaults to d_model // n_heads

    # attention flavour
    window: int = 0  # >0 = sliding-window attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0  # deepseek: first layer uses dense FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # hybrid (recurrentgemma): layer pattern, tiled over n_layers
    block_pattern: tuple[str, ...] = ("attn",)
    rglru_width: int = 0
    conv1d_width: int = 4

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_chunk: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1

    # enc-dec (whisper): encoder layers + fixed frame count (conv stub)
    n_enc_layers: int = 0
    enc_positions: int = 1500

    # VLM (internvl): precomputed patch-embedding stub
    n_img_tokens: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # ---- derived ---------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Supports decode whose per-token state does not grow with context."""
        return self.family in ("ssm",) or self.window > 0 or (
            self.family == "hybrid"
        )

    @property
    def blocks(self) -> tuple[str, ...]:
        """Per-layer block types, pattern tiled over n_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Total parameters (embedding + blocks), for 6ND roofline checks."""
        d = self.d_model
        n = 0
        n += self.vocab * d  # embed
        if not self.tie_embeddings:
            n += self.vocab * d  # lm head
        for kind in self.blocks:
            n += self._block_params(kind)
        n += d  # final norm
        if self.family == "encdec":
            for _ in range(self.n_enc_layers):
                n += self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
            n += d
            # decoder cross-attention per layer
            n += self.n_layers * (self._attn_params() + d)
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        ff = self.d_ff_expert or self.d_ff
        expert_p = 3 * d * ff
        n_moe_layers = sum(1 for k in self.blocks if k == "moe")
        inactive = n_moe_layers * (self.n_experts - self.top_k) * expert_p
        return total - inactive

    def _attn_params(self) -> int:
        d = self.d_model
        if self.is_mla:
            p = d * self.q_lora_rank
            p += self.q_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            p += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            p += self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            p += self.n_heads * self.v_head_dim * d
            return p
        hd = self.d_head
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _mlp_params(self, ff: int) -> int:
        return 3 * self.d_model * ff  # gated MLP

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        if kind == "attn":
            return self._attn_params() + self._mlp_params(self.d_ff) + 2 * d
        if kind == "moe":
            ff = self.d_ff_expert or self.d_ff
            p = self._attn_params() + 2 * d
            p += self.n_experts * 3 * d * ff + d * self.n_experts
            p += self.n_shared_experts * 3 * d * ff
            return p
        if kind == "rglru":
            w = self.rglru_width or d
            p = 2 * d * w + w * d  # in-proj (x, gate) + out-proj
            p += self.conv1d_width * w + 3 * w  # conv + Λ, input/rec gates diag-ish
            p += 2 * w * w // 4  # block-diag gate projections (4 blocks)
            return p + self._mlp_params(self.d_ff) + 2 * d
        if kind == "ssd":
            din = self.ssm_expand * d
            h = din // self.ssm_head_dim
            g = self.ssm_groups
            n = self.ssm_state
            p = d * (2 * din + 2 * g * n + h)  # in_proj
            p += self.conv1d_width * (din + 2 * g * n)
            p += h + h + din  # A_log, D, dt_bias... (dt folded in in_proj)
            p += din * d  # out_proj
            return p + d  # norm
        raise ValueError(kind)


# --------------------------------------------------------------------------
# input shapes (assignment block)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Per the assignment: long_500k only for sub-quadratic decode paths."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
