"""Multi-head Latent Attention (DeepSeek-V2).

Queries and keys/values are low-rank compressed:
  q:  x → c_q (q_lora_rank) → per-head [q_nope | q_rope]
  kv: x → [c_kv (kv_lora_rank) | k_rope (shared single head)]
      c_kv → per-head [k_nope | v]

Train/prefill decompress and run the shared flash-pattern attention
(qk dim = nope+rope, v dim = v_head_dim).  Decode runs the ABSORBED form
(`repro.models.mla.mla_decode`): the cache stores only (c_kv, k_rope) —
(kv_lora + rope) values per token, written in place at the token's
position — and the scores are computed in the compressed space by
absorbing W_UK into q and W_UV into the output projection.  The scores
and the softmax are f32 over the bf16 cache (the reference's bf16 × f32
dots); the compressed output goes back to bf16 before W_UV.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import (
    RMSNorm, _inv_sqrt, _param, chunked_attention, dense_init, rmsnorm, rope,
)


class MLA(nn.Module):
    """``wdq`` (d, q_lora), ``q_norm``, ``wuq`` (q_lora, H·(nope+rope)),
    ``wdkv`` (d, kv_lora+rope), ``kv_norm``, ``wukv`` (kv_lora,
    H·(nope+v)) and ``wo`` (H·v, d)."""

    def __init__(self, cfg, generator=None, *, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.wdq = _param(dense_init(generator, (d, qr), device=device))
        self.q_norm = RMSNorm(qr, cfg.norm_eps, device=device)
        self.wuq = _param(dense_init(generator, (qr, h * (dn + dr)), device=device))
        self.wdkv = _param(dense_init(generator, (d, kr + dr), device=device))
        self.kv_norm = RMSNorm(kr, cfg.norm_eps, device=device)
        self.wukv = _param(dense_init(generator, (kr, h * (dn + dv)), device=device))
        self.wo = _param(dense_init(generator, (h * dv, d), device=device))


def _project_q(p: MLA, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rmsnorm(p.q_norm, x @ p.wdq, cfg.norm_eps)
    q = (cq @ p.wuq).reshape(b, s, h, dn + dr)
    qn, qr_ = q[..., :dn], q[..., dn:]
    return qn, rope(qr_, positions, cfg.rope_theta)


def _compress_kv(p: MLA, x, cfg, positions):
    kr = cfg.kv_lora_rank
    ckv_full = x @ p.wdkv  # (B, S, kr + dr)
    ckv = rmsnorm(p.kv_norm, ckv_full[..., :kr], cfg.norm_eps)
    kpe = rope(ckv_full[..., kr:], positions, cfg.rope_theta)  # (B, S, dr)
    return ckv, kpe


def mla_apply(p: MLA, x, cfg, *, positions=None):
    """Train/prefill (decompressed). Returns (out, (c_kv, k_rope))."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    qn, qr_ = _project_q(p, x, cfg, positions)
    ckv, kpe = _compress_kv(p, x, cfg, positions)
    kv = (ckv @ p.wukv).reshape(b, s, h, dn + cfg.v_head_dim)
    kn, v = kv[..., :dn], kv[..., dn:]
    q = torch.cat([qn, qr_], dim=-1)
    k = torch.cat([kn, kpe[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    o = chunked_attention(q, k, v, causal=True)
    return o.reshape(b, s, h * cfg.v_head_dim) @ p.wo, (ckv, kpe)


def mla_decode(p: MLA, x, cfg, cache_ckv, cache_kpe, pos: int):
    """Absorbed single-token decode. x: (B, 1, d); cache_ckv: (B, S, kr),
    cache_kpe: (B, S, dr), written in place at ``pos``.  Returns
    (out, cache_ckv, cache_kpe)."""
    b = x.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    smax = cache_ckv.shape[1]
    if pos >= smax:
        raise IndexError(f"decode position {pos} is past the cache's {smax} slots")
    pos_arr = torch.full((b, 1), pos, device=x.device)
    qn, qr_ = _project_q(p, x, cfg, pos_arr)  # (B,1,H,dn),(B,1,H,dr)
    ckv, kpe = _compress_kv(p, x, cfg, pos_arr)  # (B,1,kr),(B,1,dr)
    cache_ckv[:, pos:pos + 1] = ckv
    cache_kpe[:, pos:pos + 1] = kpe

    wuk = p.wukv[:, :h * dn].reshape(kr, h, dn)
    wuv = p.wukv[:, h * dn:].reshape(kr, h, dv)
    q_abs = torch.einsum("bqhd,rhd->bqhr", qn, wuk)  # absorb W_UK (bf16)
    scale = _inv_sqrt(dn + dr)
    cc, ck = cache_ckv.float(), cache_kpe.float()
    s = torch.einsum("bqhr,bsr->bhqs", q_abs.float() * scale, cc)
    s = s + torch.einsum("bqhd,bsd->bhqs", qr_.float() * scale, ck)
    ok = torch.arange(smax, device=x.device) <= pos
    s = torch.where(ok[None, None, None, :], s, -math.inf)
    w = torch.softmax(s, dim=-1)  # f32
    oc = torch.einsum("bhqs,bsr->bqhr", w, cc)
    o = torch.einsum("bqhr,rhd->bqhd", oc.to(x.dtype), wuv)  # absorb W_UV
    return o.reshape(b, 1, h * dv) @ p.wo, cache_ckv, cache_kpe

