"""Core transformer building blocks: `nn.Module`s over the reference's math.

Conventions (the reference's `repro.models.layers`, kept so that the two
packages can be compared number for number):
  * weights are kept in the reference's ``(d_in, d_out)`` layout and
    applied as ``x @ w``; activations and weights bf16, softmax and norm
    statistics f32;
  * attention is the reference's own flash-pattern chunk loop (online
    softmax over kv chunks), never a library attention, with the same
    chunk padding, masks and ``triangle_skip`` bounds.  The score and
    output products accumulate in f32 (the reference's
    ``preferred_element_type``): both operands go to f32, whose products
    of bf16 values are exact, so the sum is the reference's f32 sum up to
    its order;
  * `pin_f32_accumulation` is called at every model entry point: no TF32
    for the f32 products, and cuBLAS bf16 GEMMs reduce in f32 as XLA's do.

Every module takes an explicit `torch.Generator` for its init (normal ×
1/sqrt(fan_in), the reference's distribution, not its bits) or None to
allocate its tensors uninitialised for `repro_torch.carry.lm_params` to
fill.  Parameters are built with ``requires_grad`` False, which the
serving path keeps (it also runs under `torch.inference_mode`); the
training path (`repro_torch.train.steps.make_train_step`) turns it on for
the model it trains.  `remat` is the reference's `jax.checkpoint`.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

DTYPE = torch.bfloat16


# flipped by configs/launchers; a §Perf knob of the reference
@dataclasses.dataclass
class AttnOptions:
    q_chunk: int = 2048
    kv_chunk: int = 1024
    triangle_skip: bool = True


ATTN_OPTS = AttnOptions()


def pin_f32_accumulation() -> None:
    """IEEE f32 for the f32 attention products, and f32 reduction inside
    cuBLAS's bf16 GEMMs (XLA accumulates a bf16 dot in f32).  Process-wide
    torch switches, set where the model is entered, as
    `queries/device._device_inputs` does for TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(generator, shape, scale_axis=0, dtype=DTYPE, device=None):
    """normal × 1/sqrt(shape[scale_axis]) drawn in f32, stored as ``dtype``;
    uninitialised when ``generator`` is None (the carry fills it)."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(max(shape[scale_axis], 1))
    x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def remat(fn, *args):
    """``fn(*args)`` with its internals recomputed in the backward instead
    of saved (the reference's `jax.checkpoint`) where autograd records; a
    plain call where it does not (serving, `torch.no_grad`).  The
    recomputation runs the same ops, so the numbers do not change."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _f32(x) -> float:
    """An f32 constant as a Python float.  A Python scalar operand of an
    f32 op is taken in f32, so this equals a 0-d f32 tensor operand, and
    it reaches the card as a kernel argument: `torch.tensor(x, device=
    "cuda")` would be a synchronous host-to-device copy on every call."""
    return float(np.float32(x))


# --------------------------------------------------------------------------
# the reference's `jax.nn` activations, op by op
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _weak(v: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``, as JAX rounds a weak-typed
    scalar operand of a bf16 op."""
    return float(torch.tensor(v, dtype=dtype))


def softplus(x):
    """``log(1 + eˣ)`` as `jax.nn.softplus` computes it (`jnp.logaddexp(x,
    0)`): ``max(x, 0) + log1p(exp(−|x|))``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh form, op by op in ``x``'s dtype
    with its constants rounded to it: the reference's bits on the CPU,
    where `F.gelu` rounds once."""
    c, k = _weak(math.sqrt(2 / math.pi), x.dtype), _weak(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def silu(x):
    """`jax.nn.silu`: ``x · 1/(1 + e^(−x))``, each op in ``x``'s dtype (XLA's
    bf16 logistic rounds each op; `F.silu` rounds once).  The recurrent
    blocks use it; the MLP keeps `F.silu`."""
    return x * (1 / (1 + torch.exp(-x)))


# --------------------------------------------------------------------------
# norms / mlp / embeddings
# --------------------------------------------------------------------------
def rmsnorm(p, x, eps=1e-5):
    h = x.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * p.scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(torch.ones((d,), dtype=DTYPE, device=device))

    def forward(self, x):
        return rmsnorm(self, x, self.eps)


def mlp(p, x):
    h = nn.functional.silu(x @ p.wg) * (x @ p.wi)
    return h @ p.wo


class MLP(nn.Module):
    """SiLU-gated MLP: ``(silu(x·wg) ⊙ x·wi)·wo``."""

    def __init__(self, d: int, ff: int, generator=None, *, device=None):
        super().__init__()
        self.wi = _param(dense_init(generator, (d, ff), device=device))
        self.wg = _param(dense_init(generator, (d, ff), device=device))
        self.wo = _param(dense_init(generator, (ff, d), device=device))

    def forward(self, x):
        return mlp(self, x)


def embed(p, tokens):
    return p.table[tokens]


def unembed(p, x):
    return x @ p.table.t()  # tied; untied heads pass their own table


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, generator=None, *, device=None):
        super().__init__()
        self.table = _param(dense_init(generator, (vocab, d), scale_axis=1, device=device))

    def forward(self, tokens):
        return embed(self, tokens)


# --------------------------------------------------------------------------
# rotary embedding
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: (..., S).  f32 angles."""
    d = x.shape[-1]
    half = d // 2
    step = _f32(np.log(np.float32(theta)) / np.float32(half))
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device) * step)
    ang = positions.float()[..., None] * freqs  # (..., S, half)
    if x.ndim == ang.ndim + 1:  # broadcast over heads
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# flash-pattern chunked attention
# --------------------------------------------------------------------------
def _block_attn(q, k, v, bias):
    """One (q-chunk, kv-chunk) online-softmax partial.

    q: (B, H, Tq, D), k/v: (B, H, Tk, D), bias: (1, 1, Tq, Tk) additive.
    Returns (m, l, o) partials in f32.  A row that the bias masks whole
    gives m = -inf and NaN partials, as in the reference (`ROADMAP.md` § 3).
    """
    s = q.float() @ k.float().transpose(-1, -2)
    s = s + bias
    m = torch.amax(s, dim=-1)  # (B, H, Tq)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = p.to(v.dtype).float() @ v.float()
    return m, l, o


def _combine(acc, new):
    m0, l0, o0 = acc
    m1, l1, o1 = new
    m = torch.maximum(m0, m1)
    a0 = torch.exp(m0 - m)
    a1 = torch.exp(m1 - m)
    return m, l0 * a0 + l1 * a1, o0 * a0[..., None] + o1 * a1[..., None]


def _kv_step(m, l, o, q, k, v, bias):
    """The kv-chunk body: one partial folded into the running (m, l, o)."""
    return _combine((m, l, o), _block_attn(q, k, v, bias))


def _inv_sqrt(d: int) -> float:
    return _f32(np.float32(1.0) / np.sqrt(np.float32(d)))  # the reference's f32 scale


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    opts: AttnOptions | None = None,
) -> torch.Tensor:
    """GQA flash-pattern attention; returns (B, Sq, H, D).

    `q_offset` is the absolute position of q[0] relative to k[0] (prefill:
    0; single-token decode has its own path).
    """
    opts = opts or ATTN_OPTS
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]  # may differ from d (MLA)
    rep = h // kh
    dev = q.device
    scale = _inv_sqrt(d)

    qc = min(opts.q_chunk, sq)
    kc = min(opts.kv_chunk, sk)
    nq = -(-sq // qc)
    nk = -(-sk // kc)
    # pad to chunk multiples
    qpad, kpad = nq * qc - sq, nk * kc - sk
    q = nn.functional.pad(q, (0, 0, 0, 0, 0, qpad))
    k = nn.functional.pad(k, (0, 0, 0, 0, 0, kpad))
    v = nn.functional.pad(v, (0, 0, 0, 0, 0, kpad))

    # (B, H, S, D) layout, the query scaled in f32 and cast back; kv heads
    # expanded to q heads (GQA)
    qt = (q.transpose(1, 2).float() * scale).to(q.dtype)
    kt = torch.repeat_interleave(k.transpose(1, 2), rep, dim=1)
    vt = torch.repeat_interleave(v.transpose(1, 2), rep, dim=1)

    kt_chunks = kt.reshape(b, h, nk, kc, d)
    vt_chunks = vt.reshape(b, h, nk, kc, dv)
    q_ar = torch.arange(qc, device=dev)
    k_ar = torch.arange(kc, device=dev)

    def bias_for(qi, ki):
        qpos = q_offset + qi * qc + q_ar
        kpos = ki * kc + k_ar
        ok = (kpos[None, :] < sk).expand(qc, kc)  # mask kv padding
        if causal:
            ok = ok & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            ok = ok & (kpos[None, :] > qpos[:, None] - window)
        return torch.where(ok, 0.0, -math.inf)[None, None, :, :]  # (1, 1, Tq, Tk) f32

    def q_block(qi, qblk):
        # made from the query block, whose layout they take on a mesh
        acc = (
            qblk.new_full((b, h, qc), -math.inf, dtype=torch.float32),
            qblk.new_zeros((b, h, qc), dtype=torch.float32),
            qblk.new_zeros((b, h, qc, dv), dtype=torch.float32),
        )
        if opts.triangle_skip:
            # only the kv chunks the causal/window mask can reach
            hi = nk if not causal else min(nk, (q_offset + (qi + 1) * qc - 1) // kc + 1)
            lo = 0
            if window > 0:
                lo = max(0, (q_offset + qi * qc - window + 1) // kc)
            hi = max(hi, lo + 1)
            chunks = range(lo, hi)
        else:
            chunks = range(nk)
        # remat the kv-chunk body: backward recomputes the (Tq × Tk) block
        # probabilities instead of saving one per kv chunk (flash-style)
        for ki in chunks:
            acc = remat(_kv_step, *acc, qblk, kt_chunks[:, :, ki], vt_chunks[:, :, ki],
                        bias_for(qi, ki))
        m, l, o = acc
        return o / torch.clamp_min(l, 1e-30)[..., None]

    outs = [q_block(qi, qt[:, :, qi * qc:(qi + 1) * qc]) for qi in range(nq)]
    out = torch.cat(outs, dim=2) if nq > 1 else outs[0]
    return out[:, :, :sq].transpose(1, 2).to(q.dtype)  # (B, Sq, H, D)


# --------------------------------------------------------------------------
# GQA attention layer (train+prefill and decode)
# --------------------------------------------------------------------------
class Attention(nn.Module):
    """``wq`` (d, H·hd), ``wk``/``wv`` (d, K·hd), ``wo`` (H·hd, d), and the
    ``bq``/``bk``/``bv`` biases (zeros at init) where ``cfg.qkv_bias``."""

    def __init__(self, cfg, generator=None, *, device=None):
        super().__init__()
        d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = _param(dense_init(generator, (d, h * hd), device=device))
        self.wk = _param(dense_init(generator, (d, kh * hd), device=device))
        self.wv = _param(dense_init(generator, (d, kh * hd), device=device))
        self.wo = _param(dense_init(generator, (h * hd, d), device=device))
        for name, width in (("bq", h * hd), ("bk", kh * hd), ("bv", kh * hd)):
            bias = _param(torch.zeros((width,), dtype=DTYPE, device=device)) if cfg.qkv_bias else None
            self.register_parameter(name, bias)


def attn_qkv(p, x, cfg, positions, with_rope=True):
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if with_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_q(p, x, cfg):
    """The (B, S, H, hd) queries alone, no rope: a cross-attention's (its
    keys and values are the encoder's; `attn_qkv` would also project ``x``
    to keys and values that nothing reads)."""
    b, s, _ = x.shape
    q = x @ p.wq
    if p.bq is not None:
        q = q + p.bq
    return q.reshape(b, s, cfg.n_heads, cfg.d_head)


def attn_apply(p, x, cfg, *, causal=True, window=0, positions=None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = attn_qkv(p, x, cfg, positions)
    o = chunked_attention(q, k, v, causal=causal, window=window)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return o @ p.wo, (k, v)


def attn_decode(p, x, cfg, cache_k, cache_v, pos: int, *, window=0):
    """Single-token decode. x: (B, 1, d); cache: (B, S, K, hd) (a ring when
    window > 0), written in place at the token's slot.  `pos` is the
    absolute position.  Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dev = x.device
    pos_arr = torch.full((b, 1), pos, device=dev)
    q, k, v = attn_qkv(p, x, cfg, pos_arr)
    s_max = cache_k.shape[1]
    slot = pos % s_max if window > 0 else pos
    if slot >= s_max:
        raise IndexError(f"decode position {pos} is past the cache's {s_max} slots")
    cache_k[:, slot:slot + 1] = k
    cache_v[:, slot:slot + 1] = v
    # attend over the cache
    rep = h // kh
    kt = torch.repeat_interleave(cache_k, rep, dim=2)  # (B, S, H, hd)
    vt = torch.repeat_interleave(cache_v, rep, dim=2)
    scale = _inv_sqrt(hd)
    # the query stays f32 after scaling here (chunked_attention casts it back)
    s = (q.float() * scale).transpose(1, 2) @ kt.float().permute(0, 2, 3, 1)  # (B, H, 1, S)
    idx = torch.arange(s_max, device=dev)
    if window > 0:
        # ring buffer: slot i holds absolute position (filled gradually)
        abs_pos = torch.where(idx <= slot, pos - (slot - idx), pos - (slot + s_max - idx))
        ok = (abs_pos >= 0) & (abs_pos > pos - max(window, 1)) & (abs_pos <= pos)
    else:
        ok = idx <= pos
    s = torch.where(ok[None, None, None, :], s, -math.inf)
    w = torch.softmax(s, dim=-1).to(vt.dtype)
    o = w.float() @ vt.float().transpose(1, 2)  # (B, H, 1, hd)
    o = o.transpose(1, 2).reshape(b, 1, h * hd).to(x.dtype)
    return o @ p.wo, cache_k, cache_v


# --------------------------------------------------------------------------
# cross-attention over an encoder's output (whisper's decoder)
# --------------------------------------------------------------------------
def cross_attn_apply(p, x, cfg, k, v):
    """Full-sequence cross-attention (train / prefill) over an encoder's
    (B, S_enc, K, hd) keys and values (``attn_qkv(p, enc_out, cfg, None,
    with_rope=False)``): every query over every frame, no rope."""
    b, s, _ = x.shape
    q = attn_q(p, x, cfg)
    o = chunked_attention(q, k, v, causal=False)
    return o.reshape(b, s, cfg.n_heads * cfg.d_head) @ p.wo


def cross_attn_decode(p, x, cfg, k, v):
    """Single-token cross-attention. x: (B, 1, d); k/v: (B, S_enc, K, hd),
    written once by the prefill.  The reference's decode form: one f32
    softmax over all frames (kv heads repeated to the query heads), its
    weights cast to bf16 before the value product."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.d_head
    q = attn_q(p, x, cfg)
    rep = h // cfg.n_kv_heads
    kt = torch.repeat_interleave(k, rep, dim=2)  # (B, S_enc, H, hd)
    vt = torch.repeat_interleave(v, rep, dim=2)
    s = (q.float() * _inv_sqrt(hd)).transpose(1, 2) @ kt.float().permute(0, 2, 3, 1)
    w = torch.softmax(s, dim=-1).to(vt.dtype)  # (B, H, 1, S_enc)
    o = w.float() @ vt.float().transpose(1, 2)  # (B, H, 1, hd)
    return o.transpose(1, 2).reshape(b, 1, h * hd).to(x.dtype) @ p.wo
