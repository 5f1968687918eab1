"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The temporal-mixing block of the hybrid architecture: a gated linear
recurrence  h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)  with
a_t = exp(−c·softplus(Λ)·r_t), whose gates r_t, i_t are block-diagonal
projections of the (causal-conv'd) input (`repro.models.rglru`).

Prefill evaluates the recurrence with a log-depth associative scan over
``(a, u)`` pairs (`associative_scan`: the odd/even recursion of
`jax.lax.associative_scan`, so the f32 products are taken in the
reference's order); decode is a constant-size state update (the
recurrence state and the conv ring).  The causal convolution is the
reference's bf16 sum in tap order, each product and add rounded to the
activations' dtype (`F.conv1d` would accumulate in f32 and round once),
and the GELU is `jax.nn.gelu`'s tanh form op by op (`layers.gelu`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import _param, dense_init, gelu, softplus

C_CONST = 8.0
NUM_GATE_BLOCKS = 4


class RGLRU(nn.Module):
    """``wx``/``wy`` (d, w), the depthwise ``conv`` (cw, w), the
    block-diagonal gates ``wr``/``wi`` (4, w/4, w/4), ``lam`` (w,) in
    f32, U[2, 4) at init (Λ), and ``wo`` (w, d)."""

    def __init__(self, cfg, generator=None, *, device=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru_width or d
        nb = NUM_GATE_BLOCKS
        bs = w // nb
        self.wx = _param(dense_init(generator, (d, w), device=device))
        self.wy = _param(dense_init(generator, (d, w), device=device))
        self.conv = _param(dense_init(generator, (cfg.conv1d_width, w), device=device))
        self.wr = _param(dense_init(generator, (nb, bs, bs), device=device))
        self.wi = _param(dense_init(generator, (nb, bs, bs), device=device))
        lam = torch.empty((w,), dtype=torch.float32, device=device)
        if generator is not None:
            lam = torch.rand((w,), generator=generator, dtype=torch.float32,
                             device=device) * 2.0 + 2.0
        self.lam = _param(lam)
        self.wo = _param(dense_init(generator, (w, d), device=device))


def _block_diag(p, x):
    b, s, w = x.shape
    nb = p.shape[0]
    xb = x.reshape(b, s, nb, w // nb)
    return torch.einsum("bsnj,njk->bsnk", xb, p).reshape(b, s, w)


def causal_conv(conv, x, state=None):
    """Depthwise causal conv. x: (B, S, W); state: (B, cw-1, W) history
    (zeros where None) → (out, the last cw-1 inputs).  The taps are summed
    in order in ``x``'s dtype, as the reference's Python ``sum`` does."""
    cw = conv.shape[0]
    hist = state if state is not None else x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([hist, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * conv[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + s] * conv[i]
    new_state = xp[:, -(cw - 1):] if cw > 1 else hist
    return out, new_state


def _gates(p: RGLRU, xb):
    r = torch.sigmoid(_block_diag(p.wr, xb).float())
    i = torch.sigmoid(_block_diag(p.wi, xb).float())
    log_a = -C_CONST * softplus(p.lam) * r  # (B, S, W) f32
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9))
    return a, beta * i * xb.float()


def _comb(l, r):
    """(a, u) ⊗ (a', u') = (a·a', a'·u + u'): the linear recurrence's
    composition, left element first."""
    return l[0] * r[0], r[0] * l[1] + r[1]


def _interleave(even, odd):
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, u):
    """Inclusive scan of ``_comb`` along dim 1 → (the products of ``a``,
    the states h).  `jax.lax.associative_scan`'s recursion: combine
    adjacent pairs, scan the half, then fold each even element into the
    odd prefix before it — log₂(L) levels of a few ops each."""
    n = a.shape[1]
    if n < 2:
        return a, u
    odd = associative_scan(*_comb((a[:, 0:n - 1:2], u[:, 0:n - 1:2]),
                                  (a[:, 1::2], u[:, 1::2])))
    prev = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _comb(prev, (a[:, 2::2], u[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1), torch.cat([u[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def rglru_apply(p: RGLRU, x, cfg, *, conv_state=None, rec_state=None):
    """Full-sequence apply. Returns (out, (conv_state, rec_state))."""
    xb = x @ p.wx
    yb = gelu(x @ p.wy)
    xb, conv_state_new = causal_conv(p.conv, xb, conv_state)
    a, u = _gates(p, xb)
    if rec_state is not None:  # fold carried state into step 0
        u = torch.cat([u[:, :1] + a[:, :1] * rec_state[:, None], u[:, 1:]], dim=1)
    _, h = associative_scan(a, u)
    rec_state_new = h[:, -1]
    out = (h.to(x.dtype) * yb) @ p.wo
    return out, (conv_state_new, rec_state_new)


def rglru_decode(p: RGLRU, x, cfg, conv_state, rec_state):
    """Single-token decode. x: (B, 1, d); states carried (not written)."""
    xb = x @ p.wx
    yb = gelu(x @ p.wy)
    xb, conv_state = causal_conv(p.conv, xb, conv_state)
    a, u = _gates(p, xb)  # (B, 1, W)
    h = a[:, 0] * rec_state + u[:, 0]
    out = (h[:, None].to(x.dtype) * yb) @ p.wo
    return out, (conv_state, h)
