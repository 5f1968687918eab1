"""Mamba-2 SSD block (state-space duality, chunked matmul form).

The SSD algorithm evaluates the selective state-space recurrence as
block matrices (`repro.models.ssd`): within a chunk of Q tokens the
token-token interaction is a (Q × Q) decay-masked "attention"; across
chunks a single (H, P, N) state is carried by a short loop (L/Q steps).
It is the same math as the sequential recurrence that decode steps
(`ssd_decode`, an O(1) state update).  The chunk products are f32
einsums: `pin_f32_accumulation` keeps them off TF32 on the card.  The
SiLU is `jax.nn.silu` op by op (`layers.silu`).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import RMSNorm, _param, dense_init, rmsnorm, silu, softplus
from repro_torch.models.rglru import causal_conv


def ssd_dims(cfg):
    """(d_inner, heads, head dim, groups, state size)."""
    din = cfg.ssm_expand * cfg.d_model
    h = din // cfg.ssm_head_dim
    return din, h, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


class SSD(nn.Module):
    """``win`` (d, 2·din + 2·g·n + h) → [z, x, B, C, dt], the depthwise
    ``conv`` (cw, din + 2·g·n), ``a_log`` = log(1..h), ``d_skip`` ones and
    ``dt_bias`` zeros (all three (h,) f32), the gated ``norm`` over din
    and ``wout`` (din, d)."""

    def __init__(self, cfg, generator=None, *, device=None):
        super().__init__()
        d = cfg.d_model
        din, h, _, g, n = ssd_dims(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        self.win = _param(dense_init(generator, (d, 2 * din + 2 * g * n + h), device=device))
        self.conv = _param(dense_init(generator, (cfg.conv1d_width, din + 2 * g * n),
                                      device=device))
        self.a_log = _param(torch.log(torch.arange(1, h + 1, **f32)))
        self.d_skip = _param(torch.ones((h,), **f32))
        self.dt_bias = _param(torch.zeros((h,), **f32))
        self.norm = RMSNorm(din, device=device)
        self.wout = _param(dense_init(generator, (din, d), device=device))


def _split_in(p: SSD, x, cfg):
    din, h, _, g, n = ssd_dims(cfg)
    zxbcdt = x @ p.win
    return zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * g * n], zxbcdt[..., -h:]


def _conv(p: SSD, xbc, state=None):
    out, new_state = causal_conv(p.conv, xbc, state)
    return silu(out), new_state


def _segsum(dA):
    """(..., Q) → (..., Q, Q) decay log-sums from j to i (the sum of dA
    over (j, i], cs_i − cs_j), −inf above the diagonal so that exp gives
    exact zeros there."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, -math.inf)


def ssd_scan(xh, dt, bmat, cmat, a_log, chunk):
    """Chunked SSD core.

    xh: (B, L, H, P); dt: (B, L, H) (post-softplus); bmat/cmat: (B, L, G, N).
    Returns (y (B, L, H, P), final_state (B, H, P, N)), f32.
    """
    b, l, h, p_ = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    q = min(chunk, l)
    nc = l // q
    assert l % q == 0, "sequence must be chunk-multiple (padded by caller)"
    rep = h // g

    xc = xh.reshape(b, nc, q, h, p_).float()
    dtc = dt.reshape(b, nc, q, h).float()
    bc = torch.repeat_interleave(bmat.reshape(b, nc, q, g, n), rep, dim=3).float()
    cc = torch.repeat_interleave(cmat.reshape(b, nc, q, g, n), rep, dim=3).float()

    a = -torch.exp(a_log)  # (H,) negative decay rates
    dA = dtc * a  # (B, C, Q, H)
    dA_cs = torch.cumsum(dA, dim=2)  # within-chunk cumulative
    dA_total = dA_cs[:, :, -1]  # (B, C, H)

    # ---- intra-chunk (diagonal blocks): decay-masked QK-style matmul
    att = torch.exp(_segsum(dA.transpose(2, 3)))  # (B, C, H, Q, Q) causal decay mask
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)  # C·B^T
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores * att, dtc, xc)

    # ---- chunk states: contribution of each chunk to the carried state
    decay_out = torch.exp(dA_total[:, :, None, :] - dA_cs)  # (B, C, Q, H)
    states = torch.einsum("bcqhn,bcqh,bcqh,bcqhp->bchpn", bc, dtc, decay_out, xc)

    # ---- inter-chunk recurrence; each chunk reads the state before it
    state = torch.zeros((b, h, p_, n), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(dA_total[:, c])[:, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, C, H, P, N)

    # ---- off-diagonal: previous state read out through C with in-chunk decay
    decay_in = torch.exp(dA_cs)  # (B, C, Q, H)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cc, prev_states, decay_in)

    y = (y_diag + y_off).reshape(b, l, h, p_)
    return y, state


def ssd_apply(p: SSD, x, cfg, *, conv_state=None, ssm_state=None):
    """Full-sequence apply. Returns (out, (conv_state, ssm_state)).  The
    sequence is padded to a chunk multiple with ``dt = 0`` steps, which
    decay by exp(0) = 1 and add 0: the final state is the true length's."""
    b, l, _ = x.shape
    din, h, p_, g, n = ssd_dims(cfg)
    z, xbc, dt = _split_in(p, x, cfg)
    xbc, conv_state_new = _conv(p, xbc, conv_state)
    xh = xbc[..., :din].reshape(b, l, h, p_)
    bmat = xbc[..., din:din + g * n].reshape(b, l, g, n)
    cmat = xbc[..., din + g * n:].reshape(b, l, g, n)
    dt = softplus(dt.float() + p.dt_bias)
    q = cfg.ssm_chunk
    pad = (-l) % q
    if pad:
        xh, bmat, cmat = (nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, bmat, cmat))
        dt = nn.functional.pad(dt, (0, 0, 0, pad))
    if ssm_state is not None:
        # train and prefill start from a zero state (the reference's assert)
        raise NotImplementedError("prefill continuation not required")
    y, final = ssd_scan(xh, dt, bmat, cmat, p.a_log, q)
    y = y[:, :l]
    y = y + p.d_skip[None, None, :, None] * xbc[..., :din].reshape(b, l, h, p_).float()
    y = y.reshape(b, l, din).to(x.dtype) * silu(z)
    y = rmsnorm(p.norm, y, cfg.norm_eps)
    return y @ p.wout, (conv_state_new, final)


def ssd_decode(p: SSD, x, cfg, conv_state, ssm_state):
    """Single-token decode: O(1) state update (the sequential recurrence);
    the states are carried, not written."""
    b = x.shape[0]
    din, h, p_, g, n = ssd_dims(cfg)
    z, xbc, dt = _split_in(p, x, cfg)
    xbc, conv_state = _conv(p, xbc, conv_state)
    xh = xbc[..., :din].reshape(b, h, p_).float()
    bmat = torch.repeat_interleave(xbc[..., din:din + g * n].reshape(b, g, n), h // g, dim=1)
    cmat = torch.repeat_interleave(xbc[..., din + g * n:].reshape(b, g, n), h // g, dim=1)
    dt1 = softplus(dt[:, 0].float() + p.dt_bias)  # (B, H)
    decay = torch.exp(dt1 * -torch.exp(p.a_log)[None, :])  # (B, H)
    upd = torch.einsum("bhn,bh,bhp->bhpn", bmat.float(), dt1, xh)
    new_state = ssm_state * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", cmat.float(), new_state)
    y = y + p.d_skip[None, :, None] * xh
    y = y.reshape(b, 1, din).to(x.dtype) * silu(z)
    y = rmsnorm(p.norm, y, cfg.norm_eps)
    return y @ p.wout, (conv_state, new_state)
