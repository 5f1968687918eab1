"""Mixture-of-experts block (Mixtral / DeepSeek-V2 routed experts).

Top-k softmax routing with capacity-factor token dropping, GShard-style,
in the reference's *sort/scatter* formulation (`repro.models.moe`): the
position of a token in its expert comes from a stable argsort by expert
id (token order kept within an expert), the kept tokens are copied into
the (E·C, d) expert buffer and gathered back at combine.

The reference scatter-adds into that buffer; its kept destinations are
unique and only the discarded overflow row ``E·C`` ever sums.  Here every
slot is copied (`index_copy`) with its dropped rows zeroed first, so the
overflow row stays zero and no float atomics run: the result is the
reference's, and the same on every run.

The top-k is a stable descending sort, so that at an exact tie the lower
expert id comes first, as in `jax.lax.top_k` (`torch.topk` leaves the
order at ties unspecified).

Shared experts (DeepSeek) run densely beside the routed path.
Aux losses: load-balance (Switch) + router z-loss, both returned, with
the dropped share of the token-expert slots.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.axes import constrain
from repro_torch.models.layers import MLP, _param, dense_init, mlp


class MoE(nn.Module):
    """``router`` (d, E) in f32, the experts' ``wi``/``wg`` (E, d, ff) and
    ``wo`` (E, ff, d), and ``shared``, a plain `MLP` of width
    ``ff · n_shared_experts``, where the config has shared experts.  The
    experts' init scale is 1/sqrt(E) (`dense_init`'s axis 0), as in the
    reference."""

    def __init__(self, cfg, generator=None, *, device=None):
        super().__init__()
        e, d = cfg.n_experts, cfg.d_model
        ff = cfg.d_ff_expert or cfg.d_ff
        self.router = _param(dense_init(generator, (d, e), dtype=torch.float32, device=device))
        self.wi = _param(dense_init(generator, (e, d, ff), device=device))
        self.wg = _param(dense_init(generator, (e, d, ff), device=device))
        self.wo = _param(dense_init(generator, (e, ff, d), device=device))
        self.shared = (MLP(d, ff * cfg.n_shared_experts, generator, device=device)
                       if cfg.n_shared_experts else None)


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens (the reference's expression)."""
    return max(8, int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))


def route(p: MoE, xt, cfg):
    """Router of (T, d) tokens → (f32 logits (T, E), probs (T, E),
    renormalised gates (T, k), expert ids (T, k))."""
    logits = xt.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gates, idx


def dispatch(idx, e: int, cap: int):
    """Expert ids (T, k) → (counts (E,), keep (T·k,), dest (T·k,)): each
    token-expert slot's row in the (E·cap + 1)-row buffer, the last row
    for a slot past its expert's capacity."""
    tk = idx.numel()
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    seg_start = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(tk, device=idx.device) - seg_start[sorted_e]
    pos = torch.empty_like(flat_e).scatter_(0, order, rank_sorted)
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, e * cap)
    return counts, keep, dest


def moe_apply(p: MoE, x, cfg):
    """x: (B, S, d) → (y, {"lb_loss", "z_loss", "drop_frac"})."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    # on a mesh the sequence dim is gathered first (the identity off a
    # mesh): `DTensor` misplaces the model axis where the backward
    # unflattens (B·S) to (B, S) with fewer batch rows than data-and-model
    # ranks
    xt = constrain(x, "batch", None, None).reshape(t, d)
    logits, probs, gates, idx = route(p, xt, cfg)

    # ---- capacity + position-in-expert (sort-based, no T×E tensors)
    cap = capacity(cfg, t)
    counts, keep, dest = dispatch(idx, e, cap)

    # ---- dispatch: copy the kept slots into the (E*C, d) expert buffer
    x_rep = torch.repeat_interleave(xt, k, dim=0).masked_fill(~keep[:, None], 0)  # (T*k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device).index_copy(
        0, dest, x_rep)
    # EP × DP sharding of the expert buffers on a mesh: experts on
    # "model", the capacity dim on the DP axes (`distributed.axes`)
    expert_in = constrain(buf[:-1].reshape(e, cap, d), "model", "batch", None)

    # ---- expert FFN: bf16 batched products, f32 accumulation
    h = nn.functional.silu(torch.bmm(expert_in, p.wg)) * torch.bmm(expert_in, p.wi)
    h = constrain(h, "model", "batch", None)
    expert_out = constrain(torch.bmm(h, p.wo), "model", "batch", None).reshape(e * cap, d)
    expert_out = torch.cat([expert_out, expert_out.new_zeros((1, d))])

    # ---- combine: gather back + gate
    back = expert_out[dest]  # (T*k, d)
    back = back * (gates.reshape(-1, 1) * keep[:, None]).to(back.dtype)
    y = back.reshape(t, k, d).sum(dim=1)

    if p.shared is not None:
        y = y + mlp(p.shared, xt)

    # ---- aux losses / metrics
    frac_tokens = counts.float() / (t * k)
    mean_probs = probs.mean(dim=0)
    aux = {
        "lb_loss": e * torch.sum(frac_tokens * mean_probs),
        "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "drop_frac": 1.0 - keep.float().mean(),
    }
    return y.reshape(b, s, d).to(x.dtype), aux

