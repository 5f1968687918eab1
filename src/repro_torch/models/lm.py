"""Model assembly: the dense decoder LM behind the reference's API.

  init_params(cfg, generator, device)       → LM (an nn.Module)
  param_tree(params)                        → its parameters as a nested tree
  forward(cfg, params, tokens)              → (logits, aux)
  loss_fn(cfg, params, batch)               → (scalar, metrics)
  prefill(cfg, params, tokens, max_len)     → (logits, cache)
  decode_step(cfg, params, cache, tok, pos) → (logits, cache)

The reference (`repro.models.lm`) stacks each pattern slot's parameters
across units for one `lax.scan`; here the blocks are an `nn.ModuleList`
in layer order (layer ``u·period + j`` is unit u's slot j) and the scan
is a Python loop.  The decode cache is preallocated per layer and written
in place.

Only the dense family (``block_pattern=("attn",)``, no experts, no MLA,
no leading dense layers, no encoder or image prefix) is ported: every
other block kind or family raises `NotImplementedError` at construction
(`ROADMAP.md` § 1 item 10).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    DTYPE,
    MLP,
    Attention,
    Embedding,
    RMSNorm,
    attn_apply,
    attn_decode,
    dense_init,
    embed,
    mlp,
    pin_f32_accumulation,
    remat,
    rmsnorm,
)


def check_ported(cfg: ModelConfig) -> None:
    """Raise unless every block of ``cfg`` is a dense attention block."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"family {cfg.family!r}")
    missing += [f"block kind {k!r}" for k in sorted(set(cfg.block_pattern) - {"attn"})]
    if cfg.is_moe:
        missing.append("experts")
    if cfg.is_mla:
        missing.append("MLA")
    if cfg.first_dense_layers:
        missing.append("leading dense layers")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet; only the dense family "
            "is (ROADMAP.md § 1 item 10 orders the rest)"
        )


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
class Block(nn.Module):
    """Residual dense attention block: ``x + mix(norm1(x))``, then
    ``x + ffn(norm2(x))``.  ``active`` False is a padded tail slot of a
    ragged pattern (the reference's inactive-tail gate)."""

    def __init__(self, cfg: ModelConfig, active: bool, generator=None, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.active = active
        self.norm1 = RMSNorm(d, cfg.norm_eps, device=device)
        self.mix = Attention(cfg, generator, device=device)
        self.norm2 = RMSNorm(d, cfg.norm_eps, device=device)
        self.ffn = MLP(d, cfg.d_ff, generator, device=device)


def _gated(x, h, active: bool):
    """``x + gate·h``: the reference's traced 0/1 gate; 1·h is h exactly."""
    return x + h if active else x + h * 0


def _block_apply(p: Block, x, cfg, *, causal=True, positions=None):
    """Residual block. Returns (x, (k, v))."""
    window = cfg.window if cfg.window > 0 else 0
    h, kv = attn_apply(p.mix, rmsnorm(p.norm1, x, cfg.norm_eps), cfg, causal=causal,
                       window=window, positions=positions)
    x = _gated(x, h, p.active)
    out = mlp(p.ffn, rmsnorm(p.norm2, x, cfg.norm_eps))
    return _gated(x, out, p.active), kv


# --------------------------------------------------------------------------
# unit (pattern period) machinery
# --------------------------------------------------------------------------
def _units(cfg: ModelConfig):
    period = len(cfg.block_pattern)
    n_scan = cfg.n_layers - cfg.first_dense_layers
    n_units = -(-n_scan // period)
    # active flags for the padded tail
    active = [[u * period + j < n_scan for j in range(period)] for u in range(n_units)]
    return period, n_units, active


class LM(nn.Module):
    """Embedding, the blocks in layer order, the final norm and (untied)
    the ``(d, vocab)`` head.  ``generator`` None leaves the weights
    uninitialised for the carry to fill."""

    def __init__(self, cfg: ModelConfig, generator=None, *, device=None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        d = cfg.d_model
        period, n_units, active = _units(cfg)
        self.embed = Embedding(cfg.vocab, d, generator, device=device)
        self.final_norm = RMSNorm(d, cfg.norm_eps, device=device)
        head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init(generator, (d, cfg.vocab), device=device), requires_grad=False)
        self.register_parameter("head", head)
        self.blocks = nn.ModuleList(
            Block(cfg, active[u][j], generator, device=device)
            for u in range(n_units) for j in range(period)
        )

    def forward(self, tokens):
        return forward(self.cfg, self, tokens)[0]


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> LM:
    """The model with weights drawn from ``generator`` on ``device``
    (the generator's device by default)."""
    return LM(cfg, generator, device=device if device is not None else generator.device)


def param_bytes(params: LM) -> int:
    return sum(p.numel() * p.element_size() for p in params.parameters())


def param_tree(module: nn.Module):
    """The module's parameters (the tensors themselves) as a nested tree:
    a dict per module, a list per `nn.ModuleList` — ``{"embed": {"table"},
    "final_norm": {"scale"}, "head"?, "blocks": [{"norm1", "mix", "norm2",
    "ffn"}, ...]}`` for the LM.  The optimizer state and the checkpoint
    paths (``blocks/0/mix/wq``) follow it."""
    if isinstance(module, nn.ModuleList):
        return [param_tree(m) for m in module]
    out = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = param_tree(child)
    return out


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _unit(cfg, blocks, positions, x):
    for blk in blocks:
        x, _ = _block_apply(blk, x, cfg, positions=positions)
    return x


def forward_hidden(cfg: ModelConfig, params: LM, tokens, *, remat_units: bool = False):
    """Final-norm hidden states (B, S, d) and the aux losses (zeros: no
    experts).  tokens: (B, S) integers.  ``remat_units`` checkpoints each
    pattern unit: its backward recomputes the unit's internals and only
    the bf16 carries are saved across layers (the reference's module
    flag ``REMAT_UNITS``, held per call here)."""
    pin_f32_accumulation()
    x = embed(params.embed, tokens).to(DTYPE)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    period = len(cfg.block_pattern)
    for u in range(0, len(params.blocks), period):
        blocks = params.blocks[u:u + period]
        if remat_units:
            x = remat(_unit, cfg, blocks, positions, x)
        else:
            x = _unit(cfg, blocks, positions, x)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"lb_loss": zero, "z_loss": zero}


def _head_table(cfg, params: LM):
    """The (d, vocab) output matrix: the embedding's transpose when tied."""
    return params.embed.table.t() if cfg.tie_embeddings else params.head


def _logits(cfg, params: LM, x):
    return x @ _head_table(cfg, params)


def forward(cfg: ModelConfig, params: LM, tokens):
    """Full-sequence token logits (test/serve path — materializes logits)."""
    x, aux = forward_hidden(cfg, params, tokens)
    return _logits(cfg, params, x), aux


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
CE_CHUNK = 1024  # sequence-chunked cross entropy (never materialize logits)


def _ce_chunk(hs, head, ts, vs, wn):
    """One chunk's weighted nll and z-loss sums: bf16 logits, f32 LSE."""
    logits = (hs @ head).float()  # (B, C, V)
    lse = torch.logsumexp(logits, dim=-1)  # (B, C)
    gold = torch.gather(logits, -1, ts[..., None].long())[..., 0]
    nll = (lse - gold) * vs[None, :]
    return (torch.sum(nll * wn[:, None]),
            torch.sum((lse * vs[None, :]) ** 2 * wn[:, None]))


def chunked_ce(h, head, targets, weights=None, chunk=CE_CHUNK):
    """Sequence-chunked softmax CE: (B,S,d)·(d,V) → scalar without ever
    holding the (B, S, V) f32 logits — per chunk bf16 logits + f32 LSE,
    rematerialized in the backward (`remat` around the chunk body).

    Returns (weighted mean nll, mean lse² for z-loss), both divided by
    ``S`` (not by the valid-token count), as the reference does.
    """
    b, s, d = h.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = nn.functional.pad(h, (0, 0, 0, pad))
        targets = nn.functional.pad(targets, (0, pad))
    nc = h.shape[1] // chunk
    valid = (torch.arange(h.shape[1], device=h.device) < s).float()
    w = (torch.ones((b,), dtype=torch.float32, device=h.device) if weights is None
         else weights.float())
    wn = w / torch.clamp_min(w.sum(), 1e-9)
    nll_sum = zl_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        nll, zl = remat(_ce_chunk, h[:, sl], head, targets[:, sl], valid[sl], wn)
        nll_sum, zl_sum = nll_sum + nll, zl_sum + zl
    return nll_sum / s, zl_sum / s


def loss_fn(cfg: ModelConfig, params: LM, batch, *, remat_units: bool = False):
    """batch: {tokens, targets, loss_weights?} tensors → (loss, metrics).

    loss_weights (B,) are the PS³ data-plane partition weights (§2.4
    estimator applied to the training objective: weighted per-sequence
    CE).  ``remat_units`` checkpoints each unit (`forward_hidden`).
    """
    h, aux = forward_hidden(cfg, params, batch["tokens"], remat_units=remat_units)
    loss, zl = chunked_ce(h, _head_table(cfg, params), batch["targets"],
                          batch.get("loss_weights"))
    total = loss + cfg.router_aux_coef * aux["lb_loss"] + 1e-4 * (aux["z_loss"] + zl)
    return total, {"ce": loss, **aux}


# --------------------------------------------------------------------------
# serve path: prefill + decode
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list[dict]:
    """One ``{"k", "v"}`` pair of (B, S, K, hd) zeros per layer; S is
    ``min(max_len, window)`` for sliding-window attention (a ring)."""
    check_ported(cfg)
    period, n_units, _ = _units(cfg)
    s = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
    return [{"k": torch.zeros(shape, dtype=DTYPE, device=device),
             "v": torch.zeros(shape, dtype=DTYPE, device=device)}
            for _ in range(n_units * period)]


def decode_step(cfg: ModelConfig, params: LM, cache: list[dict], tokens, pos: int):
    """One decode step. tokens: (B, 1); pos: the absolute position.

    Writes the token's K/V into ``cache`` in place; returns
    (logits (B, 1, V), cache).
    """
    pin_f32_accumulation()
    x = embed(params.embed, tokens).to(DTYPE)
    for blk, c in zip(params.blocks, cache):
        h = rmsnorm(blk.norm1, x, cfg.norm_eps)
        out, _, _ = attn_decode(blk.mix, h, cfg, c["k"], c["v"], pos, window=cfg.window)
        x = _gated(x, out, blk.active)
        x = _gated(x, mlp(blk.ffn, rmsnorm(blk.norm2, x, cfg.norm_eps)), blk.active)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: LM, tokens, max_len: int):
    """Process a prompt, building the decode cache.  Returns (logits, cache)
    with the logits of every prompt position."""
    pin_f32_accumulation()
    b, s = tokens.shape[0], tokens.shape[1]
    x = embed(params.embed, tokens).to(DTYPE)
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, max_len, x.device)
    window = cfg.window if cfg.window > 0 else 0
    for blk, c in zip(params.blocks, cache):
        if not blk.active:
            continue
        h = rmsnorm(blk.norm1, x, cfg.norm_eps)
        out, kv = attn_apply(blk.mix, h, cfg, window=window, positions=positions)
        x = x + out
        x = x + mlp(blk.ffn, rmsnorm(blk.norm2, x, cfg.norm_eps))
        _store_kv(cfg, c, kv)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(cfg, params, x), cache


def _store_kv(cfg, slot_cache: dict, kv) -> None:
    """Write a prompt's K/V at slot 0.  A windowed cache keeps the last
    ``w`` keys there, which agrees with `attn_decode`'s ``pos % w`` ring
    only for a prompt no longer than the window (the reference's "prompt ≤
    window in our shapes"; `ROADMAP.md` § 3)."""
    k, v = kv
    if cfg.window > 0:
        w = slot_cache["k"].shape[1]
        k, v = k[:, -w:], v[:, -w:]
    slot_cache["k"][:, :k.shape[1]] = k
    slot_cache["v"][:, :v.shape[1]] = v
