"""Model assembly: decoder LMs, enc-dec (whisper), VLM (internvl) — every
family of the reference behind its API.

  init_params(cfg, generator, device)       → LM (an nn.Module)
  param_tree(params)                        → its parameters as a nested tree
  forward(cfg, params, tokens, ...)         → (logits, aux)
  loss_fn(cfg, params, batch)               → (scalar, metrics)
  prefill(cfg, params, tokens, max_len, ...) → (logits, cache)
  decode_step(cfg, params, cache, tok, pos) → (logits, cache)

The reference (`repro.models.lm`) stacks each pattern slot's parameters
across units for one `lax.scan`; here the blocks are an `nn.ModuleList`
in layer order (layer ``u·period + j`` is unit u's slot j) and the scan
is a Python loop.  DeepSeek's leading dense layers (attention + a plain
MLP of width ``d_ff``) are the `nn.ModuleList` ``lead``, run before the
blocks.  A ragged pattern's padded tail slots are inactive blocks
(residual pass-through).  The decode cache is preallocated per layer
(the lead's first) and written in place: K/V (or MLA's compressed
pair) for attention, a bf16 conv ring and an f32 recurrent state for
the RG-LRU and SSD blocks.

The families: dense; MoE (``"attn"`` and ``"moe"`` blocks, MLA, the
leading dense layers, the sliding window); the hybrid (recurrentgemma:
``"rglru"`` blocks beside local MQA attention); the SSM (mamba2:
``"ssd"`` blocks, which have no MLP); the encoder-decoder (whisper: an
`Encoder` of non-causal attention blocks over precomputed frame
embeddings, ``enc_frames``, and after each decoder block a
`CrossAttention` over its output, whose K/V the prefill writes into each
layer's cache once); and the VLM (internvl: precomputed image
embeddings, ``img_embeds``, prepended to the text, positions running
over both, the image positions stripped from the forward's output).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.axes import constrain
from repro_torch.models import mla, moe, rglru, ssd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    DTYPE,
    MLP,
    Attention,
    Embedding,
    RMSNorm,
    attn_apply,
    attn_decode,
    attn_qkv,
    cross_attn_apply,
    cross_attn_decode,
    dense_init,
    embed,
    mlp,
    pin_f32_accumulation,
    remat,
    rmsnorm,
)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
class Block(nn.Module):
    """Residual block: ``x + mix(norm1(x))``, then ``x + ffn(norm2(x))``.
    The mix is an `RGLRU` or an `SSD` for those kinds, else `MLA` where
    the config has a kv rank, else GQA attention; the ffn is an `MoE` for
    kind ``"moe"``, else a plain MLP of width ``d_ff``.  An ``"ssd"``
    block has no ``norm2`` and no ffn (mamba2's block is its mixer).
    ``active`` False is a padded tail slot of a ragged pattern (the
    reference's inactive-tail gate).  Another kind raises `ValueError`,
    as the reference's ``_mix_init`` does."""

    def __init__(self, cfg: ModelConfig, kind: str, active: bool, generator=None, *,
                 device=None):
        super().__init__()
        if kind not in ("attn", "moe", "rglru", "ssd"):
            raise ValueError(kind)
        d = cfg.d_model
        self.kind = kind
        self.active = active
        self.norm1 = RMSNorm(d, cfg.norm_eps, device=device)
        mix = {"rglru": rglru.RGLRU, "ssd": ssd.SSD}.get(
            kind, mla.MLA if cfg.is_mla else Attention)
        self.mix = mix(cfg, generator, device=device)
        if kind == "ssd":
            self.norm2 = self.ffn = None
            return
        self.norm2 = RMSNorm(d, cfg.norm_eps, device=device)
        self.ffn = (moe.MoE(cfg, generator, device=device) if kind == "moe"
                    else MLP(d, cfg.d_ff, generator, device=device))


def _gated(x, h, active: bool):
    """``x + gate·h``: the reference's traced 0/1 gate; 1·h is h exactly."""
    return x + h if active else x + h * 0


def _mix_apply(p: Block, h, cfg, *, causal=True, positions=None):
    """Full-sequence mixer. Returns (out, cache contribution)."""
    if p.kind == "rglru":
        return rglru.rglru_apply(p.mix, h, cfg)
    if p.kind == "ssd":
        return ssd.ssd_apply(p.mix, h, cfg)
    if cfg.is_mla:
        return mla.mla_apply(p.mix, h, cfg, positions=positions)
    window = cfg.window if cfg.window > 0 else 0
    return attn_apply(p.mix, h, cfg, causal=causal, window=window, positions=positions)


def _ffn(p: Block, h, cfg):
    """The block's ffn on ``h`` → (out, the router's aux or None)."""
    if p.kind == "moe":
        return moe.moe_apply(p.ffn, h, cfg)
    return mlp(p.ffn, h), None


def _block_apply(p: Block, x, cfg, *, causal=True, positions=None):
    """Residual block. Returns (x, cache contribution, aux): the router's
    ``lb_loss`` and ``z_loss`` scaled by the slot's gate, None without
    experts."""
    h, kv = _mix_apply(p, rmsnorm(p.norm1, x, cfg.norm_eps), cfg, causal=causal,
                       positions=positions)
    x = _gated(x, h, p.active)
    if p.kind == "ssd":
        return x, kv, None
    out, aux = _ffn(p, rmsnorm(p.norm2, x, cfg.norm_eps), cfg)
    if aux is not None:
        aux = {k: aux[k] if p.active else aux[k] * 0 for k in ("lb_loss", "z_loss")}
    return _gated(x, out, p.active), kv, aux


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


class Encoder(nn.Module):
    """whisper's encoder: ``n_enc_layers`` attention blocks (non-causal,
    with rope), a final ``norm`` and learned positions ``pos``
    (enc_positions, d) added to the frames."""

    def __init__(self, cfg: ModelConfig, generator=None, *, device=None):
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(Block(cfg, "attn", True, generator, device=device)
                                    for _ in range(cfg.n_enc_layers))
        self.norm = RMSNorm(d, cfg.norm_eps, device=device)
        self.pos = nn.Parameter(dense_init(generator, (cfg.enc_positions, d), device=device),
                                requires_grad=False)


class CrossAttention(nn.Module):
    """A decoder layer's cross-attention: ``x + attn(norm(x))`` over the
    encoder's output, GQA attention without rope."""

    def __init__(self, cfg: ModelConfig, generator=None, *, device=None):
        super().__init__()
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = Attention(cfg, generator, device=device)


class LM(nn.Module):
    """Embedding, the blocks in layer order (after the ``lead`` layers),
    the final norm and (untied) the ``(d, vocab)`` head; for the
    encoder-decoder also the `Encoder` and one `CrossAttention` a decoder
    layer (``cross``).  ``generator`` None leaves the weights
    uninitialised for the carry to fill."""

    def __init__(self, cfg: ModelConfig, generator=None, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        period, n_units, active = _units(cfg)
        self.embed = Embedding(cfg.vocab, d, generator, device=device)
        self.final_norm = RMSNorm(d, cfg.norm_eps, device=device)
        head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init(generator, (d, cfg.vocab), device=device), requires_grad=False)
        self.register_parameter("head", head)
        self.blocks = nn.ModuleList(
            Block(cfg, kind, active[u][j], generator, device=device)
            for u in range(n_units) for j, kind in enumerate(cfg.block_pattern)
        )
        # deepseek: leading dense layers (attention + plain MLP); whisper:
        # the encoder and the cross-attentions.  No submodule elsewhere, so
        # that the other families' trees are unchanged
        self.lead = nn.ModuleList(
            Block(cfg, "attn", True, generator, device=device)
            for _ in range(cfg.first_dense_layers)) if cfg.first_dense_layers else ()
        self.encoder, self.cross = None, ()
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, generator, device=device)
            self.cross = nn.ModuleList(CrossAttention(cfg, generator, device=device)
                                       for _ in range(cfg.n_layers))

    def forward(self, tokens, img_embeds=None, enc_frames=None):
        return forward(self.cfg, self, tokens, img_embeds=img_embeds, enc_frames=enc_frames)[0]


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
    "ffn"}, ...], "lead"?: [...]}`` for the LM.  The optimizer state and
    the checkpoint paths (``blocks/0/mix/wq``) follow it."""
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


def _unit(cfg, blocks, positions, x, lb, zl, crosses=(), enc_out=None):
    """One pattern unit's blocks, each followed by its cross-attention
    over ``enc_out`` where ``crosses`` has one (whisper's decoder), else
    by the sequence-parallel constraint (the reference's scan places none
    in whisper's decoder)."""
    for i, blk in enumerate(blocks):
        x, _, aux = _block_apply(blk, x, cfg, positions=positions)
        if aux is not None:
            lb, zl = lb + aux["lb_loss"], zl + aux["z_loss"]
        if crosses:
            x = x + _cross_apply(crosses[i], x, cfg, *_cross_kv(crosses[i], enc_out, cfg))
        else:
            x = constrain(x, "batch", "seq", None)
    return x, lb, zl


def _cross_kv(xp: CrossAttention, enc_out, cfg):
    """The encoder output's (B, S_enc, K, hd) keys and values, no rope."""
    return attn_qkv(xp.attn, enc_out, cfg, None, with_rope=False)[1:]


def _cross_apply(xp: CrossAttention, x, cfg, k, v):
    return cross_attn_apply(xp.attn, rmsnorm(xp.norm, x, cfg.norm_eps), cfg, k, v)


def _encode(cfg, params: LM, frames):
    """The encoder over (B, S, d) frame embeddings: bf16 frames plus
    ``pos[:S]``, the non-causal attention blocks, then ``norm``."""
    enc = params.encoder
    x = frames.to(DTYPE) + enc.pos[None, :frames.shape[1]]
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for blk in enc.layers:
        x, *_ = _block_apply(blk, x, cfg, causal=False, positions=positions)
    return rmsnorm(enc.norm, x, cfg.norm_eps)


def _embed(cfg, params: LM, tokens, img_embeds):
    """The tokens' bf16 embeddings, after the image embeddings (the VLM)."""
    x = embed(params.embed, tokens).to(DTYPE)
    if cfg.family == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(DTYPE), x], dim=1)
    return x


def forward_hidden(cfg: ModelConfig, params: LM, tokens, *, img_embeds=None,
                   enc_frames=None, remat_units: bool = False):
    """Final-norm hidden states (B, S, d) for the token positions, and the
    aux losses: the router's ``lb_loss`` and ``z_loss`` summed over the
    blocks (zeros without experts).  tokens: (B, S) integers.  VLM:
    ``img_embeds`` (B, n_img, d) prepended (their positions are stripped
    from the output).  enc-dec: ``enc_frames`` (B, S_enc, d) precomputed
    frame embeddings (the conv frontend is a stub).  ``remat_units``
    checkpoints each pattern unit: its backward recomputes the unit's
    internals and only the bf16 carries are saved across layers (the
    reference's module flag ``REMAT_UNITS``, held per call here; the
    leading dense layers run outside the scan there, and unchecked here;
    whisper's decoder, whose scan there takes no remat, neither)."""
    pin_f32_accumulation()
    x = constrain(_embed(cfg, params, tokens, img_embeds), "batch", None, None)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    enc_out = _encode(cfg, params, enc_frames) if cfg.family == "encdec" else None
    for blk in params.lead:
        x, *_ = _block_apply(blk, x, cfg, positions=positions)
    lb = zl = torch.zeros((), dtype=torch.float32, device=x.device)
    period = len(cfg.block_pattern)
    # whisper's decoder units are not checkpointed: the reference's scan
    # over them (`_scan_decoder_with_cross`) takes no remat
    remat_units = remat_units and cfg.family != "encdec"
    for u in range(0, len(params.blocks), period):
        args = (cfg, params.blocks[u:u + period], positions, x, lb, zl,
                params.cross[u:u + period], enc_out)
        x, lb, zl = remat(_unit, *args) if remat_units else _unit(*args)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.family == "vlm" and img_embeds is not None:
        x = x[:, img_embeds.shape[1]:]
    return x, {"lb_loss": lb, "z_loss": zl}


def _head_table(cfg, params: LM):
    """The (d, vocab) output matrix: the embedding's transpose when tied."""
    return params.embed.table.t() if cfg.tie_embeddings else params.head


def _logits(cfg, params: LM, x):
    return x @ _head_table(cfg, params)


def forward(cfg: ModelConfig, params: LM, tokens, *, img_embeds=None, enc_frames=None):
    """Full-sequence token logits (test/serve path — materializes logits)."""
    x, aux = forward_hidden(cfg, params, tokens, img_embeds=img_embeds, enc_frames=enc_frames)
    return _logits(cfg, params, x), aux


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
CE_CHUNK = 1024  # sequence-chunked cross entropy (never materialize logits)


def _ce_chunk(hs, head, ts, vs, wn):
    """One chunk's weighted nll and z-loss sums: bf16 logits, f32 LSE."""
    logits = constrain((hs @ head).float(), "batch", None, "model")  # (B, C, V)
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
    """batch: {tokens, targets, loss_weights?, img_embeds?, enc_frames?}
    tensors → (loss, metrics).

    loss_weights (B,) are the PS³ data-plane partition weights (§2.4
    estimator applied to the training objective: weighted per-sequence
    CE).  ``remat_units`` checkpoints each unit (`forward_hidden`).
    """
    h, aux = forward_hidden(cfg, params, batch["tokens"], img_embeds=batch.get("img_embeds"),
                            enc_frames=batch.get("enc_frames"), remat_units=remat_units)
    h = constrain(h, "batch", None, None)  # un-shard S before the CE chunking
    loss, zl = chunked_ce(h, _head_table(cfg, params), batch["targets"],
                          batch.get("loss_weights"))
    total = loss + cfg.router_aux_coef * aux["lb_loss"] + 1e-4 * (aux["z_loss"] + zl)
    return total, {"ce": loss, **aux}


# --------------------------------------------------------------------------
# serve path: prefill + decode
# --------------------------------------------------------------------------
def _layers(params: LM) -> list[Block]:
    """The leading dense layers, then the blocks: layer order."""
    return [*params.lead, *params.blocks]


def _layer_cache(cfg, kind: str, batch: int, max_len: int, device) -> dict:
    """Zeros with the reference's names and dtypes: ``{"conv", "rec"}``
    ((B, cw-1, w) bf16, (B, w) f32) for an RG-LRU block, ``{"conv",
    "ssm"}`` ((B, cw-1, din+2gn) bf16, (B, h, p, n) f32) for an SSD block,
    ``{"ckv", "kpe"}`` (B, max_len, rank) for MLA, else a ``{"k", "v"}``
    pair of (B, S, K, hd); S is ``min(max_len, window)`` for
    sliding-window attention (a ring)."""
    def zeros(shape, dtype=DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind == "rglru":
        w = cfg.rglru_width or cfg.d_model
        return {"conv": zeros((batch, cfg.conv1d_width - 1, w)),
                "rec": zeros((batch, w), torch.float32)}
    if kind == "ssd":
        din, h, p_, g, n = ssd.ssd_dims(cfg)
        return {"conv": zeros((batch, cfg.conv1d_width - 1, din + 2 * g * n)),
                "ssm": zeros((batch, h, p_, n), torch.float32)}
    if cfg.is_mla:
        return {"ckv": zeros((batch, max_len, cfg.kv_lora_rank)),
                "kpe": zeros((batch, max_len, cfg.qk_rope_head_dim))}
    s = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.d_head)
    return {"k": zeros(shape), "v": zeros(shape)}


def _kinds(cfg) -> list[str]:
    """Each layer's block kind in layer order (the leading dense layers
    first, then the pattern over every unit, padded slots included)."""
    _, n_units, _ = _units(cfg)
    return ["attn"] * cfg.first_dense_layers + list(cfg.block_pattern) * n_units


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> list[dict]:
    """One cache per layer, in layer order (the leading dense layers'
    first): `_layer_cache`; a decoder layer of the encoder-decoder also
    holds its cross-attention's ``cross_k``/``cross_v`` (B, enc_positions,
    K, hd), zeros until the prefill writes the encoder's."""
    caches = [_layer_cache(cfg, kind, batch, max_len, device) for kind in _kinds(cfg)]
    if cfg.family == "encdec":
        shape = (batch, cfg.enc_positions, cfg.n_kv_heads, cfg.d_head)
        for c in caches:
            c["cross_k"], c["cross_v"] = (torch.zeros(shape, dtype=DTYPE, device=device)
                                          for _ in range(2))
    return caches


def _crosses(params: LM) -> list:
    """Each layer's `CrossAttention` (whisper's decoder), None elsewhere."""
    return list(params.cross) or [None] * len(_layers(params))


def _mix_decode(p: Block, h, cfg, c: dict, pos: int):
    if p.kind == "rglru":
        out, st = rglru.rglru_decode(p.mix, h, cfg, c["conv"], c["rec"])
        _store_cache(cfg, p.kind, c, st)
        return out
    if p.kind == "ssd":
        out, st = ssd.ssd_decode(p.mix, h, cfg, c["conv"], c["ssm"])
        _store_cache(cfg, p.kind, c, st)
        return out
    if cfg.is_mla:
        return mla.mla_decode(p.mix, h, cfg, c["ckv"], c["kpe"], pos)[0]
    return attn_decode(p.mix, h, cfg, c["k"], c["v"], pos, window=cfg.window)[0]


def decode_step(cfg: ModelConfig, params: LM, cache: list[dict], tokens, pos: int):
    """One decode step. tokens: (B, 1); pos: the absolute position.

    Writes the token's cache entries (and the recurrent blocks' states)
    into ``cache`` in place; returns (logits (B, 1, V), cache).  An
    inactive tail slot runs and writes its cache, its output gated by 0,
    as in the reference.  An MoE block routes the B tokens of the step
    (its capacity is that of B tokens).  A decoder layer with a
    cross-attention runs it after the MLP, over the cache's
    ``cross_k``/``cross_v``.  ``pos`` counts a VLM's image positions.
    """
    pin_f32_accumulation()
    x = embed(params.embed, tokens).to(DTYPE)
    for blk, xp, c in zip(_layers(params), _crosses(params), cache):
        out = _mix_decode(blk, rmsnorm(blk.norm1, x, cfg.norm_eps), cfg, c, pos)
        x = _gated(x, out, blk.active)
        if blk.kind != "ssd":
            x = _gated(x, _ffn(blk, rmsnorm(blk.norm2, x, cfg.norm_eps), cfg)[0], blk.active)
        if xp is not None:
            h = rmsnorm(xp.norm, x, cfg.norm_eps)
            x = x + cross_attn_decode(xp.attn, h, cfg, c["cross_k"], c["cross_v"])
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: LM, tokens, max_len: int, *, img_embeds=None,
            enc_frames=None):
    """Process a prompt, building the decode cache.  Returns (logits, cache)
    with the logits of every prompt position (a VLM's image positions
    first: its cache holds them too).  Inactive tail slots are skipped and
    keep a zero cache (the reference's).  The encoder-decoder encodes
    ``enc_frames`` once and writes each decoder layer's cross K/V."""
    pin_f32_accumulation()
    x = _embed(cfg, params, tokens, img_embeds)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    cache = init_cache(cfg, b, max_len, x.device)
    if cfg.family == "encdec":
        enc_out = _encode(cfg, params, enc_frames)
        for xp, c in zip(params.cross, cache):
            c["cross_k"], c["cross_v"] = _cross_kv(xp, enc_out, cfg)
    for blk, xp, c in zip(_layers(params), _crosses(params), cache):
        if not blk.active:
            continue
        out, st = _mix_apply(blk, rmsnorm(blk.norm1, x, cfg.norm_eps), cfg, positions=positions)
        x = x + out
        if blk.kind != "ssd":
            x = x + _ffn(blk, rmsnorm(blk.norm2, x, cfg.norm_eps), cfg)[0]
        if xp is not None:
            x = x + _cross_apply(xp, x, cfg, c["cross_k"], c["cross_v"])
        _store_cache(cfg, blk.kind, c, st)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return _logits(cfg, params, x), cache


def _store_cache(cfg, kind: str, slot_cache: dict, st) -> None:
    """Write a prompt's cache entries: the recurrent blocks' conv ring and
    state (after each decode step too), or at slot 0 MLA's ``(c_kv,
    k_rope)`` or K/V.  A windowed cache keeps the last ``w`` keys there,
    which agrees with `attn_decode`'s ``pos % w`` ring only for a prompt
    no longer than the window (the reference's "prompt ≤ window in our
    shapes"; `ROADMAP.md` § 3)."""
    if kind in ("rglru", "ssd"):
        conv, state = st
        slot_cache["conv"].copy_(conv)
        slot_cache["rec" if kind == "rglru" else "ssm"].copy_(state)
        return
    if cfg.is_mla:
        ckv, kpe = st
        slot_cache["ckv"][:, :ckv.shape[1]] = ckv
        slot_cache["kpe"][:, :kpe.shape[1]] = kpe
        return
    k, v = st
    if cfg.window > 0:
        w = slot_cache["k"].shape[1]
        k, v = k[:, -w:], v[:, -w:]
    slot_cache["k"][:, :k.shape[1]] = k
    slot_cache["v"][:, :v.shape[1]] = v
