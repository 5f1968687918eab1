"""AdamW in PyTorch with dtype-configurable (incl. int8-quantized) states.

The reference's `repro.train.optimizer`, on trees of tensors
(`repro_torch.train.tree`; `repro_torch.models.lm.param_tree` gives a
model's).  Parameters and state are updated in place: the model's own
tensors and the state's, which `apply_updates` returns.  The passed
state is consumed, as the reference's dry run donates it
(``donate_argnums=(0, 1)``): an update never holds the old and the new
moments at once.

`state_dtype`:
  * "float32"  — reference Adam moments.
  * "bfloat16" — halves optimizer memory; fine with Adam's EMA smoothing.
  * "int8"     — row-quantized moments: an ``(int8 q, f32 scale)`` pair of
    the parameter's shape, the scale over the last axis
    (``scale.shape[-1] == 1``).

Update math always runs in f32 — the schedule and the bias corrections
too (an int32 step, f32 powers: a Python-float schedule would be f64 and
move ``lr`` by an ulp); parameters keep their dtype (bf16: master-less,
no stochastic rounding, as in the reference).

The reference maps a layer-stacked leaf layer by layer (`lax.map`) to
bound its f32 temporaries; the port holds one tensor per block, and
updates a leaf of which one device holds more than ``UPDATE_CHUNK``
elements (a `DTensor`'s local shard, else the whole leaf) in slices
along its first axis (an expert stack, an embedding), each slice's
moments written into the state's slice.  Every op is elementwise or over the
last axis (the int8 scale), so the math is the same.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"  # float32 | bfloat16 | int8


# ---- schedule ---------------------------------------------------------------
def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine to 10% of ``peak_lr``; ``step`` an
    int32 tensor, the arithmetic f32 as the reference's."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.peak_lr * warm * (0.1 + 0.9 * cos)


# the most elements a leaf's update takes at once: its f32 temporaries
# (about ten of them) then stay near 5 GB for the largest leaves
UPDATE_CHUNK = 1 << 27


def _held(t: torch.Tensor) -> int:
    """The elements of ``t`` one device holds, and so its update's f32
    temporaries: a `DTensor`'s local shard, else all of them."""
    from torch.distributed.tensor import DTensor

    return (t.to_local() if isinstance(t, DTensor) else t).numel()


# ---- int8 row-wise quantization ---------------------------------------------
def _q8_encode(x: torch.Tensor):
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.round(x / scale).to(torch.int8)
    return q, scale.float()


def _q8_decode(q, scale, shape):
    return q.float() * scale


def _to_state_dtype(x, dtype: str):
    if dtype == "int8":
        return _q8_encode(x)
    return x.to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)


def _from_state_dtype(s, dtype: str, shape):
    if dtype == "int8":
        return _q8_decode(s[0], s[1], shape)
    return s.float()


# ---- optimizer --------------------------------------------------------------
def init_state(cfg: AdamWConfig, params):
    """{"m", "v": trees of zero moments in ``cfg.state_dtype``, "step": int32 0}."""
    def zeros(p):
        return _to_state_dtype(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                               cfg.state_dtype)

    device = leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _global_norm(tree) -> torch.Tensor:
    # square in the leaf dtype, accumulate f32 (the reference's form: no
    # whole-tree f32 copy)
    return torch.sqrt(sum(torch.sum(torch.square(x), dtype=torch.float32)
                          for x in leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step: ``params`` and ``state`` updated in place →
    (params, state, metrics {"grad_norm", "lr"}).

    The state is consumed: its ``m``/``v`` tensors (an int8 leaf's ``q``
    and ``scale`` too) and its ``step`` take the new values in their own
    storage, whole leaves and ``UPDATE_CHUNK`` slices alike, and the
    returned state is the same dict.  A caller that keeps the old state
    copies it first."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = _global_norm(grads)
    # a tensor numerator: torch's ``scalar / tensor`` is a reciprocal and a
    # product, two roundings where the reference divides once
    scale = torch.clamp_max(
        torch.full_like(gnorm, cfg.clip_norm) / torch.clamp_min(gnorm, 1e-12), 1.0)

    stepf = step.float()
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def store(dst, x):  # the new moment, in the state's dtype, into ``dst``
        tree_map(lambda d, s: d.copy_(s), dst, _to_state_dtype(x, cfg.state_dtype))

    def block(p, g, m_s, v_s):
        g = g.float() * scale
        m = _from_state_dtype(m_s, cfg.state_dtype, p.shape)
        v = _from_state_dtype(v_s, cfg.state_dtype, p.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        pf = p.float()
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf)
        p.copy_(pf)
        store(m_s, m)
        store(v_s, v)

    def upd(p, g, m_s, v_s):
        if p.dim() < 2 or _held(p) <= UPDATE_CHUNK:
            block(p, g, m_s, v_s)
            return
        rows = max(1, UPDATE_CHUNK // p[0].numel())
        for i in range(0, p.shape[0], rows):
            sl = slice(i, i + rows)
            block(p[sl], g[sl], tree_map(lambda s: s[sl], m_s), tree_map(lambda s: s[sl], v_s))

    tree_map(upd, params, grads, state["m"], state["v"])
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
