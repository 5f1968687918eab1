"""Int8 error-feedback compressed gradient all-reduce (cross-pod).

Cross-pod links are the scarcest bandwidth of a large data-parallel run:
the gradient all-reduce over the "pod" axis moves the parameters' bytes
every step.  This module quantizes gradients to int8 with one scale per
``GROUP`` values before the pod reduction (4× fewer bytes than f32, 2×
fewer than bf16) and keeps an error-feedback accumulator, so that the
quantization error is re-injected next step (standard EF compression).
The reference's `repro.distributed.compress`, over a `torch.distributed`
process group whose ranks are the pods:

  1. s      = all_reduce_max(max|g|) / 127      (one scalar per group)
  2. q      = round(g / s)  (int8 values, clipped)
  3. total  = all_reduce_sum(int32(q))          (exact integer reduce)
  4. out    = total · s / n_pods
  5. err    = g − q·s                           (error feedback, per pod)

where ``g`` is the gradient plus the incoming error, in f32.  Every
elementwise step is the reference's f32 op in its order, so a pod's
``out`` and ``err`` are its bits.  `compressed_pod_mean` reduces a whole
tree with two collectives (the leaves' groups concatenated), not two a
leaf.  The plain forms (``*_plain``) take the pods stacked on a leading
axis and need no process group: the oracle of the collective forms.
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import flatten, rebuild

GROUP = 128


def _groups(x: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """``x`` plus ``err`` (P, ...) in f32, each pod's values flattened and
    zero-padded to (P, G, GROUP)."""
    flat = x.float().reshape(x.shape[0], -1) + err.float().reshape(err.shape[0], -1)
    pad = (-flat.shape[1]) % GROUP
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(flat.shape[0], -1, GROUP)


def _ef(gs: list, pmax, psum, n: int) -> list:
    """The EF mean of each (P, G_i, GROUP) group tensor of ``gs`` (P pods
    stacked, or the one local pod), its groups reduced over the pods by
    ``pmax`` (f32 (P, G, 1) → (1, G, 1)) and ``psum`` (int32 (P, G, GROUP)
    → (1, G, GROUP)) → [(mean (G_i, GROUP), new error (P, G_i, GROUP))]."""
    g = torch.cat(gs, dim=1) if len(gs) > 1 else gs[0]
    s = pmax(torch.amax(torch.abs(g), dim=2, keepdim=True)) / 127.0
    s = torch.clamp_min(s, 1e-12)
    q = torch.clamp(torch.round(g / s), -127, 127)
    total = psum(q.to(torch.int32))
    out = (total.float() * s) / torch.tensor(float(n), dtype=torch.float32)
    err = g - q * s
    sizes = [t.shape[1] for t in gs]
    return list(zip(torch.split(out[0], sizes, dim=0), torch.split(err, sizes, dim=1)))


def _unpad(t: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= d
    return t.reshape(-1)[:n].reshape(shape)


def _collectives(group):
    import torch.distributed as dist

    def pmax(t):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return t

    def psum(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    return pmax, psum, dist.get_world_size(group)


def _stacked():
    return (lambda t: torch.amax(t, dim=0, keepdim=True),
            lambda t: torch.sum(t, dim=0, keepdim=True, dtype=torch.int32))


def ef_quantized_psum_mean(x: torch.Tensor, group, err: torch.Tensor):
    """This rank's (pod's) ``x`` and error → (mean over the group's ranks
    ≈, new error), each of ``x``'s shape, f32."""
    pmax, psum, n = _collectives(group)
    (out, new_err), = _ef([_groups(x[None], err[None])], pmax, psum, n)
    return _unpad(out, x.shape), _unpad(new_err[0], x.shape)


def ef_quantized_mean_plain(x: torch.Tensor, err: torch.Tensor):
    """The plain form: ``x`` and ``err`` (n_pods, ...) → (the mean, of one
    pod's shape; each pod's new error, (n_pods, ...))."""
    pmax, psum = _stacked()
    (out, new_err), = _ef([_groups(x, err)], pmax, psum, x.shape[0])
    return _unpad(out, x.shape[1:]), torch.stack([_unpad(e, x.shape[1:]) for e in new_err])


def _tree_mean(grads, errors, stacked: bool, pmax, psum, n):
    """`_ef` over every leaf of ``grads`` (and ``errors``, None: zeros),
    each leaf (P, ...) where ``stacked``, else one pod's."""
    flat_g = flatten(grads)
    flat_e = flatten(errors) if errors is not None else {}
    pods = {p: g if stacked else g[None] for p, g in flat_g.items()}
    gs = [_groups(g, flat_e[p] if stacked else flat_e[p][None]) if p in flat_e
          else _groups(g, torch.zeros(g.shape, dtype=torch.float32, device=g.device))
          for p, g in pods.items()]
    means, errs = {}, {}
    for (p, g), (out, err) in zip(pods.items(), _ef(gs, pmax, psum, n)):
        means[p] = _unpad(out, g.shape[1:])
        e = torch.stack([_unpad(x, g.shape[1:]) for x in err])
        errs[p] = e if stacked else e[0]
    return rebuild(grads, means), rebuild(grads, errs)


def compressed_pod_mean(grads, pod_group, errors=None):
    """Every gradient → its EF-int8 mean over ``pod_group``'s ranks.
    ``errors``: the same tree of f32 accumulators (None: zeros).  Returns
    (grads, errors), two collectives in all."""
    pmax, psum, n = _collectives(pod_group)
    return _tree_mean(grads, errors, False, pmax, psum, n)


def compressed_pod_mean_plain(grads, errors=None):
    """The plain form of `compressed_pod_mean`: each leaf with the pods
    stacked on a leading axis → (the means, each pod's errors stacked)."""
    pmax, psum = _stacked()
    n = next(iter(flatten(grads).values())).shape[0]
    return _tree_mean(grads, errors, True, pmax, psum, n)


def maybe_compressed_pod_mean(grads):
    """The train step's hook (`train.steps.TrainOptions.compress_pod_grads`).

    The identity, as the reference's is: a one-process step holds one
    pod's gradients.  A launcher with a pod group calls
    `compressed_pod_mean` on the step's gradients instead."""
    return grads
