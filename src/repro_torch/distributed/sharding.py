"""Sharding rules: parameter paths → specs (DP / FSDP / TP / EP / SP).

The reference's `repro.distributed.sharding` on the port's trees.  The
mesh axes are ("pod",) "data", "model":

  * batch             → ("pod", "data")        data parallel
  * vocab / heads / d_ff / experts → "model"   tensor / expert parallel
  * parameter d_model axes → "data"            FSDP (ZeRO-3): parameters,
    gradients and optimizer state sharded on the data axis
  * long-context KV / sequence → "model"       SP for decode caches

A spec is the contents of the reference's `PartitionSpec`: a tuple with
one entry a tensor dimension, an axis name, a tuple of names or None.
`NamedSharding` pairs it with a mesh and gives its `DTensor`
``placements``.  The rules read only the mesh's axis names and sizes, so
every function here takes a `torch.distributed.device_mesh.DeviceMesh`
or a plain ``{axis: size}`` mapping (the production meshes, such as
``{"pod": 2, "data": 16, "model": 16}``, need no devices).

Resolution is explicit logic on (basename, parent, rank) rather than a
regex table: ``wi`` alone is ambiguous between a dense MLP (d, ff), an
expert stack (E, d, ff) and an RG-LRU gate (nb, bs, bs).  Dimensions that
do not divide their mesh axis fall back to replication.

The port's tree is unstacked (`models.lm.param_tree`: ``blocks/u/...``,
``lead/i/...``, ``encoder/layers/i/...``, ``cross/i/...``), where the
reference stacks each pattern slot's blocks (and whisper's encoder and
cross trees) along a leading layer axis: a port leaf's spec is the
reference's with that axis's None dropped.
"""
from __future__ import annotations

import dataclasses
import math
import re

from repro_torch.distributed.axes import mesh_shape, placements
from repro_torch.train.tree import flatten, rebuild, tree_map

# tags: "F" = FSDP axis ("data"), "M" = tensor axis ("model")
_NORM_NAMES = {"scale"}


def _rule(path: str, rank: int) -> tuple:
    """Spec tags for the UNSTACKED leaf of this path ('' = replicate)."""
    base = path.rsplit("/", 1)[-1]
    in_ffn = "/ffn/" in path or path.startswith("ffn/")
    in_mix = "/mix/" in path or path.startswith("mix/")
    if base == "table":  # embed (vocab, d)
        return ("M", "F")
    if base == "head":  # (d, vocab)
        return ("F", "M")
    if base in _NORM_NAMES or base in ("a_log", "d_skip", "dt_bias"):
        return (None,) * rank
    if base in ("wq", "wk", "wv"):  # (d, H*hd)
        return ("F", "M")
    if base in ("bq", "bk", "bv"):
        return ("M",)
    if base == "router":  # (d, E)
        return ("F", None)
    if base in ("wi", "wg"):
        if in_ffn and rank == 3:  # experts (E, d, ff) — EP
            return ("M", "F", None)
        if in_mix and rank == 3:  # rglru block-diag gates (nb, bs, bs)
            return (None, None, "M")
        return ("F", "M")  # dense MLP (d, ff)
    if base == "wr" and rank == 3:  # rglru gate
        return (None, None, "M")
    if base == "wo":
        if in_ffn and rank == 3:  # experts (E, ff, d)
            return ("M", None, "F")
        return ("M", "F")  # (H*hd | ff | w, d)
    if base in ("wdq",):  # MLA (d, q_lora)
        return ("F", "M")
    if base == "wuq":  # (q_lora, H*(dn+dr))
        return ("M", None)
    if base == "wdkv":  # (d, kr+dr) — 576 rarely divides; F on d only
        return ("F", None)
    if base == "wukv":  # (kr, H*(dn+dv))
        return (None, "M")
    if base in ("wx", "wy"):  # rglru in-proj (d, w)
        return ("F", "M")
    if base == "conv":  # depthwise (cw, w)
        return (None, "M")
    if base == "lam":
        return ("M",)
    if base == "win":  # ssd fused in-proj (d, mixed-groups)
        return ("F", None)
    if base == "wout":  # ssd out (din, d)
        return ("M", "F")
    if base == "pos":  # whisper positional table
        return (None, None)
    return (None,) * rank


def _axis_name(tag, names):
    if tag == "F":
        return "data" if "data" in names else None
    if tag == "M":
        return "model" if "model" in names else None
    return tag


def spec_for_path(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """The spec of the (unstacked) leaf at ``path`` with ``shape`` on
    ``mesh`` (a `DeviceMesh` or an ``{axis: size}`` mapping)."""
    sizes = mesh_shape(mesh)
    axes: list = []
    for i, tag in enumerate(_rule(path, len(shape))):
        ax = _axis_name(tag, sizes)
        if ax is not None and (i >= len(shape) or shape[i] % sizes[ax] != 0):
            ax = None
        axes.append(ax)
    while len(axes) < len(shape):
        axes.append(None)
    # EP fallback → intra-expert TP: when the expert count does not divide
    # the model axis (mixtral: 8 experts on 16-way TP), shard the expert
    # FFN width instead, or every device would compute every expert
    base = path.rsplit("/", 1)[-1]
    if (("/ffn/" in path or path.startswith("ffn/")) and len(shape) == 3
            and base in ("wi", "wg", "wo") and axes[0] is None):
        m = _axis_name("M", sizes)
        ff_dim = 2 if base in ("wi", "wg") else 1
        if m is not None and shape[ff_dim] % sizes[m] == 0:
            axes[ff_dim] = m
    return tuple(axes[: len(shape)])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a `DeviceMesh`, or a mapping for the rules
    alone); ``placements`` are its `DTensor` placements, one a mesh
    dimension."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(params_tree, mesh):
    """Same-structure tree of `NamedSharding`s for a parameter tree of
    tensors (or of anything with a ``.shape``).

    Also used for the optimizer state (mapped over the same structure):
    int8 moment leaves are ``(q, scale)`` pairs — the trailing tuple index
    is stripped so they inherit the parameter's rule, and indivisible
    dims (the scale's trailing 1) fall back to replication."""
    out = {}
    for path, leaf in flatten(params_tree).items():
        rule_path = re.sub(r"/\d+$", "", path)
        out[path] = NamedSharding(mesh, spec_for_path(rule_path, tuple(leaf.shape), mesh))
    return rebuild(params_tree, out)


def batch_axes(mesh):
    dp = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return dp if len(dp) > 1 else dp[0]


def _dp_size(mesh, dp) -> int:
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in (dp if isinstance(dp, tuple) else (dp,)))


def data_shardings(batch_tree, mesh):
    """Batch inputs: leading axis over the DP axes, the rest replicated."""
    dp = batch_axes(mesh)
    dp_size = _dp_size(mesh, dp)

    def one(leaf):
        if leaf.ndim and leaf.shape[0] % dp_size == 0:
            return NamedSharding(mesh, (dp,) + (None,) * (leaf.ndim - 1))
        return NamedSharding(mesh, ())

    return tree_map(one, batch_tree)


def cache_shardings(cache_tree, cfg, mesh):
    """KV / state caches: batch on the DP axes; one feature dim on "model".

    The port's caches are per layer (`models.lm.init_cache`): a leaf is
    (B, ...), the reference's (U, B, ...) without the unit axis.  Axis 0
    (batch) shards on the DP axes when divisible; the last trailing axis
    that the model axis divides gets "model" (kv heads, head_dim,
    recurrence width, state)."""
    dp = batch_axes(mesh)
    dp_size = _dp_size(mesh, dp)
    m = mesh_shape(mesh).get("model", 1)

    def one(leaf):
        axes: list = [None] * leaf.ndim
        if leaf.ndim >= 1 and leaf.shape[0] % dp_size == 0:
            axes[0] = dp
        for i in range(leaf.ndim - 1, 0, -1):
            if leaf.shape[i] % m == 0 and leaf.shape[i] >= m:
                axes[i] = "model"
                break
        return NamedSharding(mesh, tuple(axes))

    return tree_map(one, cache_tree)
