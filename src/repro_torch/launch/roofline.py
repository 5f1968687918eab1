"""Roofline analysis of the dry run's rows (`launch.dryrun`).

The reference's `repro.launch.roofline` with the H100's constants
(`launch.mesh`, NVIDIA H100 80GB HBM3, 700.00 W).  Three terms per (arch
× shape × mesh), each in seconds a step:

  compute    = FLOPs a device / PEAK_FLOPS_BF16     (989e12 dense bf16)
  memory     = HBM bytes a device / HBM_BW          (3.35e12)
  collective = link bytes a device / LINK_BW        (50e9, InfiniBand)

The counts are `launch.op_stats`'s, per device and per step.  Its HBM
bytes are the eager step's own traffic — operands and result of every
ATen op, unfused — where the reference's are XLA's fused buffers: the
memory term reads how far the eager step is from fused, and moves
whenever ops are fused.  MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D
(MoE) a train step, 2·N·D a prefill, 2·N·B one decode token.
MODEL_FLOPS / (FLOPs × devices) is the share of the counted compute
that is "useful" (remat recompute, masked attention chunks and expert
capacity padding push it below 1).

`step_bound` is the least time a step could take on these cards, which a
measured step is set against: the larger of the compute term, the
collective term and the bytes floor over HBM_BW (`floor_bytes`: the
step's arguments read once and its outputs written once, which no
schedule or fusion of the program changes).  A row records the torch
release that traced it; `DTensor` partitions apart between releases,
and `main` refuses to put rows of two releases in one table.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dryrun results/dryrun.json --mesh 16x16
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import SHAPES


def model_flops(row: dict) -> float:
    shape = SHAPES[row["shape"]]
    n_active = row["active_params"]
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq


def model_min_bytes(row: dict) -> float:
    """Intrinsic per-step HBM floor (global): weights once (+cache for
    decode) in bf16 — the quantity a perfect schedule must still read."""
    shape = SHAPES[row["shape"]]
    weights = 2.0 * row["active_params"]
    if shape.kind == "train":
        # fwd+bwd read weights, write grads ≈ 3× weight traffic is the
        # floor only when activations fit; activations add ≥ 2·B·S·d·L
        # which the measured term holds — keep the weights floor.
        return 3.0 * weights
    if shape.kind == "prefill":
        return weights
    # decode: weights + the KV/state cache read once per token
    cache = row.get("memory", {}).get("argument_bytes", 0) * row["devices"]
    return weights + 0.5 * cache  # args include params; avoid double count


def terms(row: dict) -> dict:
    """{compute, memory, collective}: a row's three terms in seconds, the
    reference's (memory: the eager step's op-by-op bytes)."""
    return {
        "compute": row["cost"]["flops"] / PEAK_FLOPS_BF16,
        "memory": row["cost"]["bytes_accessed"] / HBM_BW,
        "collective": row["collectives"]["link_bytes_total"] / LINK_BW,
    }


def floor_bytes(row: dict) -> float:
    """The bytes a device must move in a step of ``row`` however it is
    scheduled: every argument it reads (the parameters, the optimizer
    state, the cache, the batch) read once, every fresh output written
    once, and in a train step every parameter and state element, updated
    in place, written back once.  A decode step's in-place cache write
    (one slot) is left out: it is below a part in a thousand of the
    cache it reads."""
    m = row["memory"]
    written = m["output_bytes"] - m["alias_bytes"]
    if row.get("kind", "") == "train" or row["shape"] in SHAPES and \
            SHAPES[row["shape"]].kind == "train":
        written += m["alias_bytes"]
    return float(m["argument_bytes"] + written)


def bound_terms(row: dict) -> dict:
    """{compute, memory, collective} of `step_bound`, in seconds: the
    memory term is `floor_bytes` over HBM_BW."""
    t = terms(row)
    t["memory"] = floor_bytes(row) / HBM_BW
    return t


def step_bound(row: dict) -> float:
    """The least seconds a step of ``row`` could take: the largest of
    `bound_terms`."""
    return max(bound_terms(row).values())


def torch_release(rows: list[dict]) -> str:
    """The one torch release that traced ``rows``; raises where they
    come from two (or a row does not say)."""
    releases = {r.get("torch") for r in rows}
    if len(releases) != 1 or None in releases:
        raise ValueError(f"rows traced by more than one torch release: {sorted(map(str, releases))}")
    return releases.pop()


def analyze_row(row: dict) -> dict:
    if "error" in row:
        return dict(row)
    dev = row["devices"]
    t = terms(row)
    dominant = max(t, key=t.get)
    mf = model_flops(row)
    useful = mf / max(row["cost"]["flops"] * dev, 1.0)
    bound_time = max(t.values())
    # intrinsic step time: the larger of the model-FLOPs time and the
    # model-bytes floor time (decode/prefill are legitimately memory-bound;
    # measuring them against a FLOPs roofline would be meaningless)
    t_intrinsic = max(
        mf / dev / PEAK_FLOPS_BF16,
        model_min_bytes(row) / dev / HBM_BW,
    )
    frac = t_intrinsic / max(bound_time, 1e-30)
    b = bound_terms(row)
    out = dict(row)
    out.update(
        {
            "t_compute_s": t["compute"],
            "t_memory_s": t["memory"],
            "t_collective_s": t["collective"],
            "dominant": dominant,
            "model_flops": mf,
            "useful_flops_ratio": useful,
            "roofline_frac": min(frac, 1.0),
            "t_memory_floor_s": b["memory"],
            "step_bound_s": max(b.values()),
            "bound_by": max(b, key=b.get),
        }
    )
    return out


_SUGGEST = {
    "compute": "cut non-useful FLOPs (triangle-skip attention, tighter MoE capacity, less remat recompute)",
    "memory": "raise arithmetic intensity (fuse elementwise chains, bigger microbatches, bf16 buffers)",
    "collective": "re-shard to cut traffic (FSDP→replicated small params, overlap AG/RS with compute, int8-compress cross-pod grads)",
}


def markdown_table(rows: list[dict]) -> str:
    """The reference's table, with each cell's trace seconds (an error
    row: the seconds its process ran, where the dry run recorded them),
    its memory floor and its `step_bound`.  "memory (s)" is the eager
    step's op-by-op bytes; "floor (s)" is `floor_bytes`'s."""
    hdr = (
        "| arch | shape | mesh | trace (s) | compute (s) | memory (s) | floor (s) | "
        "collective (s) | dominant | step_bound (s) | bound by | 6ND/counted | "
        "roofline frac | next lever |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in rows:
        if "error" in r:
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('wall_s', '—')} "
                f"| — | — | — | — | ERROR | — | — | — | — | {r['error'][:60]} |"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r.get('lower_s', '—')} "
            f"| {r['t_compute_s']:.4g} | {r['t_memory_s']:.4g} "
            f"| {r['t_memory_floor_s']:.4g} | {r['t_collective_s']:.4g} | {r['dominant']} "
            f"| {r['step_bound_s']:.4g} | {r['bound_by']} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_frac']:.2%} "
            f"| {_SUGGEST[r['dominant']]} |"
        )
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", nargs="+", default=["results/dryrun.json"],
                    help="the dry run's row files, read in order")
    ap.add_argument("--out", default="results/roofline.json")
    ap.add_argument("--md", default="results/roofline.md")
    ap.add_argument("--mesh", default="16x16", help="roofline table mesh filter")
    args = ap.parse_args(argv)
    rows = []
    for path in args.dryrun:
        with open(path) as f:
            rows += [analyze_row(r) for r in json.load(f)]
    release = torch_release([r for r in rows if "error" not in r])
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    table_rows = [r for r in rows if r.get("mesh") == args.mesh or "error" in r]
    md = (f"Counts of torch {release}'s `DTensor` partitioning, traced by the dry run; "
          f"terms on the H100's peaks (NVIDIA H100 80GB HBM3, 700.00 W).\n\n"
          + markdown_table(table_rows))
    with open(args.md, "w") as f:
        f.write(md)
    print(md)


if __name__ == "__main__":
    main()
