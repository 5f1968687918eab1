"""Per-cell perf probe: trace ONE dry-run cell with knob overrides and
report its three roofline terms.

The reference's `repro.launch.perf_probe` on the port's objects:

    PYTHONPATH=src python -m repro_torch.launch.perf_probe --arch llama3-405b \\
        --shape prefill_32k --set attn.triangle_skip=false --device cpu

Knobs: ``attn.triangle_skip`` / ``attn.q_chunk`` / ``attn.kv_chunk``
(`models.layers.ATTN_OPTS`, for the cell only), ``train.microbatches``
(the microbatch count of the train options `lower_cell` is given),
``moe.capacity_factor`` (the config `lower_cell` is given) and
``ce.chunk`` (`models.lm.CE_CHUNK`, for the cell only).  As in
the reference, ``ce.chunk`` changes nothing: `lm.chunked_ce` binds its
``chunk`` default when it is defined and `lm.loss_fn` passes none.

The cell runs in this process, on a fake process group of its own
(`launch.mesh.fake_group`).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.models import layers as layers_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.config import SHAPES
from repro_torch.train import steps

KNOBS = ("attn.triangle_skip", "attn.q_chunk", "attn.kv_chunk", "ce.chunk",
         "train.microbatches", "moe.capacity_factor")


def parse_knobs(knobs) -> dict:
    """``["KNOB=VAL", ...]`` → {knob: value}; an unknown knob exits."""
    out = {}
    for kv in knobs:
        k, v = kv.split("=", 1)
        if k not in KNOBS:
            raise SystemExit(f"unknown knob {k}")
        out[k] = v
    return out


@contextlib.contextmanager
def module_knobs(knobs: dict):
    """The ``attn.*`` knobs on `models.layers.ATTN_OPTS` and ``ce.chunk`` on
    `models.lm.CE_CHUNK` for the block, both restored after it."""
    attn = dataclasses.replace(layers_mod.ATTN_OPTS)
    chunk = lm_mod.CE_CHUNK
    try:
        if "attn.triangle_skip" in knobs:
            layers_mod.ATTN_OPTS.triangle_skip = knobs["attn.triangle_skip"].lower() in (
                "1", "true")
        if "attn.q_chunk" in knobs:
            layers_mod.ATTN_OPTS.q_chunk = int(knobs["attn.q_chunk"])
        if "attn.kv_chunk" in knobs:
            layers_mod.ATTN_OPTS.kv_chunk = int(knobs["attn.kv_chunk"])
        if "ce.chunk" in knobs:
            lm_mod.CE_CHUNK = int(knobs["ce.chunk"])
        yield
    finally:
        layers_mod.ATTN_OPTS.__dict__.update(dataclasses.asdict(attn))
        lm_mod.CE_CHUNK = chunk


def probe(arch: str, shape: str, multi_pod: bool = False, *, mesh=None,
          device: str = "cuda", knobs=(), tag: str = "probe", cfg=None) -> dict:
    """The cell's terms under ``knobs`` (``"KNOB=VAL"`` strings); ``cfg``
    replaces ``get_config(arch)``."""
    arch = arch.replace("-", "_")
    kv = parse_knobs(knobs)
    cfg = cfg or get_config(arch)
    if "moe.capacity_factor" in kv:
        cfg = dataclasses.replace(cfg, capacity_factor=float(kv["moe.capacity_factor"]))
    topts = None
    if "train.microbatches" in kv and SHAPES[shape].kind == "train":
        topts = dataclasses.replace(steps.dryrun_train_options(cfg)[1],
                                    num_microbatches=int(kv["train.microbatches"]))
    with module_knobs(kv):
        cell = dryrun.lower_cell(arch, shape, multi_pod, mesh=mesh, device=device,
                                 verbose=False, cfg=cfg, topts=topts)
    r = roofline.analyze_row(cell)
    return {
        "tag": tag,
        "knobs": list(knobs),
        "t_compute_s": r["t_compute_s"],
        "t_memory_s": r["t_memory_s"],
        "t_collective_s": r["t_collective_s"],
        "dominant": r["dominant"],
        "roofline_frac": r["roofline_frac"],
        "step_bound_s": r["step_bound_s"],
        "mem_per_dev_gib": r["memory"]["per_device_total"] / 2**30,
        "by_kind": r["collectives"]["by_kind"],
        "flops": r["cost"]["flops"],
        "bytes_accessed": r["cost"]["bytes_accessed"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--set", action="append", default=[], metavar="KNOB=VAL")
    ap.add_argument("--tag", default="probe")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda by default; cpu for the tests)")
    args = ap.parse_args(argv)
    out = probe(args.arch, args.shape, args.multi_pod, device=args.device, knobs=args.set,
                tag=args.tag)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
