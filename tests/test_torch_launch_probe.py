"""The perf probe's knobs (`repro_torch.launch.perf_probe`) move the port's
row the way the reference's knobs move its row.

Each package runs in a subprocess of its own, on one rank at the smoke
configs and small shapes of `launch_cells`, one cell per knob set (the
port's probe restores its knobs after each cell; the reference's are
reset by hand).  Held: the sign of each
knob's change of the FLOPs a device (up, down or none) is the same in
both packages, but for ``train.microbatches`` (see `CASES`).
``ce.chunk`` changes nothing in either (the shared fault in
`ROADMAP.md` § 3); ``attn.*`` and ``moe.capacity_factor`` move the work.
"""
import json
import os
import subprocess
import sys
import textwrap

import launch_cells
import torch_threads

torch_threads.cap_under_xdist()

# (arch, shape, mesh, knobs): each set against the same cell without knobs,
# on one rank, where the two counts differ only by what each package
# counts (`test_torch_launch_cells*.py` hold the sharded rows).  There the
# microbatch count moves the port's count nowhere and the reference's up
# to the port's: XLA emits the CE chunk's forward logits product once
# without a microbatch loop and twice in one (the port always twice,
# `launch_cells.ONE_RANK_RTOL`).  On (4, 2) the port's count also rises
# (5.0% at qwen-smoke), a partitioner's choice for the smaller microbatch
# (`ROADMAP.md` § 3, "Two partitioners").
CASES = [
    ("qwen1_5_0_5b", "prefill_s", "1x1", []),
    ("qwen1_5_0_5b", "prefill_s", "1x1", ["attn.q_chunk=16", "attn.kv_chunk=16"]),
    ("qwen1_5_0_5b", "prefill_s", "1x1", ["attn.q_chunk=16", "attn.kv_chunk=16",
                                          "attn.triangle_skip=false"]),
    ("qwen1_5_0_5b", "train_s", "1x1", []),
    ("qwen1_5_0_5b", "train_s", "1x1", ["ce.chunk=16"]),
    ("qwen1_5_0_5b", "train_s", "1x1", ["train.microbatches=2"]),
    ("mixtral_8x22b", "train_s", "1x1", []),
    ("mixtral_8x22b", "train_s", "1x1", ["moe.capacity_factor=4.0"]),
]

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch.models.config import SHAPES, ShapeSpec
    SMALL, MESHES = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    SHAPES.update({k: ShapeSpec(k, *v) for k, v in SMALL.items()})
    from repro_torch.configs import get_smoke
    from repro_torch.launch import perf_probe
    out = []
    for arch, shape, mesh, knobs in json.loads(sys.argv[1]):
        r = perf_probe.probe(arch, shape, mesh=MESHES[mesh], device="cpu", knobs=knobs,
                             cfg=get_smoke(arch))
        out.append(r["flops"])
    print(json.dumps(out))
""")

_REF = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import repro.launch.dryrun as dr
    import repro.launch.mesh as mesh_mod
    from repro.configs import get_smoke
    from repro.launch import perf_probe
    from repro.models import layers, lm
    from repro.models.config import SHAPES, ShapeSpec
    SHAPES.update({k: ShapeSpec(k, *v) for k, v in json.loads(sys.argv[2]).items()})
    MESHES = json.loads(sys.argv[3])
    smoke = lambda a: get_smoke(a)
    saved = (dataclasses.replace(layers.ATTN_OPTS), lm.CE_CHUNK, dr._microbatches)
    out = []
    for arch, shape, mesh, knobs in json.loads(sys.argv[1]):
        dr.make_production_mesh = lambda multi_pod=False, m=MESHES[mesh]: mesh_mod.make_mesh(
            tuple(m.values()), tuple(m))
        dr.get_config = smoke
        for kv in knobs:
            k, v = kv.split("=", 1)
            if k == "moe.capacity_factor":  # the probe's own patch reads the full config
                dr.get_config = lambda a, v=float(v): dataclasses.replace(smoke(a),
                                                                         capacity_factor=v)
            else:
                perf_probe.apply_knob(k, v)
        out.append(dr.lower_cell(arch, shape, False, verbose=False)["cost"]["flops"])
        layers.ATTN_OPTS.__dict__.update(dataclasses.asdict(saved[0]))
        lm.CE_CHUNK, dr._microbatches = saved[1:]
    print(json.dumps(out))
""")


def _sign(a: float, b: float) -> int:
    """The direction of ``b`` from ``a``: 0 within a part in a million."""
    return 0 if abs(b - a) <= 1e-6 * abs(a) else (1 if b > a else -1)


def test_knobs_move_the_row_as_the_reference():
    env = {**os.environ, "PYTHONPATH": launch_cells.SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTEST_XDIST_WORKER", None)
    argv = [json.dumps(CASES), json.dumps(launch_cells.SMALL), json.dumps(launch_cells.MESHES)]
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for code in (_PORT, _REF)]
    flops = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-3000:]
        flops.append(json.loads(out.strip().splitlines()[-1]))
    port, ref = flops
    base = {}
    moved = []
    for (arch, shape, mesh, knobs), pf, rf in zip(CASES, port, ref):
        if not knobs:
            base[(arch, shape, mesh)] = (pf, rf)
            continue
        p0, r0 = base[(arch, shape, mesh)]
        moved.append((knobs, _sign(p0, pf), _sign(r0, rf), pf / p0, rf / r0))
        if knobs == ["train.microbatches=2"]:
            assert pf == p0 == rf, (pf, p0, rf, r0)
    print("\n".join(f"{k}: port x{p:.4f}, reference x{r:.4f}" for k, _, _, p, r in moved))
    for knobs, sp, sr, p, r in moved:
        assert sp == sr or knobs == ["train.microbatches=2"], (knobs, p, r)
    signs = {tuple(k): sp for k, sp, _, _, _ in moved}
    assert signs[("ce.chunk=16",)] == 0
    # smaller chunks let the causal skip drop whole blocks; without the
    # skip the blocks tile the same square as one chunk
    assert signs[("attn.q_chunk=16", "attn.kv_chunk=16")] == -1
    assert signs[("moe.capacity_factor=4.0",)] == 1


def test_module_knobs_are_restored():
    """The probe's module knobs hold for its block only; an unknown knob
    is refused."""
    import dataclasses

    import pytest

    from repro_torch.launch import perf_probe
    from repro_torch.models import layers, lm

    attn, chunk = dataclasses.asdict(layers.ATTN_OPTS), lm.CE_CHUNK
    knobs = perf_probe.parse_knobs(["attn.q_chunk=16", "attn.triangle_skip=false",
                                    "ce.chunk=8"])
    with perf_probe.module_knobs(knobs):
        assert (layers.ATTN_OPTS.q_chunk, layers.ATTN_OPTS.triangle_skip,
                lm.CE_CHUNK) == (16, False, 8)
    assert dataclasses.asdict(layers.ATTN_OPTS) == attn and lm.CE_CHUNK == chunk
    with pytest.raises(SystemExit):
        perf_probe.parse_knobs(["attn.block=4"])
