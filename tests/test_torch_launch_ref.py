"""The port's dry run against the reference's own at 16 × 16, on the CPU.

Both sides run a full-width attention config cut in depth — qwen1.5-0.5b
on 2 layers, its 16 heads over the production ``model`` axis of 16 — at
reduced shapes the data axis divides (train 32 × 512, prefill 16 × 2048,
decode of 32 tokens against a 2048-slot cache), each in a subprocess of
its own: the port's `lower_cell` on a fake process group of 256 ranks,
the reference's on 256 of its 512 fake XLA devices.  Held per shape: the
port's FLOPs a device at most 1.5 times the reference's for train and
prefill and 1.1 times for decode (the attention's batched products keep
batch over ``data`` and heads over ``model``; every product keeps its
operands' shards), and at least 0.9 times, as the reference splits each
of these steps over its devices; and the train step's memory a device at
most 2 times the reference's (the CE's gold logit, its ``logsumexp`` and
the embedding's lookup and backward stay on each rank's vocab shard).

`chip_smoke.reference_bounds`, which phase 14 and
`tools/dryrun_releases.py` hold the full grid's rows to, is checked on
rows of the recorded grid: the lower bound applies where the reference
splits the step, and the bounds follow the config's family.

One more case lowers a cheap cell of the reference's grid again
(qwen1.5-0.5b ``decode_32k`` on 16 × 16, `tools/dryrun_reference.py
--cell`) and holds it to its row in ``results/dryrun_reference.json``,
so that the recorded grid the port is held to cannot go stale unseen.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

import launch_cells
import torch_threads

torch_threads.cap_under_xdist()

ARCH = "qwen1_5_0_5b"
LAYERS = 2
SMALL = {"train_r": ("train", 512, 32), "prefill_r": ("prefill", 2048, 16),
         "decode_r": ("decode", 2048, 32)}
FLOPS_BOUND = {"train": 1.5, "prefill": 1.5, "decode": 1.1}
FLOPS_LEAST = 0.9
MEMORY_BOUND = {"train": 2.0}

_PORT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeSpec
    arch, layers, small = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    rows = [dryrun.lower_cell(arch, name, mesh={"data": 16, "model": 16}, device="cpu",
                              verbose=False, spec=ShapeSpec(name, *v), cfg=cfg)
            for name, v in small.items()]
    print(json.dumps(rows))
""")

_REF = textwrap.dedent("""
    import dataclasses, json, sys
    import repro.launch.dryrun as dr
    from repro.configs import get_config
    from repro.models.config import SHAPES, ShapeSpec
    arch, layers, small = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    SHAPES.update({k: ShapeSpec(k, *v) for k, v in small.items()})
    dr.get_config = lambda a: cfg
    print(json.dumps([dr.lower_cell(arch, name, False, verbose=False) for name in small]))
""")


def _start(*argv):
    env = {**os.environ, "PYTHONPATH": launch_cells.SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTEST_XDIST_WORKER", None)
    return subprocess.Popen([sys.executable, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _rows(proc) -> list:
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def rows():
    small = json.dumps(SMALL)
    procs = [_start("-c", code, ARCH, str(LAYERS), small) for code in (_PORT, _REF)]
    port, ref = (_rows(p) for p in procs)
    return {r["shape"]: r for r in port}, {r["shape"]: r for r in ref}


@pytest.mark.parametrize("shape", list(SMALL))
def test_port_within_bounds_of_reference(rows, shape):
    port, ref = rows[0][shape], rows[1][shape]
    kind = SMALL[shape][0]
    flops = port["cost"]["flops"] / ref["cost"]["flops"]
    memory = port["memory"]["per_device_total"] / ref["memory"]["per_device_total"]
    link = (port["collectives"]["link_bytes_total"]
            / max(ref["collectives"]["link_bytes_total"], 1))
    print(f"{ARCH} on {LAYERS} layers, {shape} {SMALL[shape]}, 16 x 16: FLOPs a device port "
          f"{port['cost']['flops']:.6g} reference {ref['cost']['flops']:.6g} ({flops:.4f}); "
          f"memory {port['memory']['per_device_total']} / "
          f"{ref['memory']['per_device_total']} ({memory:.4f}); link bytes "
          f"{port['collectives']['link_bytes_total']:.6g} / "
          f"{ref['collectives']['link_bytes_total']:.6g} ({link:.4f})")
    assert port["params"] == ref["params"]
    assert ref["cost"]["flops"] * ref["devices"] <= 1.1 * port["cost"]["step_flops"]
    assert FLOPS_LEAST <= flops <= FLOPS_BOUND[kind], (shape, flops)
    if kind in MEMORY_BOUND:
        assert memory <= MEMORY_BOUND[kind], (shape, memory)


def test_recorded_reference_grid_is_current():
    proc = _start(os.path.join(launch_cells.REPO, "tools", "dryrun_reference.py"), "--cell",
                  ARCH, "decode_32k", "16x16")
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    fresh = json.loads(stdout.strip().splitlines()[-1])
    with open(os.path.join(launch_cells.REPO, "results", "dryrun_reference.json")) as f:
        recorded = {(r["arch"], r["shape"], r["mesh"]): r for r in json.load(f)}
    row = recorded[(ARCH, "decode_32k", "16x16")]
    for key in ("jax", "params", "memory", "cost", "collectives"):
        assert fresh[key] == row[key], (key, fresh[key], row[key])


@pytest.fixture(scope="module", name="chip_smoke")
def chip_smoke_module():
    """`chip_smoke.py` as a module (it imports nothing but the standard
    library at the top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(launch_cells.REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module  # its dataclasses look their module up
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules["chip_smoke"]
    return module


@pytest.mark.parametrize("arch, shape, step, want", [
    # the reference splits qwen's train step: FLOPs in [0.9, 1.5], dense
    # train memory at most 2
    ("qwen1_5_0_5b", "train_4k", 1.0, {"flops": (0.9, 1.5), "memory": (0.0, 2.0)}),
    # where the port's step holds less than the reference counts over its
    # devices (the reference replicates), no lower bound
    ("qwen1_5_0_5b", "train_4k", 0.5, {"flops": (0.0, 1.5), "memory": (0.0, 2.0)}),
    # a family without attention in every block: 2 times
    ("mamba2_130m", "train_4k", 1.0, {"flops": (0.9, 2.0)}),
    ("recurrentgemma_9b", "prefill_32k", 1.0, {"flops": (0.9, 2.0)}),
    # decode: 2 times, attention or not; memory bounded only in training
    ("yi_6b", "decode_32k", 1.0, {"flops": (0.9, 2.0)}),
    ("whisper_small", "prefill_32k", 1.0, {"flops": (0.9, 1.5)}),
])
def test_reference_bounds_follow_family_and_split(chip_smoke, arch, shape, step, want):
    with open(os.path.join(launch_cells.REPO, "results", "dryrun_reference.json")) as f:
        ref = next(r for r in json.load(f) if (r["arch"], r["shape"], r["mesh"])
                   == (arch, shape, "16x16"))
    total = ref["cost"]["flops"] * ref["devices"]
    kind = "train" if shape == "train_4k" else "prefill" if shape == "prefill_32k" else "decode"
    row = {"arch": arch, "shape": shape, "mesh": "16x16", "kind": kind,
           "cost": {"flops": ref["cost"]["flops"], "step_flops": step * total},
           "collectives": ref["collectives"], "memory": ref["memory"]}
    assert chip_smoke.reference_bounds(row, ref) == want
    assert chip_smoke.reference_breaks(row, ref) == []
    low = dict(row, cost={**row["cost"], "flops": 0.5 * ref["cost"]["flops"]})
    assert bool(chip_smoke.reference_breaks(low, ref)) == (want["flops"][0] > 0)
