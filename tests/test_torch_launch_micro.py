"""A microbatched train step counted from two of its microbatches equals
the same step traced through all of them.

`repro_torch.launch.dryrun.lower_cell` traces a train step of n > 2
microbatches through the first two and counts the second n − 1 times
(`dryrun._scaled_microbatches`), as the reference's `hlo_stats` counts
its scan's body by the trip count.  On a dense and a MoE smoke config at
8 × 64 tokens (`launch_cells.SMALL`), on the (1, 1), (4, 2) and
(2, 2, 2) meshes of `launch_cells.MESHES`, with 2 and 4 microbatches,
the scaled row equals the row traced through every microbatch
(``scale_microbatches=False``) exactly: FLOPs, HBM bytes, collectives
(calls, link bytes, by kind), temp bytes and the total a device (the
peak of live bytes), and the `op_stats.DotAudit` summary.  With 2
microbatches the dry run traces both, through the program's own loop:
its row is the fully traced row, traced once here.  Each case runs in a
subprocess of its own at one torch thread, all at once.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

import launch_cells
import torch_threads

torch_threads.cap_under_xdist()

ARCHS = ("qwen1_5_0_5b", "mixtral_8x22b")
MICROBATCHES = (2, 4)
CASES = [(a, m, k) for a in ARCHS for m in launch_cells.MESHES for k in MICROBATCHES]

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch.models.config import SHAPES, ShapeSpec
    SHAPES["train_s"] = ShapeSpec("train_s", *json.loads(sys.argv[2]))
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.train.steps import TrainOptions
    arch, mesh, k = sys.argv[1], json.loads(sys.argv[3]), int(sys.argv[4])
    out = {}
    for scaled in (True, False) if k > 2 else (True,):
        row = dryrun.lower_cell(arch, "train_s", mesh=mesh, device="cpu", verbose=False,
                                cfg=get_smoke(arch), audit=True, scale_microbatches=scaled,
                                topts=TrainOptions(num_microbatches=k, remat=True))
        out[str(scaled)] = {key: row[key] for key in (
            "cost", "collectives", "memory", "audit", "microbatches")}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def rows():
    env = {**os.environ, "PYTHONPATH": launch_cells.SRC, "OMP_NUM_THREADS": "1"}
    env.pop("PYTEST_XDIST_WORKER", None)
    procs = {(a, m, k): subprocess.Popen(
        [sys.executable, "-c", _PORT, a, json.dumps(launch_cells.SMALL["train_s"]),
         json.dumps(launch_cells.MESHES[m]), str(k)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for a, m, k in CASES}
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        out[key] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("arch,mesh,k", CASES)
def test_scaled_microbatch_row_equals_full_trace(rows, arch, mesh, k):
    rc, stdout, stderr = rows[(arch, mesh, k)]
    assert rc == 0, stderr[-3000:]
    got = json.loads(stdout.strip().splitlines()[-1])
    scaled = got["True"]
    assert scaled["microbatches"] == {"n": k, "traced": 2}
    if k > 2:
        full = got["False"]
        assert full["microbatches"] == {"n": k, "traced": k}
        for key in ("cost", "collectives", "memory", "audit"):
            assert scaled[key] == full[key], (key, scaled[key], full[key])
    assert scaled["cost"]["flops"] == scaled["audit"]["expected_flops"] > 0
    assert mesh == "1x1" or scaled["collectives"]["num_collectives"] > 0
