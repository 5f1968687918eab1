"""`lower_cell` of the port against the reference's on the reduced meshes,
shared by `test_torch_launch_cells*.py`.

Each side runs in subprocesses of its own: the port's on a fake process
group per cell (`repro_torch.launch.mesh.fake_group`), the reference's on
8 fake XLA devices.  The reference is patched only inside its subprocess,
as `tests/test_distribution.py` does: `make_production_mesh` builds the
meshes below, `get_config` returns the smoke
configs, and reduced shapes join the shared `SHAPES` dict.  The meshes
are (1, 1), where the two counts differ only by what each package counts,
and the reduced (4, 2) and (2, 2, 2), where each partitioner also decides
what a device computes.  The port's
subprocess does the same to its own modules.

The small shapes keep every cell to seconds: train 8 × 64 tokens, prefill
8 × 64, decode of one token against a cache of 64, batch 8 (the data axes
divide it).

The port's rows carry their `op_stats.DotAudit` (``audit=True``): the
FLOPs a device are held, exactly, to the sum over the step's matmuls of
the share the placements `DTensor` runs each one under give rank 0,
computed from global shapes above `DTensor` where `OpStats` reads the
local tensors below it; and the global FLOPs of a sharded trace to the
one-rank row's count.  Against the reference the sharded FLOPs are only
bounded (`FLOPS_RATIO`), since the two partitioners choose apart.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

from repro_torch.configs import get_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SMALL = {"train_s": ("train", 64, 8), "prefill_s": ("prefill", 64, 8),
         "decode_s": ("decode", 64, 8)}
MESHES = {"1x1": {"data": 1, "model": 1}, "4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}

# FLOPs a device: the port's count over the reference's, bounds from the
# gaps measured on the seven families' cells, each widened by a tenth: a
# fallback beside the exact audit above, which is what holds a sharded
# count (a local share counted twice, or a global shape counted, breaks
# the audit, not necessarily these bounds).
# On one rank (``ONE_RANK_RTOL``) decode is equal, prefill equal but for
# whisper's (+3.26%, not broken down); a train step runs 1.25 to 4.05%
# above (mixtral, deepseek), for qwen exactly
# 2·T·d·V = 50,331,648 at 512 tokens (12,582,912 at the 128 tokens of the
# reference's `hlo_stats` of `jax.grad(loss_fn)`, with remat on or off):
# one logits product of the CE chunk, which `torch.utils.checkpoint` runs
# in the forward (for the loss) and again in the backward, where XLA
# emits it once.  On the reduced meshes each partitioner also decides
# what a device computes; the dry run holds `DTensor` to XLA's choices
# (`dryrun._dot_placements`, `_view_strategy`, `_LocalGaps`; `ROADMAP.md`
# § 3, "Two partitioners"): train 0.9952 to 1.1671, prefill 0.9854 to
# 1.1596, decode 0.9549 to 1.0000 (before the repair 0.9952 to 1.888,
# 0.9854 to 2.2838 and 1.0849 to 2.4169).  The highest are mamba2's: its
# SSD's batched products run whole over ``model``, whose chunks XLA
# splits there, and the dry run splits no batched product its operands
# hold whole.  The lower bounds stay at 0.9.
FLOPS_RATIO = {"train": (0.9, 1.29), "prefill": (0.9, 1.28), "decode": (0.9, 1.1)}
ONE_RANK_RTOL = 0.05

_PORT = textwrap.dedent("""
    import json, sys
    from repro_torch.models.config import SHAPES, ShapeSpec
    SMALL, MESHES = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    SHAPES.update({k: ShapeSpec(k, *v) for k, v in SMALL.items()})
    import repro_torch.launch.dryrun as dr
    from repro_torch.configs import get_smoke
    rows = []
    for shape in SMALL:
        for name, mesh in MESHES.items():
            try:
                row = dr.lower_cell(sys.argv[1], shape, mesh=mesh, device="cpu", verbose=False,
                                    cfg=get_smoke(sys.argv[1]), audit=True)
            except Exception as e:
                row = {"arch": sys.argv[1], "shape": shape, "mesh": name,
                       "error": f"{type(e).__name__}: {e}"[:3000]}
            rows.append(row)
    print(json.dumps(rows))
""")

_REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import repro.launch.dryrun as dr
    import repro.launch.mesh as mesh_mod
    from repro.configs import get_smoke
    from repro.models.config import SHAPES, ShapeSpec
    SMALL = json.loads(sys.argv[2])
    SHAPES.update({k: ShapeSpec(k, *v) for k, v in SMALL.items()})
    dr.get_config = lambda a: get_smoke(a)
    rows = []
    for shape in SMALL:
        for name, mesh in json.loads(sys.argv[3]).items():
            dr.make_production_mesh = lambda multi_pod=False, m=mesh: mesh_mod.make_mesh(
                tuple(m.values()), tuple(m))
            row = dr.lower_cell(sys.argv[1], shape, "pod" in mesh, verbose=False)
            row["mesh"] = name
            rows.append(row)
    print(json.dumps(rows))
""")


def run_both(archs) -> tuple[dict, dict]:
    """The reference's and the port's rows of ``archs`` on `MESHES` and the
    three small shapes, one process an arch and side, all at once → two
    {(arch, shape, mesh): row}."""
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTEST_XDIST_WORKER", None)

    def start(*argv):
        return subprocess.Popen([sys.executable, "-c", *argv], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    small, meshes = json.dumps(SMALL), json.dumps(MESHES)
    procs = [(side, start(code, a, small, meshes))
             for a in archs for side, code in (("ref", _REF), ("port", _PORT))]
    rows = {"ref": {}, "port": {}}
    for side, p in procs:
        stdout, stderr = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"{side} exit {p.returncode}: {stderr[-3000:]}")
        for r in json.loads(stdout.strip().splitlines()[-1]):
            rows[side][(r["arch"], r["shape"], r["mesh"])] = r
    return rows["ref"], rows["port"]


def token_delta(cfg, shape: str, mesh: dict) -> int:
    """The port's argument bytes beyond the reference's for one cell: its
    int64 token ids (int32 there) and no 0-d position argument (the
    reference's int32 ``pos``, which its jit prunes where nothing reads
    it: an SSM's decode step)."""
    kind, seq, batch = SMALL[shape]
    dp = math.prod(v for k, v in mesh.items() if k in ("pod", "data"))
    rows = batch // dp if batch % dp == 0 else batch
    if kind == "decode":
        return rows * 1 * 4 - (0 if cfg.attention_free else 4)
    if cfg.family == "vlm":
        seq -= cfg.n_img_tokens
    return rows * seq * 4 * (2 if kind == "train" else 1)


def check_cells(rows, arch: str, mesh: str) -> None:
    """One arch's three cells on one mesh (``rows`` from `run_both`): the
    parameter counts and argument bytes exact; the FLOPs exactly the
    audit's, whose global sum is exactly the one-rank row's, and within
    bounds of the reference's; on one rank the bytes floor
    (`roofline.floor_bytes`, which `roofline.step_bound` reads) at most
    both the reference's HBM bytes (XLA's fused buffers by `hlo_stats`'s
    rule) and the port's (the eager step's ops): a floor neither count
    goes under (the port's eager count runs at 0.10 to 0.46 of the
    reference's on these cells: the two rules count apart, and neither is
    a floor); a sharded train step communicating.  Every cell's lines are
    printed first."""
    from repro_torch.launch import roofline

    ref, port = rows
    cfg = get_smoke(arch)
    lines = []
    for shape, (kind, _, _) in SMALL.items():
        key = (arch, shape, mesh)
        p, r = port[key], ref[key]
        assert "error" not in p, p["error"]
        assert (p["params"], p["active_params"]) == (r["params"], r["active_params"])
        want = r["memory"]["argument_bytes"] + token_delta(
            cfg, shape, MESHES[mesh])
        assert p["memory"]["argument_bytes"] == want, (shape, p["memory"], r["memory"])
        flops, audit = p["cost"]["flops"], p["audit"]
        one_rank = port[(arch, shape, "1x1")]["cost"]["flops"]
        ratio = flops / r["cost"]["flops"]
        lo, hi = ((1 - ONE_RANK_RTOL, 1 + ONE_RANK_RTOL)
                  if mesh == "1x1" else FLOPS_RATIO[kind])
        floor, fused, eager = (roofline.floor_bytes(p), r["cost"]["bytes_accessed"],
                               p["cost"]["bytes_accessed"])
        replicated = [f"{d['op']}{d['shape']} {'/'.join(d['placements'])} x{d['count']} "
                      f"share {d['share']:.4g}" for d in audit["dots"]
                      if d["share"] * p["devices"] > 1][:4]
        lines.append((f"{arch} {shape} {mesh}: flops {flops:.0f} = audit "
                      f"{audit['expected_flops']:.0f} (global {audit['global_flops']:.0f}, one "
                      f"rank {one_rank:.0f}); {ratio:.4f} of the reference's "
                      f"({flops - r['cost']['flops']:+.0f}); bytes floor {floor:.0f}, "
                      f"reference (fused) {fused:.0f}, port (eager) {eager:.0f} = "
                      f"{eager / fused:.2f}x; link bytes port {p['collectives']['by_kind']} "
                      f"reference {r['collectives']['by_kind']}; not split over every rank: "
                      f"{replicated}",
                      flops == audit["expected_flops"] and audit["global_flops"] == one_rank,
                      lo <= ratio <= hi,
                      mesh != "1x1" or floor <= min(fused, eager),
                      kind != "train" or mesh == "1x1"
                      or p["collectives"]["link_bytes_total"] > 0))
    print("\n".join(line for line, *_ in lines))
    for line, *held in lines:
        assert all(held), (held, line)
