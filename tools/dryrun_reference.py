"""The reference's own dry-run grid, recorded for the port to be held to.

Runs the JAX package's `repro.launch.dryrun.lower_cell(arch, shape,
multi_pod, verbose=False)` for every (arch × applicable shape × mesh)
cell of its registry on the CPU, one subprocess a cell (the reference
module sets its own 512-device ``XLA_FLAGS`` at import), ``--jobs`` at a
time and each under ``--cell-timeout`` seconds, and writes the rows to
``--out`` (``results/dryrun_reference.json``, committed): each row the
reference's ``memory``, ``cost``, ``collectives``, ``lower_s`` and
``compile_s``, and the ``jax`` release that lowered it.  A failed cell is
an ``error`` row and the script exits 1.  The port reads these rows as
data (`repro_torch.launch.dryrun.reference_rows`,
`tools/dryrun_releases.py`); it never imports JAX.  About 3.5 minutes of
wall time for the 66 cells at 6 jobs on an 8-core CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/dryrun_reference.py --jobs 6

``--cell ARCH SHAPE MESH`` prints one cell's row as the last line;
``--dots ARCH SHAPE MESH`` prints its FLOPs a device by `dot` of the
partitioned HLO, largest first (each dot's result shape, the computation
it sits in and that computation's multiplicity, `hlo_stats`'s trip-count
product): what the reference counts, set beside the port's
`op_stats.DotAudit` groups.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

MESHES = ("16x16", "2x16x16")
KEEP = ("arch", "shape", "mesh", "devices", "params", "active_params", "lower_s",
        "compile_s", "memory", "cost", "cost_analysis_raw", "collectives",
        "collective_ops_sample")


def cells() -> list[tuple[str, str, str]]:
    """Every (arch, shape, mesh) of the reference's registry, in its order."""
    from repro.configs import all_archs, get_config
    from repro.models.config import applicable_shapes

    return [(arch, shape, mesh) for arch in all_archs()
            for shape in applicable_shapes(get_config(arch)) for mesh in MESHES]


def one(arch: str, shape: str, mesh: str) -> dict:
    """The reference's row of one cell, in this process."""
    from repro.launch import dryrun  # sets XLA_FLAGS before JAX starts

    import jax

    row = dryrun.lower_cell(arch, shape, mesh == "2x16x16", verbose=False)
    row = {k: row[k] for k in KEEP if k in row}
    row["jax"] = jax.__version__
    return row


def dots(arch: str, shape: str, mesh: str, top: int = 20) -> None:
    """Prints the reference's FLOPs a device of one cell by `dot`."""
    from repro.launch import dryrun  # sets XLA_FLAGS before JAX starts
    from repro.launch import hlo_stats

    texts = []
    analyze = hlo_stats.analyze

    def keep(text, n):
        texts.append(text)
        return analyze(text, n)

    hlo_stats.analyze = keep
    row = dryrun.lower_cell(arch, shape, mesh == "2x16x16", verbose=False)
    comps = hlo_stats._parse_computations(texts[-1])
    shapes = comps.pop("__shapes__")
    comps.pop("__entry__", None)
    mult = hlo_stats._multiplicities(comps)
    found = [(mult.get(name, 0.0) * hlo_stats._dot_flops(i, shapes), mult.get(name, 0.0),
              i.shape, name) for name, instrs in comps.items() for i in instrs if i.op == "dot"]
    total = sum(f for f, *_ in found)
    print(f"{arch} {shape} {mesh}: {row['cost']['flops']:.6g} FLOPs a device, "
          f"{len(found)} dots")
    for f, m, result, name in sorted(found, reverse=True)[:top]:
        print(f"  {f:.4g} ({f / total:.1%}) {result} x{m:g} in {name}")


def run_cell(key, timeout: float) -> dict:
    arch, shape, mesh = key
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                        os.environ.get("PYTHONPATH")])))
    t0 = time.time()
    try:
        r = subprocess.run([sys.executable, __file__, "--cell", arch, shape, mesh],
                           capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "error": f"TimeoutError: no row within {timeout:.0f} s"}
    try:
        row = json.loads(r.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        row = {"arch": arch, "shape": shape, "mesh": mesh,
               "error": f"exit {r.returncode}: {r.stderr.strip()[-400:]}"}
    row["wall_s"] = round(time.time() - t0, 2)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "results" / "dryrun_reference.json"))
    ap.add_argument("--jobs", type=int, default=6, help="cells lowered at once")
    ap.add_argument("--cell-timeout", type=float, default=900.0,
                    help="seconds a cell may take before it is an error row")
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--dots", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    args = ap.parse_args(argv)
    if args.dots:
        dots(*args.dots)
        return 0
    if args.cell:
        print(json.dumps(one(*args.cell)), flush=True)
        return 0

    keys = cells()
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        rows = list(pool.map(lambda k: run_cell(k, args.cell_timeout), keys))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    bad = [r for r in rows if "error" in r]
    print(f"{len(rows) - len(bad)}/{len(rows)} cells OK in {time.time() - t0:.0f} s; "
          f"lower + compile {sum(r.get('lower_s', 0) + r.get('compile_s', 0) for r in rows):.0f}"
          f" s summed → {args.out}")
    for r in bad:
        print("  FAIL", r["arch"], r["shape"], r["mesh"], "—", r["error"][:200])
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
