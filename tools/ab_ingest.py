"""Same-call A/B of the ingest kernels: another ``ingest.cu`` against the tree's.

Builds ``--old`` (for example a parent commit's ``csrc/ingest.cu`` taken
with ``git archive`` into the gitignored ``build/``) beside the tree's
source with the port's nvcc flags, checks that both give the same
histogram counts, says whether their moments are bit-equal, and times moments and histogram_range on the main
path's operands (tpch ``l_extendedprice``, 1024 x 16384, its NB = 10
quantile edges, and its first 16 partitions alone, as a streaming delta
launches them): CUDA-graph medians (`chip_smoke.graph_ms`) in the order
old, new, new, old.  Needs the CUDA toolkit and a card:

    git archive HEAD src/repro_torch/csrc/ingest.cu | tar -x -O > build/ingest_old.cu
    python3 tools/ab_ingest.py --old build/ingest_old.cu
"""
from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def load(src: pathlib.Path, out: pathlib.Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES["ingest"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="the other ingest.cu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.data.datasets import make_dataset

    if not torch.cuda.is_available():
        print("ab_ingest: needs a CUDA device", file=sys.stderr)
        return 1
    out = ROOT / "build" / "ab_ingest"
    out.mkdir(parents=True, exist_ok=True)
    libs = {"old": load(pathlib.Path(args.old), out / f"libingest_old-{os.getpid()}.so"),
            "new": load(ROOT / "src/repro_torch/csrc/ingest.cu",
                        out / f"libingest_new-{os.getpid()}.so")}

    def stream() -> int:
        return torch.cuda.current_stream().cuda_stream

    def moments(lib, x):
        o = torch.empty((x.shape[0], 8), device=x.device)
        assert lib.repro_moments(x.data_ptr(), o.data_ptr(), *x.shape, stream()) == 0
        return o

    def histogram(lib, x, e):
        o = torch.empty((x.shape[0], e.shape[1] - 1), device=x.device)
        assert lib.repro_histogram_range(x.data_ptr(), e.data_ptr(), o.data_ptr(), *x.shape,
                                         e.shape[1] - 1, stream()) == 0
        return o

    table = make_dataset("tpch", num_partitions=1024, rows_per_partition=16384, seed=0)
    data = table.columns["l_extendedprice"]
    x = torch.from_numpy(np.ascontiguousarray(data, np.float32)).cuda()
    edges = np.quantile(data.astype(np.float64), np.linspace(0, 1, 11), axis=1).T
    e = torch.from_numpy(np.ascontiguousarray(edges, np.float32)).cuda()
    x16, e16 = x[:16].clone(), e[:16].clone()
    if not torch.equal(histogram(libs["old"], x, e), histogram(libs["new"], x, e)):
        raise AssertionError("histogram_range: old and new counts differ")
    same = torch.equal(moments(libs["old"], x).view(torch.int32),
                       moments(libs["new"], x).view(torch.int32))
    print(f"[ab] moments 1024x16384: old and new bit-equal: {same}")
    for label, fn, operands in [("moments 1024x16384", moments, (x,)),
                                ("moments 16x16384", moments, (x16,)),
                                ("histogram_range 1024x16384 NB 10", histogram, (x, e)),
                                ("histogram_range 16x16384 NB 10", histogram, (x16, e16))]:
        ms = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            call = lambda n=name, f=fn, a=operands: f(libs[n], *a)
            ms[name].append(chip_smoke.graph_ms(call, 20)[0])
        print(f"[ab] {label}: old {ms['old'][0]:.4f} / {ms['old'][1]:.4f} ms, new "
              f"{ms['new'][0]:.4f} / {ms['new'][1]:.4f} ms (CUDA-graph medians, order old new "
              "new old)", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[ab] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
