"""Instructions a value in the inner loops of the port's CUDA kernels.

Disassembles a built kernel library (``cuobjdump -sass``), finds every
loop (a backward branch) of every kernel, and prints for each loop that
loads from global memory: its SASS instructions, the values its loads
bring (4 a 16-byte load, 2 an 8-byte one, 1 a 4-byte one), the
instructions per loaded value, and the time those instructions take at
the card's issue rate for ``--values`` values (one warp instruction per
scheduler per clock: 4 schedulers an SM at the SM's maximum clock).
Needs the CUDA toolkit and a card:

    PYTHONPATH=src python tools/sass_loops.py --source ingest --values 16777216
    PYTHONPATH=src python tools/sass_loops.py --lib build/other/libingest.so
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH = re.compile(r"\bBRA(?:\.[A-Z0-9]+)*\s+(?:`\()?(0x[0-9a-f]+)")
LOAD = re.compile(r"\bLDG\.E((?:\.[A-Z0-9]+)*)")
WIDTH = {"128": 4, "64": 2}  # values of a load by its width suffix; 1 otherwise


def tool(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which(name) or os.path.join(cuda_home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: needs the CUDA toolkit")
    return path


def functions(lib: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled kernel name: [(offset, instruction), ...]} of a library."""
    sass = subprocess.run([tool("cuobjdump"), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    out: dict[str, list[tuple[int, str]]] = {}
    body = None
    for line in sass.splitlines():
        if "Function :" in line:
            body = out.setdefault(line.split("Function :")[1].strip(), [])
        elif body is not None and (m := INSTR.search(line)):
            body.append((int(m.group(1), 16), m.group(2)))
    return out


def loops(body: list[tuple[int, str]]) -> list[dict]:
    """Each backward branch's loop: its span, instructions and loaded values."""
    found = []
    for off, ins in body:
        m = BRANCH.search(ins)
        if m and int(m.group(1), 16) <= off:
            start = int(m.group(1), 16)
            span = [i for o, i in body if start <= o <= off]
            values = 0
            for i in span:
                if (ld := LOAD.search(i)):
                    suffixes = ld.group(1).split(".")
                    values += next((n for w, n in WIDTH.items() if w in suffixes), 1)
            found.append({"start": start, "end": off, "instructions": len(span),
                          "values": values})
    return found


def demangle(names: list[str]) -> list[str]:
    for name in ("cu++filt", "c++filt"):
        try:
            path = tool(name)
        except RuntimeError:
            continue
        res = subprocess.run([path], input="\n".join(names), capture_output=True, text=True)
        if res.returncode == 0:
            return res.stdout.splitlines()
    return names


def issue_rate() -> tuple[float, str]:
    """Warp instructions a second the card can issue, and how that was read."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    return sms * 4 * mhz * 1e6, f"{sms} SMs x 4 schedulers x {mhz:.0f} MHz"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default="ingest", help="csrc/<source>.cu, built if needed")
    ap.add_argument("--lib", help="a built library instead of --source")
    ap.add_argument("--values", type=int, default=1024 * 16384,
                    help="values a launch reads, for the issue-rate time")
    args = ap.parse_args(argv)
    if args.lib:
        lib = args.lib
    else:
        from repro_torch.kernels import _build

        _build.library(args.source)
        lib = str(_build._target(args.source))
    rate, how = issue_rate()
    print(f"[sass] {lib}: issue rate {rate:.4g} warp instructions/s ({how})")
    funcs = functions(lib)
    for name, pretty in zip(funcs, demangle(list(funcs))):
        for lp in loops(funcs[name]):
            if not lp["values"]:
                continue
            per_value = lp["instructions"] / lp["values"]
            ms = per_value * args.values / 32 / rate * 1e3
            print(f"[sass] {pretty} loop 0x{lp['start']:04x}-0x{lp['end']:04x}: "
                  f"{lp['instructions']} instructions, {lp['values']} values loaded, "
                  f"{per_value:.2f} instructions a value; issue time for {args.values} "
                  f"values {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
