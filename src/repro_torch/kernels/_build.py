"""Build and load the hand-written CUDA kernels (`repro_torch/csrc/*.cu`).

Each source exports plain C functions and is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library under ``build/repro_torch_kernels/``
at the repository root, then loaded with `ctypes`.  No PyTorch header is
included, so a build takes seconds instead of the minutes a
``torch.utils.cpp_extension`` build takes.  The library's file name
carries a hash of its source and of the shared headers (``csrc/*.cuh``),
so an edited source is never served by a stale build.

Nothing is built at import: a wrapper calls `library` the first time it
launches on a CUDA tensor, and `build_all` compiles every source in
parallel (one ``nvcc`` each) for callers that want the build up front.

Every exported launcher takes its pointers and the CUDA stream as
``void*`` and its sizes as ``int``, and returns ``cudaGetLastError()``
after the launch; `check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from repro_torch.kernels.telemetry import TraceRegistry

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("eval", "groupagg", "ingest", "pdist", "predicate", "tree_hist")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches per kernel name; each wrapper notes one where it launches its
# CUDA kernel and nowhere else (plain-version calls are not counted)
LAUNCHES = TraceRegistry("kernel_launches")

_P = ctypes.c_void_p
_I = ctypes.c_int
# exported launcher → argtypes (pointers/stream as void*, sizes as int)
SIGNATURES = {
    "eval": {
        # x, lo, hi, gmap, values, codes, out, B, C, G, V, R, radix, stream
        "repro_fused_eval": (_P,) * 7 + (_I,) * 6 + (_P,),
    },
    "groupagg": {
        # values, mask, codes, out, B, V, R, radix, stream
        "repro_group_aggregate": (_P,) * 4 + (_I,) * 4 + (_P,),
    },
    "ingest": {
        # x, out, P, R, stream
        "repro_moments": (_P, _P, _I, _I, _P),
        # x, edges, out, P, R, NB, stream
        "repro_histogram_range": (_P, _P, _P, _I, _I, _I, _P),
        # codes, out, P, R, card, stream
        "repro_bincount": (_P, _P, _I, _I, _I, _P),
    },
    "pdist": {
        # x, centers, out, N, K, F, stream
        "repro_pdist_sq": (_P,) * 3 + (_I,) * 3 + (_P,),
    },
    "predicate": {
        # x, lo, hi, gmap, mask, count, partial, P, C, G, R, bound_pstride,
        # gmap_pstride, stream
        "repro_predicate_eval": (_P,) * 7 + (_I,) * 6 + (_P,),
    },
    "tree_hist": {
        # codes_t, feat_ids, node, g, h, out, R, C, nodes, F, B, stream
        "repro_tree_hist": (_P,) * 6 + (_I,) * 5 + (_P,),
        # x, out, M, L, stream
        "repro_cumsum_seq": (_P, _P, _I, _I, _P),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the headers a source may include
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path, pathlib.Path]:
    """Start one nvcc; it writes a temporary file that `_finish` renames."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: pathlib.Path, out: pathlib.Path) -> str:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every source not built yet, all nvcc processes at once;
    → {source: compiler log} for the sources this call built."""
    with _lock:
        pending = {n: _start(n) for n in SOURCES if not _target(n).exists()}
        return {n: _finish(n, *job) for n, job in pending.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = _target(name)
        if not out.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, kernel: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} ({msg})")


def on_cuda(kernel: str, *tensors: torch.Tensor) -> bool:
    """Which version a wrapper runs: False (the plain version) when every
    operand lies on the CPU, True (the CUDA kernel) when every operand
    lies on one CUDA device; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: no kernel for device {dev}")
    return dev.type == "cuda"


def pointer(kernel: str, name: str, t: torch.Tensor, dtype: torch.dtype,
            shape: tuple[int, ...]) -> int:
    """Device pointer of a kernel operand, after checking what the kernel
    assumes: dtype, shape and a dense row-major layout."""
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    return t.data_ptr()


def sizes(kernel: str, *values: int) -> tuple[int, ...]:
    """Sizes for ``int`` launcher arguments; raises where one would not fit."""
    for v in values:
        if not 0 <= v < 2**31:
            raise ValueError(f"{kernel}: size {v} does not fit the kernel's 32-bit int")
    return values


def stream(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
