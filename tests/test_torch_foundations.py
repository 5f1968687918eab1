"""The port's foundations: data, query IR, carry, options, import isolation.

* `make_dataset` gives byte-identical columns (and fingerprints and
  workloads) to the reference for every dataset, from the same seed;
* `repro_torch.carry` moves tables and queries across unchanged;
* a CUDA request without a usable CUDA device raises — the port never
  carries on on the CPU unless asked;
* every `repro_torch` module imports with `jax` and `repro` blocked;
* a kernel library's build name changes with its shared headers.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro.data.datasets import DATASETS as REF_DATASETS
from repro.data.datasets import make_dataset as ref_make_dataset
from repro.queries.generator import WorkloadSpec as RefWorkloadSpec
from repro_torch import carry
from repro_torch.backends import ExecOptions
from repro_torch.core.sketches import build_sketches
from repro_torch.data.datasets import DATASETS, make_dataset
from repro_torch.kernels import ops
from repro_torch.queries import engine
from repro_torch.queries.generator import WorkloadSpec
import torch_threads

torch_threads.cap_under_xdist()

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


@pytest.mark.parametrize("name", sorted(REF_DATASETS))
def test_make_dataset_byte_identical(name):
    assert sorted(DATASETS) == sorted(REF_DATASETS)
    ref = ref_make_dataset(name, num_partitions=6, rows_per_partition=96, seed=11)
    got = make_dataset(name, num_partitions=6, rows_per_partition=96, seed=11)
    assert got.name == ref.name
    assert [(s.name, s.kind, s.cardinality, s.positive, s.groupable) for s in got.schema] == [
        (s.name, s.kind, s.cardinality, s.positive, s.groupable) for s in ref.schema
    ]
    for col, data in ref.columns.items():
        assert got.columns[col].dtype == data.dtype
        assert got.columns[col].tobytes() == data.tobytes()
    assert got.fingerprint() == ref.fingerprint()
    want = [q.describe() for q in RefWorkloadSpec(ref, seed=3).sample_workload(30)]
    assert [q.describe() for q in WorkloadSpec(got, seed=3).sample_workload(30)] == want


def test_carry_round_trip():
    ref = ref_make_dataset("kdd", num_partitions=4, rows_per_partition=64, seed=2)
    t = carry.table(ref)
    assert t.fingerprint() == ref.fingerprint()
    assert t.columns["count"] is not ref.columns["count"]  # a copy, not a view
    queries = RefWorkloadSpec(ref, seed=5).sample_workload(20)
    assert [q.describe() for q in carry.queries(queries)] == [q.describe() for q in queries]


def test_options_reject_unknown_backend():
    with pytest.raises(ValueError):
        ExecOptions(backend="tpu")
    assert ExecOptions().backend == "device" and ExecOptions().device == "cuda"


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = make_dataset("tpch", num_partitions=2, rows_per_partition=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExecOptions().torch_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_sketches(table)
    q = WorkloadSpec(table, seed=0).sample_workload(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.per_partition_answers_batch(table, q)
    # the host backend needs no device
    assert len(engine.per_partition_answers_batch(
        table, q, options=ExecOptions(backend="host"))) == 1


def test_kernel_on_unknown_device_raises():
    with pytest.raises(ValueError):
        ops.bincount_op(torch.zeros((2, 8), dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError):  # operands on two devices
        ops.histogram_range_op(torch.zeros((2, 8)), torch.zeros((2, 3), device="meta"))


def test_build_names_hash_shared_headers(tmp_path, monkeypatch):
    """A library's file name carries a hash of its source and of the shared
    headers it may include (csrc/groupagg.cuh), so an edited header is never
    served by a stale build of eval.cu or groupagg.cu."""
    from repro_torch.kernels import _build

    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert (tmp_path / "groupagg.cuh").exists()
    before = {n: _build._target(n) for n in ("eval", "groupagg")}
    assert _build._target("eval") == before["eval"]  # the same sources, the same name
    with open(tmp_path / "groupagg.cuh", "a") as fh:
        fh.write("// edited\n")
    for name, target in before.items():
        assert _build._target(name) != target


BLOCKER = """
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(*names)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", BLOCKER], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 30  # every module of the port was imported
    assert {"repro_torch.faults", "repro_torch.serving.engine", "repro_torch.serving.frontdoor",
            "repro_torch.core.baselines", "repro_torch.lifecycle", "repro_torch.wal"} <= names


def test_port_sources_import_neither_jax_nor_reference():
    """Also the imports inside functions, which importing a module skips."""
    pattern = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)
    sources = sorted((SRC / "repro_torch").rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    hits = [f"{p}: {m.group(0).strip()}" for p in sources
            for m in pattern.finditer(p.read_text())]
    assert not hits, hits
    assert len(sources) >= 30
