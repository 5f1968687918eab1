"""The examples' twins on the port (`examples/*_torch.py`), on the CPU.

  * (`aqp_service_torch` against the reference's example:
    `tests/test_torch_examples_aqp.py`)
  * `quickstart_torch` on a 32 x 256 table: its picker reads no more
    than the budget, with finite errors;
  * `serve_lm_torch` and `train_lm_torch` at ``--device cpu`` (the train
    twin 2 steps with a checkpoint each into a temporary directory);
  * every twin imports neither JAX nor the reference, and refuses a
    ``cuda`` request without a GPU (their default device).
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import torch_threads

torch_threads.cap_under_xdist()

ROOT = pathlib.Path(__file__).resolve().parent.parent
TWINS = ("quickstart_torch", "aqp_service_torch", "serve_lm_torch", "train_lm_torch")


def twin(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_twin_reads_within_budget():
    out = twin("quickstart_torch").main(["--partitions", "32", "--rows", "256",
                                         "--device", "cpu"])
    assert 0 < out["read"] <= out["budget"] == 3
    for m in (out["errors"], out["uniform"]):
        assert np.isfinite(list(m.values())).all()


def test_serve_lm_twin_on_cpu():
    run = twin("serve_lm_torch").main(["--device", "cpu"])
    assert run.cfg.name.startswith("mixtral")
    assert run.served.tokens.shape == (4, 17)
    assert all(bool(torch.isfinite(x.float()).all()) for x in run.served.step_logits)


def test_train_lm_twin_on_cpu(tmp_path):
    losses = twin("train_lm_torch").main(["--device", "cpu", "--steps", "2", "--ckpt-every", "1",
                                          "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1", "step_2"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_reference(name):
    pattern = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)
    source = (ROOT / "examples" / f"{name}.py").read_text()
    assert not pattern.findall(source)
    assert re.search(r"^from repro_torch[.\s]", source, re.M)


@pytest.mark.parametrize("name", TWINS)
def test_twin_cuda_without_gpu_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin(name).main([])
