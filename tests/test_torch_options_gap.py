"""The tolerance of `chip_smoke.py`'s check (e), derived from the
reference on the CPU.

Check (e) holds one train step under a config's dry-run options
(`train.steps.dryrun_train_options`: microbatches, remat, the
accumulator) against one under ``TrainOptions(remat=False)``, card
against card, each accumulated gradient leaf in relative L2 at
``chip_smoke.TRAIN_OPTIONS_REL_L2``, under its conditions: equal loss
weights and, for the MoE, `chip_smoke.options_cfg` (the no-drop
capacity, no load-balance term).  Here the reference's own
`make_train_step` with the same two option sets, on the smoke configs of
the three archs whose options take microbatches (bf16, one batch of 8
rows), and the port's, both stay within it, and the port's remat alone
changes no bit.
"""
import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.train import optimizer as ref_opt
from repro.train import steps as ref_steps
from repro_torch import carry, configs
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import steps
from test_torch_encdec_vlm import _extras, _port_extras, _ref_extras
from test_torch_lm import reference_params
from test_torch_train import _batch, _port_batch, _ref_batch, _rel_l2
from test_torch_train_options import port_grads, reference_grads
import torch_threads

torch_threads.cap_under_xdist()

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", name="chip_smoke")
def chip_smoke_module():
    """`chip_smoke.py` as a module (it imports nothing but the standard
    library at the top)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = module  # its dataclasses look their module up
    try:
        spec.loader.exec_module(module)
    finally:
        del sys.modules["chip_smoke"]
    return module


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "internvl2_26b"])
def test_options_gap_within_check_tolerance(arch, chip_smoke, monkeypatch):
    check_options_gap(arch, chip_smoke, monkeypatch)


def check_options_gap(arch: str, chip_smoke, monkeypatch) -> None:
    """One arch of the three (deepseek's in `tests/test_torch_options_mla.py`)."""
    state_dtype, dry = steps.dryrun_train_options(configs.get_config(arch))
    assert dry.num_microbatches == 8
    ref_cfg = chip_smoke.options_cfg(ref_configs.get_smoke(arch))
    cfg = chip_smoke.options_cfg(configs.get_smoke(arch))
    assert cfg.is_moe == (cfg.router_aux_coef == 0.0)
    params = reference_params(ref_cfg, seed=0)
    base = _batch(cfg, 5, b=8, weights=False)
    extras = _extras(cfg, np.random.default_rng(5), b=8) if cfg.family == "vlm" else {}
    plain = steps.TrainOptions(remat=False)
    ocfg = opt.AdamWConfig(state_dtype=state_dtype)
    ref_ocfg = ref_opt.AdamWConfig(state_dtype=state_dtype)
    ref = {}
    for name, o in (("dry", dry), ("plain", plain)):
        ref[name] = reference_grads(
            ref_cfg, ref_ocfg, ref_steps.TrainOptions(
                num_microbatches=o.num_microbatches, remat=o.remat, accum_dtype=o.accum_dtype),
            params, ref_opt.init_state(ref_ocfg, params),
            {**_ref_batch(base), **_ref_extras(extras)}, monkeypatch)[1]
    port = {}
    no_remat = steps.TrainOptions(num_microbatches=dry.num_microbatches, remat=False,
                                  accum_dtype=dry.accum_dtype)
    for name, o in (("dry", dry), ("plain", plain), ("no_remat", no_remat)):
        model = carry.lm_params(jax.tree.map(np.asarray, params), cfg, "cpu")
        port[name] = port_grads(cfg, ocfg, o, model, opt.init_state(ocfg, lm.param_tree(model)),
                                {**_port_batch(base), **_port_extras(extras)}, monkeypatch)[1]
    tol = chip_smoke.TRAIN_OPTIONS_REL_L2
    for grads in (ref, port):
        worst = max(_rel_l2(grads["dry"][n], grads["plain"][n]) for n in grads["plain"])
        assert 0 < worst <= tol / 3, (arch, worst)
    for n, g in port["dry"].items():
        assert torch.equal(g, port["no_remat"][n]), n
