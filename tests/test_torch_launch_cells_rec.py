"""`lower_cell` against the reference's on one rank and the reduced meshes
(`launch_cells`): the hybrid, SSM and encoder-decoder families
(recurrentgemma, mamba2, whisper smoke configs), train, prefill and
decode, held as `test_torch_launch_cells.py` holds the others.  Also on
one rank: a row's FLOPs equal `FlopCounterMode`'s count of the same step
run on real CPU tensors, and its ``argument_bytes`` the live bytes
(`chip_smoke.py` phase 14 holds the same on the card at full width)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

import launch_cells
import torch_threads

torch_threads.cap_under_xdist()

ARCHS = ("recurrentgemma_9b", "mamba2_130m", "whisper_small")


@pytest.fixture(scope="module")
def rows():
    return launch_cells.run_both(ARCHS)


@pytest.mark.parametrize("mesh", list(launch_cells.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_reference(arch, mesh, rows):
    launch_cells.check_cells(rows, arch, mesh)


_ONE_RANK = textwrap.dedent("""
    import json, sys, torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke
    import repro_torch.launch.dryrun as dr
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import optimizer as opt, steps, tree
    out = []
    def live(*trees):
        return sum(t.numel() * t.element_size() for x in trees for t in tree.leaves(x))
    def counted(step, *args):
        step(*args)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        return fc.get_total_flops()
    for arch in sys.argv[1].split(","):
        cfg = get_smoke(arch)
        g = torch.Generator().manual_seed(0)
        model = lm.init_params(cfg, g, "cpu")
        cache = lm.init_cache(cfg, 4, 24, "cpu")
        tok = torch.randint(0, cfg.vocab, (4, 1), generator=g)
        with torch.no_grad():
            real = counted(steps.make_serve_step(cfg), model, cache, tok, 23)
        row = dr.lower_cell(arch, "d", mesh={"data": 1, "model": 1}, device="cpu",
                            spec=ShapeSpec("d", "decode", 24, 4), verbose=False, cfg=cfg)
        out.append([arch, "decode", real, row["cost"]["flops"],
                    live(lm.param_tree(model), cache, tok), row["memory"]["argument_bytes"]])
        state_dtype, topts = steps.dryrun_train_options(cfg)
        ocfg = opt.AdamWConfig(state_dtype=state_dtype)
        state = opt.init_state(ocfg, lm.param_tree(model))
        batch = {k: torch.randint(0, cfg.vocab, (8, 32), generator=g)
                 for k in ("tokens", "targets")}
        batch["loss_weights"] = torch.rand(8, generator=g)
        real = counted(steps.make_train_step(cfg, ocfg, topts), model, state, batch)
        row = dr.lower_cell(arch, "t", mesh={"data": 1, "model": 1}, device="cpu",
                            spec=ShapeSpec("t", "train", 32, 8), verbose=False, cfg=cfg)
        out.append([arch, "train", real, row["cost"]["flops"],
                    live(lm.param_tree(model), state, batch), row["memory"]["argument_bytes"]])
    print(json.dumps(out))
""")


def test_one_rank_rows_equal_flop_counter():
    """A (1, 1) row counts what `FlopCounterMode` counts on the same step
    run eagerly on real tensors, exactly, and its arguments are the live
    model, state and inputs."""
    r = subprocess.run([sys.executable, "-c", _ONE_RANK,
                        "qwen1_5_0_5b,mixtral_8x22b,recurrentgemma_9b,mamba2_130m"],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": launch_cells.SRC})
    assert r.returncode == 0, r.stderr[-3000:]
    for arch, kind, real, counted, live, args in json.loads(r.stdout.strip().splitlines()[-1]):
        assert counted == real, (arch, kind, counted, real)
        assert args == live, (arch, kind, args, live)
