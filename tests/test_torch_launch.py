"""The port's dry-run tooling (`repro_torch.launch`) vs the JAX reference's
`repro.launch`, on the CPU.

  * `specs.input_specs` against the reference's stand-ins for all ten
    configs × their applicable shapes: the same shapes, and the same
    dtype classes (the port's token ids are int64 where the reference's
    are int32, and its decode position a Python int: both named in
    `specs`);
  * `roofline.model_flops`, `model_min_bytes` and `analyze_row` against
    the reference's on the same rows: the constant-free fields equal, the
    three terms equal to the reference's recomputed with the H100's
    constants (`launch.mesh`); `step_bound` the largest of the compute
    term, the collective term and the bytes floor's; a table refused for
    rows of two torch releases;
  * `op_stats`: its ring factors against `hlo_stats.analyze` on a
    one-collective module of each kind and group size, its dot rule on
    plain matmuls, its byte rules on views, elementwise ops and window
    ops, and the peak of live bytes;
  * the shared fault of the ``ce.chunk`` knob: `lm.CE_CHUNK` changes
    nothing in either package (`lm.chunked_ce` binds its default when it
    is defined and `lm.loss_fn` passes none), while an explicit
    ``chunk`` does change the port's traffic;
  * ``python -m repro_torch.launch.dryrun`` on one production cell and
    `launch.roofline` on its row.

`lower_cell` against the reference's on the reduced meshes is in
`test_torch_launch_cells*.py`, the perf probe's knobs in
`test_torch_launch_probe.py`.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import hlo_stats
from repro.launch import mesh as ref_mesh
from repro.launch import roofline as ref_roofline
from repro.launch import specs as ref_specs
from repro.models.config import applicable_shapes as ref_applicable
from repro_torch import configs
from repro_torch.launch import mesh, op_stats, roofline, specs
from repro_torch.models import lm
from repro_torch.models.config import SHAPES, applicable_shapes
from repro_torch.train import tree
import torch_threads

torch_threads.cap_under_xdist()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _cls(dtype) -> str:
    """A dtype's class: integer ids, or the float type itself."""
    name = str(dtype).replace("torch.", "")
    return "int" if "int" in name else name


def _sig(x) -> tuple:
    return tuple(x.shape), _cls(x.dtype)


# --------------------------------------------------------------------------
# (1) the stand-ins
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_input_specs_match_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    assert applicable_shapes(cfg) == ref_applicable(ref_cfg)
    for shape_name in applicable_shapes(cfg):
        want = ref_specs.input_specs(ref_cfg, shape_name)
        got = specs.input_specs(cfg, shape_name, device="meta")
        if SHAPES[shape_name].kind != "decode":
            assert got["batch"].keys() == want["batch"].keys(), shape_name
            for k, v in want["batch"].items():
                assert _sig(got["batch"][k]) == _sig(v), (shape_name, k)
            assert got["batch"]["tokens"].dtype == specs.TOKENS == torch.int64
            continue
        assert _sig(got["tokens"]) == _sig(want["tokens"])
        assert want["pos"].shape == () and _cls(want["pos"].dtype) == "int"
        assert got["pos"] == SHAPES[shape_name].seq_len - 1
        cache, ref_cache = got["cache"], want["cache"]
        period, lead = len(cfg.block_pattern), cfg.first_dense_layers
        assert len(cache) == lead + period * ref_cache["slots"][0][
            next(iter(ref_cache["slots"][0]))].shape[0]
        for i, c in enumerate(ref_cache.get("lead", [])):
            assert {k: _sig(v) for k, v in cache[i].items()} == {
                k: _sig(v) for k, v in c.items()}
        for j, slot in enumerate(ref_cache["slots"]):
            for name, a in slot.items():
                for u in range(a.shape[0]):
                    assert _sig(cache[lead + u * period + j][name]) == (
                        tuple(a.shape[1:]), _cls(a.dtype)), (shape_name, name, u)
        for name in ("cross_k", "cross_v"):
            if name in ref_cache:
                a = ref_cache[name]
                for i in range(a.shape[0]):
                    assert _sig(cache[i][name]) == (tuple(a.shape[1:]), _cls(a.dtype))


# --------------------------------------------------------------------------
# (2) the roofline
# --------------------------------------------------------------------------
def _rows() -> list:
    """A row for every arch × applicable shape with seeded counts, the
    dry run's keys; one error row."""
    rng = np.random.default_rng(0)
    rows = []
    for arch in configs.ARCHS:
        cfg = configs.get_config(arch)
        for shape_name in applicable_shapes(cfg):
            args, fresh, aliased = (int(x) for x in rng.integers(1e8, 6e10, 3))
            rows.append({
                "arch": arch, "shape": shape_name, "mesh": "16x16", "devices": 256,
                "params": cfg.param_count(), "active_params": cfg.active_param_count(),
                "torch": torch.__version__,
                "memory": {"argument_bytes": args, "output_bytes": fresh + aliased,
                           "alias_bytes": aliased},
                "cost": {"flops": float(rng.uniform(1e10, 1e16)),
                         "bytes_accessed": float(rng.uniform(1e9, 1e13))},
                "collectives": {"link_bytes_total": float(rng.uniform(0, 1e11))},
            })
    rows.append({"arch": "llama3_405b", "shape": "train_4k", "mesh": "16x16",
                 "error": "TimeoutError: no row"})
    return rows


def test_roofline_matches_reference():
    peaks = {"compute": (ref_mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_BF16),
             "memory": (ref_mesh.HBM_BW, mesh.HBM_BW),
             "collective": (ref_mesh.ICI_BW, mesh.LINK_BW)}
    for row in _rows():
        got, want = roofline.analyze_row(row), ref_roofline.analyze_row(row)
        if "error" in row:
            assert got == want == row
            continue
        assert roofline.model_flops(row) == ref_roofline.model_flops(row)
        assert roofline.model_min_bytes(row) == ref_roofline.model_min_bytes(row)
        for k in ("model_flops", "useful_flops_ratio"):
            assert got[k] == want[k], (row["shape"], k)
        # the reference's terms recomputed with the H100's constants
        terms = {k: want[f"t_{k}_s"] * ref_peak / peak
                 for k, (ref_peak, peak) in peaks.items()}
        for k, v in terms.items():
            assert got[f"t_{k}_s"] == pytest.approx(v, rel=1e-12)
        assert got["dominant"] == max(terms, key=terms.get)
        dev = row["devices"]
        intrinsic = max(want["model_flops"] / dev / mesh.PEAK_FLOPS_BF16,
                        ref_roofline.model_min_bytes(row) / dev / mesh.HBM_BW)
        assert got["roofline_frac"] == pytest.approx(min(intrinsic / max(terms.values()), 1.0),
                                                     rel=1e-12)
        # the bound's memory term: arguments read once, fresh outputs
        # written once, and a train step's parameters and state written back
        m = row["memory"]
        floor = m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"]
        if SHAPES[row["shape"]].kind == "train":
            floor += m["alias_bytes"]
        assert roofline.floor_bytes(row) == floor
        bound = max(got["t_compute_s"], floor / mesh.HBM_BW, got["t_collective_s"])
        assert roofline.step_bound(row) == got["step_bound_s"] == bound
        assert got["t_memory_floor_s"] == floor / mesh.HBM_BW
    md = roofline.markdown_table([roofline.analyze_row(r) for r in _rows()])
    assert len(md.strip().splitlines()) == 2 + len(_rows()) and "ERROR" in md


def test_roofline_refuses_two_torch_releases(tmp_path):
    """Rows traced by two torch releases partition apart: `roofline`
    refuses to put them in one table, or a row that does not say."""
    rows = [r for r in _rows() if "error" not in r][:3]
    assert roofline.torch_release(rows) == torch.__version__
    for other in ({**rows[1], "torch": "2.11.0+cu128"},
                  {k: v for k, v in rows[1].items() if k != "torch"}):
        with pytest.raises(ValueError, match="more than one torch release"):
            roofline.torch_release([rows[0], other])
        path = tmp_path / "rows.json"
        path.write_text(json.dumps([rows[0], other]))
        with pytest.raises(ValueError):
            roofline.main(["--dryrun", str(path), "--out", str(tmp_path / "r.json"),
                           "--md", str(tmp_path / "r.md")])


def test_h100_constants():
    """The card's data-sheet peaks (NVIDIA H100 80GB HBM3, 700.00 W), not
    the reference's v5e figures, and the production meshes."""
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.HBM_BW == 3.35e12
    assert mesh.LINK_BW == 50e9
    assert mesh.production_mesh_shape() == {"data": 16, "model": 16}
    assert mesh.production_mesh_shape(True) == {"pod": 2, "data": 16, "model": 16}


# --------------------------------------------------------------------------
# (3) op_stats
# --------------------------------------------------------------------------
_HLO_KIND = {"all-gather": "all-gather", "reduce-scatter": "reduce-scatter",
             "all-reduce": "all-reduce", "all-to-all": "all-to-all",
             "collective-permute": "collective-permute"}


def _one_collective(kind: str, n_out: int, group: int, devices: int) -> str:
    groups = ("" if kind == "collective-permute"
              else f", replica_groups=[{devices // group},{group}]<=[{devices}]")
    return textwrap.dedent(f"""
        HloModule one

        ENTRY %main (x: f32[{n_out}]) -> f32[{n_out}] {{
          %x = f32[{n_out}]{{0}} parameter(0)
          ROOT %c = f32[{n_out}]{{0}} {kind}(%x){groups}
        }}
        """)


@pytest.mark.parametrize("group", [2, 4, 16])
@pytest.mark.parametrize("kind", sorted(_HLO_KIND))
def test_ring_factors_match_hlo_stats(kind, group):
    devices, n_out = 32, 1000
    want = hlo_stats.analyze(_one_collective(kind, n_out, group, devices), devices)
    got = op_stats.link_bytes(kind, n_out * 4, group)
    assert got == pytest.approx(want["link_bytes_total"], rel=1e-12)
    assert op_stats.link_bytes(kind, n_out * 4, 1) == 0.0


def test_dtype_bytes_match_hlo_stats():
    for dtype, name in op_stats._HLO_DTYPE.items():
        assert op_stats.dtype_bytes(dtype) == hlo_stats._DTYPE_BYTES[name]
        assert op_stats.dtype_bytes(dtype) == torch.empty((), dtype=dtype).element_size()


def test_dot_rule_and_byte_rules():
    a, b = torch.ones(6, 5), torch.ones(5, 7)
    x, w = torch.ones(3, 6, 5), torch.ones(3, 5, 4)
    with op_stats.OpStats() as st:
        a @ b
    assert st.flops == 2 * 6 * 7 * 5
    assert st.bytes_accessed == 4 * (6 * 5 + 5 * 7 + 6 * 7)
    with op_stats.OpStats() as st:
        torch.bmm(x, w)
        torch.addmm(torch.ones(7), a, b)
        torch.ones(2, 3, 5) @ b  # folds to one mm
    assert st.flops == 2 * 3 * 6 * 4 * 5 + 2 * 6 * 7 * 5 + 2 * 6 * 7 * 5
    big = torch.ones(1000, 8)
    with op_stats.OpStats() as st:
        big.t()  # a view: no traffic
        big[3:5]
    assert st.bytes_accessed == 0 and st.flops == 0
    idx = torch.tensor([1, 2])
    with op_stats.OpStats() as st:
        big[idx]  # a gather: 3 × its smallest operand, at most the result
    assert st.bytes_accessed == min(2 * 8 * 4, 3 * 2 * 8)
    rows = torch.zeros(2, 8)
    with op_stats.OpStats() as st:
        big[10:12] = rows  # a window write into a larger buffer
    assert st.bytes_accessed == 3 * 2 * 8 * 4
    with op_stats.OpStats() as st:
        big.add_(1.0)
    assert st.bytes_accessed == 2 * 1000 * 8 * 4


def test_peak_live_bytes():
    arg = torch.ones(100)
    with op_stats.OpStats(arguments=[arg]) as st:
        t = arg * 2  # 400 bytes live
        del t
        u = torch.zeros(50) + 1  # a temporary (200) and its result (200)
    assert st.peak_live_bytes == 400
    assert u.numel() == 50


# --------------------------------------------------------------------------
# the ce.chunk knob, dead in both packages
# --------------------------------------------------------------------------
_REF_CE = textwrap.dedent("""
    import json, numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_smoke
    from repro.launch import hlo_stats
    from repro.models import lm
    cfg = get_smoke("qwen1_5_0_5b")
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {k: jnp.asarray(rng.integers(0, cfg.vocab, (2, 256)), jnp.int32)
             for k in ("tokens", "targets")}
    out = {}
    for chunk in (1024, 64):
        lm.CE_CHUNK = chunk
        f = jax.jit(jax.grad(lambda p, b: lm.loss_fn(cfg, p, b)[0]))
        out[chunk] = hlo_stats.analyze(f.lower(params, batch).compile().as_text(), 1)
    print(json.dumps({k: [v["flops"], v["hbm_bytes"]] for k, v in out.items()}))
""")


def _port_ce_counts(chunk=None):
    cfg = configs.get_smoke("qwen1_5_0_5b")
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 256), generator=g)
             for k in ("tokens", "targets")}
    with op_stats.OpStats() as st:
        if chunk is None:
            loss = lm.loss_fn(cfg, model, batch)[0]
        else:
            h, _ = lm.forward_hidden(cfg, model, batch["tokens"])
            loss = lm.chunked_ce(h, lm._head_table(cfg, model), batch["targets"],
                                 chunk=chunk)[0]
        loss.backward()
    return st.flops, st.bytes_accessed


def test_ce_chunk_knob_is_dead_in_both_packages(monkeypatch):
    """`ROADMAP.md` § 3, "Shared with the reference and mirrored": at
    qwen-smoke, 2 × 256 tokens, ``CE_CHUNK`` 1,024 and 64 give the same
    counts in both packages; the port's chunked CE does move with an
    explicit ``chunk``, which no caller passes."""
    ref = subprocess.Popen([sys.executable, "-c", _REF_CE], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True,
                           env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"})
    base = _port_ce_counts()
    monkeypatch.setattr(lm, "CE_CHUNK", 64)
    assert _port_ce_counts() == base
    assert _port_ce_counts(chunk=64) != _port_ce_counts(chunk=1024)
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-2000:]
    counts = json.loads(out.strip().splitlines()[-1])
    assert counts["1024"] == counts["64"], counts


# --------------------------------------------------------------------------
# the CLI on one production cell
# --------------------------------------------------------------------------
def test_dryrun_and_roofline_cli(tmp_path):
    """``python -m repro_torch.launch.dryrun --device cpu --arch
    qwen1.5-0.5b --shape decode_32k --mesh single`` on the fake 16 × 16
    group writes a row with the reference's keys (less
    ``cost_analysis_raw`` and ``compile_s``), and ``launch.roofline``
    turns it into a table."""
    out = tmp_path / "dryrun.json"
    env = {**os.environ, "PYTHONPATH": SRC}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
                        "--arch", "qwen1.5-0.5b", "--shape", "decode_32k", "--mesh", "single",
                        "--out", str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    (row,) = json.loads(out.read_text())
    want = {"arch", "shape", "mesh", "devices", "params", "active_params", "lower_s",
            "memory", "cost", "collectives", "collective_ops_sample"}
    assert want <= row.keys() and not {"cost_analysis_raw", "compile_s", "error"} & row.keys()
    assert row["torch"] == torch.__version__ and row["kind"] == "decode"
    assert row["devices"] == 256 and row["mesh"] == "16x16"
    assert set(row["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "per_device_total"}
    cfg = configs.get_config("qwen1_5_0_5b")
    assert row["params"] == cfg.param_count()
    # the cache: 24 layers of (128/16, 32768, 16/16... ) k and v, batch on
    # data and head_dim on model, plus the one-token step's inputs
    cache = lm.init_cache(cfg, SHAPES["decode_32k"].global_batch,
                          SHAPES["decode_32k"].seq_len, "meta")
    cache_local = sum(t.numel() * t.element_size() for t in tree.leaves(cache)) // 256
    assert row["memory"]["alias_bytes"] == cache_local
    assert row["memory"]["argument_bytes"] > cache_local
    assert row["cost"]["flops"] > 0 and row["collectives"]["num_collectives"] > 0
    md = tmp_path / "roofline.md"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline", "--dryrun",
                        str(out), "--out", str(tmp_path / "roofline.json"), "--md", str(md)],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    text = md.read_text()
    assert f"torch {torch.__version__}" in text.splitlines()[0]
    lines = [line for line in text.splitlines() if line.startswith("|")]
    assert len(lines) == 3 and lines[2].startswith("| qwen1_5_0_5b | decode_32k | 16x16 |")
    analyzed = json.loads((tmp_path / "roofline.json").read_text())[0]
    assert analyzed["step_bound_s"] == roofline.step_bound(row) == max(
        analyzed["t_compute_s"], analyzed["t_memory_floor_s"], analyzed["t_collective_s"])
    assert math.isfinite(analyzed["roofline_frac"])
