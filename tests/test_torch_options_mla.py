"""deepseek-v2-236b's cases of `tests/test_torch_train_options.py` and
`tests/test_torch_options_gap.py` (MLA, the dense lead layer and shared
experts under the dry-run options: int8 states, 8 microbatches, remat, a
bf16 accumulator), in a file of their own to keep each file short.
"""
from test_torch_options_gap import chip_smoke_module as chip_smoke  # noqa: F401 (a fixture)
from test_torch_options_gap import check_options_gap
from test_torch_train_options import check_dryrun_step
import torch_threads

torch_threads.cap_under_xdist()


def test_dryrun_step_matches_reference_mla(monkeypatch):
    check_dryrun_step("deepseek-f32", monkeypatch)


def test_options_gap_within_check_tolerance_mla(chip_smoke, monkeypatch):  # noqa: F811
    check_options_gap("deepseek_v2_236b", chip_smoke, monkeypatch)
