"""`lower_cell` against the reference's on one rank and the reduced meshes
(`launch_cells`): the dense, MoE and VLM families (qwen, mixtral,
deepseek, internvl smoke configs), train, prefill and decode.

Held per cell (`launch_cells.check_cells`): ``params`` and
``active_params`` equal; ``argument_bytes`` equal to the reference's plus
the port's wider token ids (`launch_cells.token_delta`), bit for bit;
FLOPs a device equal to the audit's count from the placements, whose
global sum equals the one-rank row's, and within
`launch_cells.FLOPS_RATIO` of the reference's (``ONE_RANK_RTOL`` on one
rank); on one rank the bytes floor at most the reference's fused bytes,
and those at most the port's eager bytes; each collective kind's link
bytes printed beside the reference's, and a sharded train step's
non-zero.
"""
import pytest

import launch_cells
import torch_threads

torch_threads.cap_under_xdist()

ARCHS = ("qwen1_5_0_5b", "mixtral_8x22b", "deepseek_v2_236b", "internvl2_26b")


@pytest.fixture(scope="module")
def rows():
    return launch_cells.run_both(ARCHS)


@pytest.mark.parametrize("mesh", list(launch_cells.MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cells_match_reference(arch, mesh, rows):
    launch_cells.check_cells(rows, arch, mesh)
