"""One torch CPU thread per xdist worker for the port's test files.

Torch starts one intra-op thread per core in every process.  Under
``pytest -n N`` each worker does so, and N workers' reductions and
products then fight over the same cores: a port call of 2.75 s alone
took minutes beside five copies of itself.  Each `tests/test_torch_*.py`
calls `cap_under_xdist` after its imports; a run in one process keeps
torch's default.  Nothing here reaches the reference's tests.
"""
import os

import torch


def cap_under_xdist() -> None:
    """``torch.set_num_threads(1)`` when the file runs in an xdist worker."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
