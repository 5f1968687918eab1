"""`examples/aqp_service_torch.py` against the reference's
`examples/aqp_service.py`, on the CPU.

The twin runs on the kernels' plain versions (``--device cpu``), the
reference's example in a second process beside it on its default
options, both on a small grid through their command-line arguments: per
query the same planner mode and partitions read, and the mean error
within 1e-4.
"""
import os
import re
import subprocess
import sys

import numpy as np
import torch

from test_torch_examples import ROOT, twin
import torch_threads

torch_threads.cap_under_xdist()

AQP_ARGS = ["--partitions", "32", "--rows", "256", "--queries", "3"]
LINE = re.compile(r"^  .* mode (\w+)\s+read\s+(\d+) err ([\d.]+)$")

# the reference's example in a second process, beside the twin, printing
# each answer's unrounded error (it prints them rounded to 3 places)
REFERENCE = """
import runpy, sys
import repro.queries.engine as engine
real = engine.error_metrics
def record(truth, est):
    m = real(truth, est)
    if sys._getframe(1).f_globals.get("__name__") == "__main__":
        print("ERR", repr(m["avg_rel_err"]))
    return m
engine.error_metrics = record
runpy.run_path({path!r}, run_name="__main__")
"""


def test_aqp_service_twin_matches_reference(capsys):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE.format(path=str(ROOT / "examples" / "aqp_service.py")),
         *AQP_ARGS], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the reference runs beside it on the other cores
    try:
        got = twin("aqp_service_torch").main([*AQP_ARGS, "--device", "cpu"])
        out, err = ref.communicate(timeout=300)
    finally:
        torch.set_num_threads(threads)
        ref.kill()
    assert ref.returncode == 0, err
    want = [LINE.match(x).groups()[:2] for x in out.splitlines() if LINE.match(x)]
    errs = [float(x.split()[1]) for x in out.splitlines() if x.startswith("ERR ")]
    lines = [LINE.match(x).groups()[:2] for x in capsys.readouterr().out.splitlines()
             if LINE.match(x)]
    assert len(want) == len(errs) == len(got["errors"]) > 0
    assert lines == want
    assert [(m, str(r)) for m, r in zip(got["modes"], got["reads"])] == want
    assert abs(np.mean(got["errors"]) - np.mean(errs)) <= 1e-4
