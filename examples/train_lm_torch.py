"""Train a small LM on the PyTorch port with the PS³ data plane (weighted
shard selection), checkpointing and straggler handling
(`examples/train_lm.py` on `repro_torch`).

    PYTHONPATH=src python examples/train_lm_torch.py [--device cpu]

The reference example's arguments come first; any given here follow
them and win (``--device`` is ``cuda`` by default, and a ``cuda``
request without a GPU raises).  Checkpoints go to
``repro_torch_quickstart_ckpt`` under the temporary directory unless
``--ckpt-dir`` says otherwise.
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main

ARGS = ["--arch", "qwen1.5-0.5b", "--smoke",
        "--steps", "60", "--batch", "8", "--ckpt-every", "20",
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_quickstart_ckpt")]


def main(argv=None):
    return train_main([*ARGS, *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
