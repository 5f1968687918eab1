"""Serve a small model with batched requests on the PyTorch port:
prefill + decode loop (`examples/serve_lm.py` on `repro_torch`).

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]

The reference example's arguments come first; any given here follow
them and win (``--device`` is ``cuda`` by default, and a ``cuda``
request without a GPU raises).
"""
import sys

from repro_torch.launch.serve import main as serve_main

ARGS = ["--arch", "mixtral-8x22b", "--smoke",
        "--batch", "4", "--prompt-len", "32", "--gen", "16"]


def main(argv=None):
    return serve_main([*ARGS, *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
