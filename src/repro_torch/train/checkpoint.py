"""Fault-tolerant checkpointing of tensor trees, on the reference's format.

Layout per step:   <dir>/step_<n>/  arrays.npz + manifest.json
Write protocol:    serialize → tmp dir → fsync → os.replace (atomic), so a
crash mid-save never corrupts the latest checkpoint; `latest_step` only
considers directories whose manifest exists (the marker written last).
Retention:         keep_last K; older steps garbage-collected post-commit.
Async:             `save(..., blocking=False)` copies the tree to the host
before it returns (the caller may then update its tensors in place) and
hands the write to a background thread; at most one save is in flight.

Arrays are saved as full tensors keyed by tree path (`repro_torch.train.
tree`: dict keys and sequence indices joined with ``/``, an int8 ``(q,
scale)`` state as ``.../0`` and ``.../1``), bf16 stored as its ``uint16``
bit view — the
reference's `repro.train.checkpoint` format, so a checkpoint it wrote for
a tree with the same paths and dtypes loads here byte for byte.
`restore(step, like, shardings, device)` places the leaves on ``device``
(by default each on its ``like`` leaf's device) or, given a same-structure
tree of `distributed.sharding.NamedSharding`s, distributes each onto its
mesh (elastic restore: a checkpoint saved whole, or on another mesh,
restores onto any mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.train.tree import flatten, rebuild

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
          torch.int8: np.int8, torch.int16: np.int16, torch.int32: np.int32,
          torch.int64: np.int64, torch.uint8: np.uint8, torch.bool: np.bool_}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_npz(t: torch.Tensor) -> np.ndarray:
    """npz can't represent bfloat16 — store as uint16 bit view."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_npz(arr: np.ndarray, want: torch.dtype) -> torch.Tensor:
    if want == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(_NUMPY[want], order="C"))


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ---- write -----------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = True, extra: dict | None = None):
        self.wait()  # one save in flight
        # a synchronous host copy: the tree's tensors may change in place
        # as soon as this returns
        host = {k: v.detach().to("cpu", copy=True) for k, v in flatten(tree).items()}
        if blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(target=self._write, args=(step, host, extra or {}))
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{k: _to_npz(v) for k, v in flat.items()})
        manifest = {
            "step": step,
            "paths": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---- read ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "manifest.json")
            ):
                out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree, shardings=None, device=None):
        """Restore into the structure of `like_tree` (shapes must match;
        dtypes follow its leaves), each leaf on ``device`` or, by
        default, on its ``like_tree`` leaf's device; ``shardings`` (the
        same structure of `NamedSharding`s) makes each leaf a `DTensor`
        placed on its sharding's mesh (elastic re-sharding)."""
        d = os.path.join(self.dir, f"step_{step}")
        flat_like = flatten(like_tree)
        flat_sh = flatten(shardings) if shardings is not None else None
        by_path = {}
        with np.load(os.path.join(d, "arrays.npz")) as data:
            for k, want in flat_like.items():
                arr = data[k]
                if tuple(arr.shape) != tuple(want.shape):
                    raise ValueError(f"{k}: shape {arr.shape} != {tuple(want.shape)}")
                t = _from_npz(arr, want.dtype)
                if flat_sh is not None:
                    from torch.distributed.tensor import distribute_tensor

                    sh = flat_sh[k]
                    by_path[k] = distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                                   sh.placements)
                else:
                    by_path[k] = t.to(want.device if device is None else device)
        return rebuild(like_tree, by_path)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.dir, f"step_{step}", "manifest.json")) as f:
            return json.load(f)
