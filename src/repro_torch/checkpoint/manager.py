"""Sharded checkpointing with async write, manifest integrity, and resume.

Twin of `repro/checkpoint/manager.py`, on the same on-disk format:

Layout:  <dir>/step_<N>/
           manifest.json       tree structure, shapes, dtypes, step, extras
           shard_<host>.npz    this host's leaves (flattened keys)

  * every host writes ONLY its own leaves (one host = one shard file);
  * writes go to a temp dir + atomic rename, so a failure mid-save never
    corrupts the latest checkpoint;
  * saving runs on a background thread (the caller overlaps the
    serialization of the PREVIOUS step's state);
  * the manifest stores the caller's extras (a request's seed, block and
    bucket on the serving path).

Only the tree and dtype code differs from the reference. A tree is nested
dicts, lists, tuples and dataclasses (a `train.step.TrainState`) of torch
tensors, numpy arrays and scalars (`utils.tree`); its leaves are keyed by
their path as `jax.tree_util` keys them (dict keys sorted, list and tuple
indices and dataclass field indices, joined by '/'), and None is an empty
subtree. npz holds no bf16 or fp8, so those leaves are stored as integer
bit views (torch's own views, no ml_dtypes) under their true dtype name in
the manifest. A checkpoint written by either package opens in the other.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import leaves_with_paths as _flatten_with_paths
from repro_torch.utils.tree import unflatten as _unflatten

# dtype name in the manifest -> (torch dtype, the torch integer view of its
# bits and that view's numpy twin, the numpy dtype npz stores: the
# reference's)
_VIEW_OF = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8, np.uint8),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8, np.uint8),
}
_NAME_OF = {view[0]: name for name, view in _VIEW_OF.items()}


def _encode(leaf):
    """(host ndarray as npz stores it, true dtype name) of one leaf; a
    copy, so the caller may change the leaf once this returns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = _NAME_OF.get(t.dtype)
        if name is not None:
            _, int_view, _, stored = _VIEW_OF[name]
            return t.view(int_view).numpy().view(stored), name
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, arr.dtype.name


def _decode(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name in _VIEW_OF:
        torch_dtype, _, np_int, _ = _VIEW_OF[dtype_name]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np_int))
        return t.view(torch_dtype).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _write(encoded: dict, dtypes: dict, directory, *, step: int,
           extras: Optional[dict], host_index: int):
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}_{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / f"shard_{host_index}.npz", **encoded)
    manifest = {
        "step": step,
        "time": time.time(),
        "n_leaves": len(encoded),
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                   for k, v in encoded.items()},
        "extras": extras or {},
        "format": 1,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def _encode_tree(tree):
    encoded, dtypes = {}, {}
    for path, leaf in _flatten_with_paths(tree):
        k = _key(path)
        encoded[k], dtypes[k] = _encode(leaf)
    return encoded, dtypes


def save_pytree(tree, directory, *, step: int, extras: Optional[dict] = None,
                host_index: int = 0):
    """Synchronous sharded save with atomic rename."""
    encoded, dtypes = _encode_tree(tree)
    return _write(encoded, dtypes, directory, step=step, extras=extras,
                  host_index=host_index)


def load_pytree(template, directory, *, step: Optional[int] = None,
                host_index: int = 0):
    """Restore into the structure of `template`. Returns (tree, manifest):
    each leaf a torch tensor of its saved dtype, on the template leaf's
    device where that is a tensor, else on the CPU."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / f"shard_{host_index}.npz")
    leaves = []
    for path, leaf in _flatten_with_paths(template):
        key = _key(path)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        device = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        leaves.append(_decode(data[key], manifest["leaves"][key]["dtype"],
                              device))
    return _unflatten(template, leaves), manifest


def latest_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if p.name.split("_")[1].isdigit()]
    return max(steps) if steps else None


class CheckpointManager:
    """Async, retention-managed checkpointing."""

    def __init__(self, directory, *, keep: int = 3, host_index: int = 0):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.host_index = host_index
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree: Any, *, step: int, extras: Optional[dict] = None,
             blocking: bool = False):
        self.wait()  # one in-flight save at a time
        # the device -> host copy happens here, before the caller mutates
        # the state; the thread only writes
        encoded, dtypes = _encode_tree(tree)

        def work():
            try:
                _write(encoded, dtypes, self.directory, step=step,
                       extras=extras, host_index=self.host_index)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, template, *, step: Optional[int] = None):
        return load_pytree(template, self.directory, step=step,
                           host_index=self.host_index)

    def latest_step(self):
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(p for p in self.directory.glob("step_*"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
