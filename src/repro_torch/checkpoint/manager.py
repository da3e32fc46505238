"""Atomic, async checkpointing with device-following restore (port of
:mod:`repro.checkpoint.manager`).

Layout (the reference's, so a checkpoint written by either package loads
in the other):

  <dir>/step_00000100.tmp/     (written first)
      arrays.npz               flattened tree leaves ("/"-joined names)
      manifest.json            step, names, shapes, dtypes, tree structure
  <dir>/step_00000100/         (atomic rename on completion)

* atomic-rename commit: a crash mid-write never corrupts the latest
  checkpoint;
* async save: the device -> host snapshot happens synchronously (a
  consistent state), the file IO runs on a background thread;
* keep-k retention;
* restore places each leaf where the *current* target's leaf lives (the
  reference's ``shardings`` argument becomes ``device``).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars.  Leaf names follow ``jax.tree_util.
tree_flatten_with_path`` as the reference joins them: dict keys sorted,
a dict key by ``str(key)``, a sequence entry by its index, ``None`` an
empty subtree.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Any

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _map_named(tree: Tree, fn: Callable, prefix: tuple = ()) -> Tree:
    """``tree`` with each leaf replaced by ``fn(name, leaf)``, visiting
    leaves in the reference's flatten order (dict keys sorted)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: _map_named(tree[k], fn, prefix + (str(k),))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_map_named(v, fn, prefix + (str(i),))
               for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return out
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return fn("/".join(prefix), tree)


def _flatten_with_names(tree: Tree) -> dict:
    """``name -> leaf`` in flatten order (the reference's names)."""
    flat: dict = {}
    _map_named(tree, lambda name, leaf: flat.setdefault(name, leaf))
    return flat


def _structure(tree: Tree) -> str:
    """A readable record of the tree's containers (leaves as ``*``); the
    manifest keeps it, nothing reads it back."""
    return "TreeDef(" + repr(_map_named(tree, lambda _n, _l: "*")) + ")"


def host_array(leaf) -> np.ndarray:
    """A leaf on the host: a tensor (on any device) read back, anything
    else through ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Tree) -> None:
        self.wait()  # one outstanding save at a time
        # snapshot to host synchronously: consistent even if serving or
        # training goes on while the file is written
        host_state = _map_named(state, lambda _n, leaf: host_array(leaf))
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_state), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host_state)

    def _write(self, step: int, host_state: Tree) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.directory, name + ".tmp")
        final = os.path.join(self.directory, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        flat = _flatten_with_names(host_state)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": list(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "treedef": _structure(host_state),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"),
                ignore_errors=True,
            )

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list:
        steps = []
        for d in os.listdir(self.directory):
            m = _STEP_RE.match(d)
            if m and os.path.isdir(os.path.join(self.directory, d)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_flat(self, step: int) -> dict:
        """A checkpoint's raw ``name -> ndarray`` dict (the flattened
        leaves, names "/"-joined as written).

        For callers that rebuild live state procedurally instead of
        restoring into a matching tree, e.g. the serving supervisor
        reconstructing a crashed cell's :class:`CellLoop` (queues, HARQ
        buffers, RNG stream) from its snapshot."""
        path = os.path.join(self.directory, f"step_{step:08d}", "arrays.npz")
        with np.load(path) as data:
            return {k: data[k] for k in data.files}

    def restore(self, step: int, target: Tree,
                device: DeviceLike = None) -> Tree:
        """Restore into the structure of ``target``.

        Each leaf comes back as a tensor of the target leaf's shape (a
        mismatch raises) and dtype.  A tensor leaf's values go to that
        tensor's device; a numpy leaf, or a shape-only one (any object
        with ``shape`` and ``dtype``, a ``meta`` tensor included), goes to
        ``resolve_device(device)``: CUDA unless the caller says
        ``"cpu"``."""
        flat = self.load_flat(step)

        def place(name: str, tgt):
            arr = flat[name]
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"ckpt leaf {name}: shape {arr.shape} != target "
                    f"{tuple(tgt.shape)}")
            if isinstance(tgt, torch.Tensor) and tgt.device.type != "meta":
                dev = tgt.device
            else:
                dev = resolve_device(device)
            t = torch.from_numpy(arr if arr.flags.c_contiguous
                                 else arr.copy())
            return t.to(device=dev, dtype=_torch_dtype(tgt.dtype))

        return _map_named(target, place)
