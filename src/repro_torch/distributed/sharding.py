"""Placement of a staged multi-cell slot batch (port of the PHY part of
:mod:`repro.distributed.sharding`: ``ACT_RULES_PHY`` and
``cell_slot_shardings``).

The reference stacks a shape group's slots as ``(cell, batch, ...)``
arrays and shards them over a ``(cell, batch)`` device mesh, every key
with its own lane axis (a lane's side info included).  The port folds the
lanes into the kernels' batch axis on the mesh's one device
(:class:`repro_torch.launch.mesh.CellMesh`), so placement is:

* the batched keys stay ``(lanes, batch, ...)``, lane-major and
  contiguous on the device (host arrays, such as the HARQ priors, go
  through pinned memory with ``non_blocking=True``), so a step can view
  them as ``(lanes * batch, ...)``;
* ``noise_var`` becomes an ``(L,)`` float32 tensor, one value per lane;
* every other key is side info that is grid-static inside a shape group
  (``pilot_seq``, ``pilot_masks``, ``data_mask``): it must be equal
  across lanes, and is placed once.

The equality check runs on the device.  Reading its result synchronizes,
so a caller that overlaps staging with a running step passes ``pending=``
and calls :meth:`LaneCheck.verify` after its own synchronize.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NOISE_KEY = "noise_var"


class LaneCheck:
    """Side-info agreement across lanes, computed on the device: one
    boolean per key, read (and raised on) by :meth:`verify`."""

    def __init__(self, keys: list, flags: Optional[torch.Tensor]):
        self.keys = keys
        self.flags = flags

    def verify(self) -> None:
        if self.flags is None:
            return
        ok = self.flags.cpu().tolist()
        bad = [k for k, good in zip(self.keys, ok) if not good]
        if bad:
            raise ValueError(
                f"side info {bad} differs across the lanes of one step: a "
                "step's lanes share one grid (only noise_var is per lane)")


def _to_device(v, dev: torch.device) -> torch.Tensor:
    """``v`` on ``dev``: a host array or tensor bound for a card goes
    through pinned memory, copied without blocking the host."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    elif not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v)
    if v.device == dev:
        return v.contiguous()
    if dev.type == "cuda" and v.device.type == "cpu":
        return v.contiguous().pin_memory().to(dev, non_blocking=True)
    return v.to(dev).contiguous()


def cell_slot_placement(slot: dict, mesh, batched_keys: tuple = (), *,
                        pending: Optional[list] = None) -> dict:
    """Place a ``(lanes, ...)``-stacked slot dict on ``mesh``'s device.

    Keys in ``batched_keys`` carry ``(lanes, batch)`` leading dims and stay
    so; ``noise_var`` (one value per lane) becomes ``(L,)``; every other
    key is per-lane side info that must agree across lanes and is placed
    once.  The agreement is checked here (``pending=None``) or appended to
    ``pending`` as a :class:`LaneCheck` for the caller to verify after its
    next synchronize.  A mesh over several devices raises
    ``NotImplementedError``."""
    dev = mesh.single_device("placing a multi-cell step")
    lead = [np.shape(slot[k]) for k in batched_keys if k in slot]
    if not lead or not lead[0]:
        raise ValueError("a staged step needs a (lanes, batch, ...) key")
    n_lanes = lead[0][0]
    out, keys, flags = {}, [], []
    for k, v in slot.items():
        v = _to_device(v, dev)
        if k in batched_keys:
            if v.ndim < 2 or v.shape[0] != n_lanes:
                raise ValueError(f"{k!r}: {tuple(v.shape)} is not a "
                                 f"({n_lanes}, batch, ...) lane stack")
            out[k] = v
        elif k == NOISE_KEY:
            out[k] = v.to(torch.float32).reshape(-1)
            if out[k].numel() != n_lanes:
                raise ValueError(f"noise_var holds {out[k].numel()} values "
                                 f"for {n_lanes} lanes")
        else:
            if not v.ndim or v.shape[0] != n_lanes:
                raise ValueError(f"side info {k!r}: {tuple(v.shape)} has no "
                                 f"lane axis of {n_lanes}")
            if n_lanes > 1:
                keys.append(k)
                flags.append(torch.all(v == v[:1]))
            out[k] = v[0]
    check = LaneCheck(keys, torch.stack(flags) if flags else None)
    if pending is None:
        check.verify()
    else:
        pending.append(check)
    return out
