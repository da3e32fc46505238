"""The PHY cell-serving mesh (port of :func:`repro.launch.mesh.
make_cell_mesh`; the LM meshes of that module wait for the LM stack).

Multi-cell serving (:mod:`repro_torch.serve.cell_mesh`) lays its steps
out on a ``(cell, batch)`` grid of local devices: one logical lane per
cell, the slots of a lane data-parallel.  The reference builds a JAX
device mesh and shards the staged ``(lanes, batch, ...)`` arrays over it.
The port folds the lanes into the kernels' batch axis on one device
instead, so its mesh is a plain record of that grid: a
:class:`CellMesh`, not a ``torch.distributed`` ``DeviceMesh``, which
would need a process group that a single-process server does not have.
The schedulers serve a mesh of one device; lanes across several cards are
``ROADMAP.md`` queue 1, item 7 part 3.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

AXES = ("cell", "batch")


@dataclasses.dataclass(frozen=True, eq=False)
class CellMesh:
    """A ``(cell, batch)`` grid of local devices: ``devices`` is an object
    array of that shape (``devices.shape`` is the mesh shape, as a JAX
    mesh's is)."""
    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def single_device(self, what: str = "multi-cell serving"
                      ) -> torch.device:
        """The mesh's one device; raise ``NotImplementedError`` for a mesh
        over several (lanes across cards are not ported)."""
        if self.size != 1:
            raise NotImplementedError(
                f"{what} on a {self.shape[0]}x{self.shape[1]} mesh of "
                f"{self.size} devices: the port folds lanes into one "
                "device's batch axis; lanes across several cards are "
                "ROADMAP.md queue 1, item 7 part 3, which waits for a "
                "machine with two cards")
        return self.devices.flat[0]


def local_devices(device: DeviceLike = None) -> list:
    """The local devices a mesh on ``device`` may span (None -> CUDA): every
    visible card for ``cuda`` without an index, else that one device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_cell_mesh(n_cells: int, device: DeviceLike = None, *,
                   devices: Optional[Sequence[torch.device]] = None
                   ) -> CellMesh:
    """``(cell, batch)`` mesh over the local devices (``devices``, or
    :func:`local_devices` of ``device``) for multi-cell PHY serving.

    The reference's rule: the ``cell`` axis gets the largest device-count
    divisor that also divides ``n_cells``, the rest go to ``batch``.  On
    one device it is ``(1, 1)``."""
    devs = list(devices) if devices is not None else local_devices(device)
    if not devs:
        raise ValueError("a cell mesh needs at least one device")
    n = len(devs)
    cell = math.gcd(max(int(n_cells), 1), n)
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return CellMesh(arr.reshape(cell, n // cell))
