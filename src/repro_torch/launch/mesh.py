"""Mesh construction (port of :mod:`repro.launch.mesh`): the production
LM meshes and the PHY cell-serving mesh.

LM meshes are ``torch.distributed`` ``DeviceMesh`` objects over the process
group the caller started (``init_process_group``): the reference's
``jax.make_mesh`` over the visible devices becomes ``init_device_mesh``
over the group's ranks.

* Single pod: ``(16, 16)`` = 256 ranks, axes ``(data, model)``.
* Multi-pod: ``(2, 16, 16)`` = 512 ranks, axes ``(pod, data, model)``;
  ``pod`` carries only data-parallel gradient reductions under
  :data:`repro_torch.distributed.sharding.PARAM_RULES`.

The dry run (:mod:`repro_torch.launch.dryrun`) builds them over a fake
group of 256 or 512 ranks in one process.  These functions never start a
group themselves, as the reference's never touch device state at import,
and raise when the group's world size is not the mesh's size.

Multi-cell PHY serving (:mod:`repro_torch.serve.cell_mesh`) lays its steps
out on a ``(cell, batch)`` grid of local devices: one logical lane per
cell, the slots of a lane data-parallel.  The reference builds a JAX
device mesh and shards the staged ``(lanes, batch, ...)`` arrays over it.
The port's cell mesh is a plain record of that grid, a :class:`CellMesh`
(not a ``DeviceMesh``, which would need a process group that a
single-process server does not have): each grid entry is a shard of its
own, with its own staged buffers and its own captured step, and the
lanes of a shard fold into its kernels' batch axis.  A grid may name one
device more than once (a JAX mesh cannot): on one card that is how the
grid path runs (``ROADMAP.md`` queue 1, item 7 part 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

AXES = ("cell", "batch")


def _world_size() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "an LM mesh spans the current process group: call "
            "torch.distributed.init_process_group first (the dry run uses a "
            "fake group, the launcher gloo or NCCL)")
    return dist.get_world_size()


def _mesh_device_type() -> str:
    """``cuda`` under an NCCL group, else ``cpu`` (gloo ranks, and the dry
    run's fake group, whose tensors are ``meta``)."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    process group (on the device type of :func:`_mesh_device_type`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    world = _world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the group has {world}")
    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1):
    """``(world // model_axis, model_axis)`` over the group's ranks (gloo
    CPU processes, or one NCCL rank on a card)."""
    n = _world_size()
    if n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"group's {n} ranks")
    return make_mesh((n // model_axis, model_axis), ("data", "model"))


@dataclasses.dataclass(frozen=True, eq=False)
class CellMesh:
    """A ``(cell, batch)`` grid of local devices: ``devices`` is an object
    array of that shape (``devices.shape`` is the mesh shape, as a JAX
    mesh's is).  Every entry is a shard of its own, even where two
    entries name the same device."""
    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def cell(self) -> int:
        """Entries along the ``cell`` axis (the lanes' split)."""
        return int(self.devices.shape[0])

    @property
    def batch(self) -> int:
        """Entries along the ``batch`` axis (each lane's slots' split)."""
        return int(self.devices.shape[1])

    @property
    def home(self) -> torch.device:
        """Entry ``(0, 0)``'s device: where the schedulers draw slots and
        keep the cells' state."""
        return self.devices[0, 0]

    def distinct_devices(self) -> list:
        """The grid's devices, each once, in entry order."""
        out: list = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out


def local_devices(device: DeviceLike = None) -> list:
    """The local devices a mesh on ``device`` may span (None -> CUDA): every
    visible card for ``cuda`` without an index, else that one device.  So
    with two or more cards the schedulers' default mesh spans them all,
    as the reference's spans ``jax.devices()``."""
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
    one device it is ``(1, 1)``; ``devices`` may repeat a device."""
    devs = list(devices) if devices is not None else local_devices(device)
    if not devs:
        raise ValueError("a cell mesh needs at least one device")
    n = len(devs)
    cell = math.gcd(max(int(n_cells), 1), n)
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return CellMesh(arr.reshape(cell, n // cell))
