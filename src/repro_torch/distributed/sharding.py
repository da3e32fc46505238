"""Logical-axis sharding rules and placements (port of
:mod:`repro.distributed.sharding`).

**LM rules.**  Two rule sets map a tensor's logical axes (the schema's
``embed``, ``mlp``, ``heads``, ... and the activations' ``batch``,
``seq``, ``kv_seq``) to mesh axes:

* ``PARAM_RULES``: weights, FSDP over ``data`` (embed dim), TP/EP over
  ``model`` (mlp / heads / vocab / expert dims), replicated across
  ``pod``;
* ``ACT_RULES``: activations and caches, batch over ``(pod, data)``, the
  decode KV cache's seq over ``model``, SSM / RWKV state heads over
  ``model``;

with the ``sp``, ``fsdp`` and ``serve_tp`` variants.  :func:`spec_for`
drops mesh axes that do not divide a dim (leftmost first: kv_heads = 8 on
a 16-way model axis stays replicated, the GQA-TP fallback) and never uses
a mesh axis twice in one spec.  It returns a ``PartitionSpec``-like tuple,
one entry per tensor dim: ``None``, a mesh-axis name, or a tuple of names
(one tensor dim sharded over several mesh dims, major to minor).

The reference hands a spec to JAX as a ``NamedSharding``; the port turns
it into DTensor placements (:func:`placements`) on a
``torch.distributed`` ``DeviceMesh`` and keeps both in a
:class:`Sharding`.  :func:`distribute` places a tree of full tensors as
DTensors; :func:`constrain` is the reference's
``with_sharding_constraint``: an identity without an activation mesh, a
``redistribute`` to the rule's placements with one.  The rules themselves
are pure functions of shapes, axes and mesh shape, so a shape-only mesh
(``axis_names`` and ``devices.shape``, as the reference's tests use) works
wherever no tensor is placed.

**PHY placement.**  The reference stacks a shape group's slots as
``(cell, batch, ...)`` arrays and shards them over a ``(cell, batch)``
device mesh, every key with its own lane axis (a lane's side info
included).  The port's mesh is a grid of local devices
(:class:`repro_torch.launch.mesh.CellMesh`); :func:`cell_slot_placement`
cuts the stack into one :class:`LaneShard` a grid entry (the lanes over
``cell``, each lane's slots over ``batch``) and places on the entry's
device:

* the batched keys as ``(lanes, batch, ...)``, lane-major and contiguous
  (host arrays, such as the HARQ priors, go through pinned memory with
  ``non_blocking=True``), so the entry's step can view them as
  ``(lanes * batch, ...)``: its lanes fold into its kernels' batch axis;
* ``noise_var`` as an ``(L,)`` float32 tensor, one value per lane;
* every other key, side info that is grid-static inside a shape group
  (``pilot_seq``, ``pilot_masks``, ``data_mask``), once: it must be equal
  across the shard's lanes.

The equality check runs on the device.  Reading its result synchronizes,
so a caller that overlaps staging with a running step passes ``pending=``
and calls :meth:`LaneCheck.verify` after its own synchronize.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.params import schema_axes, schema_shapes, tree_map

PyTree = Any

# ---------------------------------------------------------------------------
# LM rule tables (the reference's, field for field)
# ---------------------------------------------------------------------------

PARAM_RULES = {
    "embed": ("data",),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "head_dim": (),
    "layers": (),
    "layers_inner": (),
}

ACT_RULES = {
    "batch": ("pod", "data"),
    "seq": (),
    # decode KV cache: seq sharded over model (flash-decoding); when batch=1
    # leaves the data axis idle, kv_seq claims it too (the axis-reuse guard
    # in spec_for keeps batch>1 cells unchanged)
    "kv_seq": ("data", "model"),
    "heads": ("model",),
    "kv_heads": (),
    "embed": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "dispatch": ("pod", "data"),
    "head_dim": (),
    "layers": (),
    "layers_inner": (),
}

# Sequence-parallel activations: the residual stream is sharded over the
# model axis on the seq dim; attention gathers K/V (queries stay sharded).
ACT_RULES_SP = dict(ACT_RULES, seq=("model",), full_seq=())

# Serving TP: weights sharded over ``model`` only (no weight gathers on the
# decode path).
PARAM_RULES_SERVE = {
    "embed": (),
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "head_dim": (),
    "layers": (),
    "layers_inner": (),
}

# Pure FSDP: parameters fully sharded over (data x model), the batch
# data-parallel over both axes; MoE keeps EP.
PARAM_RULES_FSDP = {
    "embed": ("data", "model"),
    "mlp": (),
    "heads": (),
    "kv_heads": (),
    "vocab": ("data", "model"),
    "expert": ("model",),
    "head_dim": (),
    "layers": (),
    "layers_inner": (),
}
ACT_RULES_FSDP = dict(
    ACT_RULES, batch=("pod", "data", "model"), heads=(), mlp=(), vocab=(),
    dispatch=("pod", "data"),
)

# PHY cell-mesh serving: the ``cell`` axis, and ``batch`` over the PHY
# mesh's own ``batch`` axis too
ACT_RULES_PHY = dict(ACT_RULES, cell=("cell",), batch=("batch", "pod", "data"))

_PARAM_RULES_BY_MODE = {
    "base": PARAM_RULES,
    "sp": PARAM_RULES,
    "fsdp": PARAM_RULES_FSDP,
    "serve_tp": PARAM_RULES_SERVE,
}
_ACT_RULES_BY_MODE = {
    "base": ACT_RULES,
    "sp": ACT_RULES_SP,
    "fsdp": ACT_RULES_FSDP,
    "serve_tp": ACT_RULES,
}


def mesh_axes(mesh) -> tuple:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or
    ``axis_names`` of a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> tuple:
    """The mesh's shape: a ``DeviceMesh``'s ``shape``, or ``devices.shape``
    of a shape-only mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.shape)
    return tuple(mesh.devices.shape)


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh_axes(mesh), mesh_shape(mesh)))


def spec_for(shape: tuple, axes: tuple, rules: dict, mesh) -> tuple:
    """The reference's ``spec_for``: one entry per dim, the rule's mesh
    axes that exist, are unused and (dropped leftmost first) divide the
    dim."""
    sizes = _axis_sizes(mesh)
    used: set = set()
    entries = []
    for dim, ax in zip(shape, axes):
        cand = tuple(rules.get(ax, ())) if ax else ()
        cand = tuple(a for a in cand if a in sizes and a not in used)
        # drop axes (leftmost first) until the product divides the dim
        while cand and dim % math.prod(sizes[a] for a in cand) != 0:
            cand = cand[1:]
        if cand:
            used.update(cand)
            entries.append(cand if len(cand) > 1 else cand[0])
        else:
            entries.append(None)
    return tuple(entries)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that entry ``d`` names, ``Replicate()`` on the others.  A
    multi-axis entry shards its tensor dim over those mesh dims in mesh
    order, which is JAX's major-to-minor order for the rules' entries (all
    name their axes in ``(pod, data, model)`` order); another order
    raises.  A mesh dim of size 1 is ``Replicate()`` (the same layout:
    DTensor refuses some views of a dim "sharded" one way)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axes(mesh)
    sizes = mesh_shape(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {group} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh, the spec the rules gave and
    its DTensor placements."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _sharding(mesh, shape, axes, rules) -> Sharding:
    return Sharding(mesh, spec_for(tuple(shape), tuple(axes), rules, mesh))


def shardings_for_tree(shapes: PyTree, axes: PyTree, mesh,
                       rules: dict) -> PyTree:
    """A :class:`Sharding` per leaf of ``shapes`` (tensors, ``meta`` ones
    included) from the matching tree of logical-axis tuples."""
    def walk(tree, ax):
        if isinstance(tree, dict):
            return {k: walk(tree[k], ax[k]) for k in tree}
        if isinstance(tree, list):
            return [walk(t, a) for t, a in zip(tree, ax)]
        return _sharding(mesh, tree.shape, ax, rules)

    return walk(shapes, axes)


def param_shardings(model, mesh, mode: str = "base") -> PyTree:
    """A :class:`Sharding` per parameter of ``model``."""
    rules = _PARAM_RULES_BY_MODE[mode]
    schema = model.schema()
    return shardings_for_tree(schema_shapes(schema), schema_axes(schema),
                              mesh, rules)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def opt_state_shardings(pshard: PyTree, mesh) -> dict:
    """mu/nu inherit the parameter shardings; step is replicated."""
    return {"mu": pshard, "nu": pshard, "step": replicated(mesh)}


def batch_shardings(specs: dict, mesh, rules: Optional[dict] = None
                    ) -> dict:
    """Input batches: dim 0 (batch) over (pod, data) (``rules``: the
    reference's dry run passes ``ACT_RULES_FSDP`` in fsdp mode)."""
    rules = ACT_RULES if rules is None else rules
    return {k: _sharding(mesh, v.shape,
                         ("batch",) + (None,) * (len(v.shape) - 1), rules)
            for k, v in specs.items()}


# -- cache logical axes per family -------------------------------------------

def cache_axes(cfg, cache: dict) -> dict:
    """Logical axes for a serving cache, keyed on its entries' names."""

    def axes_for(name: str, x) -> tuple:
        nd = len(getattr(x, "shape", ()))
        if name in ("k", "v"):
            return ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        if name == "memory":
            return ("batch", None, "embed")
        if name == "pos":
            return ()
        if name in ("super_conv",):
            return ("layers", "layers_inner", "batch", None, "mlp")
        if name in ("super_ssm",):
            return ("layers", "layers_inner", "batch", "heads", None, None)
        if name in ("tail_conv",):
            return ("layers", "batch", None, "mlp")
        if name in ("tail_ssm",):
            return ("layers", "batch", "heads", None, None)
        if name in ("tm_x", "cm_x"):
            return ("layers", "batch", None, "embed")
        if name == "wkv":
            return ("layers", "batch", "heads", None, None)
        return (None,) * nd

    return {k: axes_for(k, v) for k, v in cache.items()}


def cache_shardings(cfg, cache_shapes: dict, mesh) -> dict:
    ax = cache_axes(cfg, cache_shapes)
    return {k: _sharding(mesh, v.shape, ax[k], ACT_RULES)
            for k, v in cache_shapes.items()}


# -- placing tensors -----------------------------------------------------------

def distribute(tree: PyTree, shardings: PyTree) -> PyTree:
    """Each full tensor of ``tree`` as a DTensor placed by its
    :class:`Sharding`: every rank keeps its own shard of the tensor it
    holds (no data moves; ranks must hold equal tensors, as a tree drawn
    from one seed or carried from numpy is).  A ``meta`` tensor gives a
    ``meta`` DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    def place(x, sh: Sharding):
        if isinstance(x, DTensor):
            return x.redistribute(sh.mesh, sh.placements)
        full = DTensor.from_local(x, sh.mesh, [Replicate()] * sh.mesh.ndim,
                                  run_check=False)
        return full.redistribute(sh.mesh, sh.placements)

    return tree_map(place, tree, shardings)


def full_tensor(tree: PyTree) -> PyTree:
    """The full tensor of every DTensor leaf (plain leaves as they are)."""
    from torch.distributed.tensor import DTensor

    return tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


# ---------------------------------------------------------------------------
# Activation sharding constraints
# ---------------------------------------------------------------------------
#
# Models call ``constrain(x, logical_axes)`` at each block; it is an
# identity unless a mesh is installed.  Under a mesh every tensor a step
# creates (positions, masks, zeros) is a plain tensor; the step runs in
# DTensor's ``implicit_replication`` (see :func:`activation_mesh`), which
# treats such a tensor as replicated.

_MESH_CTX = threading.local()


def set_activation_mesh(mesh, mode: str = "base"):
    _MESH_CTX.mesh = mesh
    _MESH_CTX.mode = mode


def get_activation_mesh():
    return getattr(_MESH_CTX, "mesh", None)


def sharding_mode() -> str:
    return getattr(_MESH_CTX, "mode", "base")


def sp_active() -> bool:
    return sharding_mode() == "sp"


@contextlib.contextmanager
def activation_mesh(mesh, mode: str = "base"):
    """Install ``mesh`` for :func:`constrain` (thread-local, as the
    reference's).  With a mesh, the body also runs under DTensor's
    ``implicit_replication``, so a plain tensor beside a DTensor is taken
    as replicated."""
    prev = (get_activation_mesh(), sharding_mode())
    set_activation_mesh(mesh, mode)
    try:
        if mesh is None:
            yield
        else:
            with _implicit_replication():
                yield
    finally:
        set_activation_mesh(*prev)


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's ``implicit_replication``, safe to nest: the public
    context manager clears the process-wide flag on exit, even inside an
    outer one (a checkpoint's recompute re-enters the mesh)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def carry_mesh(fn):
    """``fn`` bound to the activation mesh and mode installed now: a
    checkpointed function's recompute runs in the backward, which the
    autograd engine may run on a thread of its own (where the thread-local
    mesh is unset)."""
    mesh, mode = get_activation_mesh(), sharding_mode()
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with activation_mesh(mesh, mode):
            return fn(*args, **kwargs)

    return run


def constrain(x, axes: tuple, rules: Optional[dict] = None):
    """Constrain an activation to its logical sharding (``x`` itself
    without a mesh).  A plain tensor under a mesh is taken as the full
    value, replicated, and then resharded."""
    mesh = get_activation_mesh()
    if mesh is None:
        return x
    if rules is None:
        rules = _ACT_RULES_BY_MODE[sharding_mode()]
    from torch.distributed.tensor import DTensor, Replicate

    target = placements(spec_for(tuple(x.shape), tuple(axes), rules, mesh),
                        mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, target)


# ---------------------------------------------------------------------------
# PHY cell-mesh serving
# ---------------------------------------------------------------------------

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


@dataclasses.dataclass
class LaneShard:
    """One grid entry's share of a staged step: the lanes ``lanes`` and,
    of each, the slots ``slots``, staged on ``device``."""
    entry: tuple  # (row, column) of the grid
    device: torch.device
    lanes: slice
    slots: slice
    staged: dict


def _split(n: int, parts: int) -> list:
    """``n`` rows split over ``parts`` grid entries: equal shares where
    ``parts`` divides ``n``, else whole on the first entry (the
    reference's ``spec_for`` fallback, without computing the same rows on
    every entry)."""
    if n % parts:
        return [slice(0, n)]
    k = n // parts
    return [slice(i * k, (i + 1) * k) for i in range(parts)]


def _place_shard(slot: dict, batched_keys: tuple, dev: torch.device,
                 lanes: slice, slots: slice, pending: Optional[list]
                 ) -> dict:
    n_lanes = lanes.stop - lanes.start
    out, keys, flags = {}, [], []
    for k, v in slot.items():
        if k in batched_keys:
            out[k] = _to_device(v[lanes, slots], dev)
        elif k == NOISE_KEY:
            out[k] = _to_device(v[lanes], dev).to(torch.float32)
        else:
            v = _to_device(v[lanes], dev)
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


def cell_slot_placement(slot: dict, mesh, batched_keys: tuple = (), *,
                        pending: Optional[list] = None) -> list:
    """Place a ``(lanes, ...)``-stacked slot dict on ``mesh``'s grid (the
    port's counterpart of the reference's ``cell_slot_shardings`` +
    ``device_put``): one :class:`LaneShard` a grid entry that holds rows.

    The lanes split over the ``cell`` axis and each lane's slots over the
    ``batch`` axis; an axis that does not divide its rows leaves them
    whole on the first entry of its row or column (:func:`_split`).  Keys
    in ``batched_keys`` carry ``(lanes, batch)`` leading dims and keep
    them; ``noise_var`` (one value per lane) travels with its lanes as
    ``(L,)``; every other key is per-lane side info that must agree across
    a shard's lanes and is placed once.  The agreement is checked here
    (``pending=None``) or appended to ``pending``, one :class:`LaneCheck`
    a shard, for the caller to verify after its next synchronize."""
    lead = [tuple(np.shape(slot[k])) for k in batched_keys if k in slot]
    if not lead or len(lead[0]) < 2:
        raise ValueError("a staged step needs a (lanes, batch, ...) key")
    n_lanes, batch = lead[0][:2]
    for k, v in slot.items():
        shape = tuple(np.shape(v))
        if k in batched_keys:
            if shape[:2] != (n_lanes, batch):
                raise ValueError(f"{k!r}: {shape} is not a ({n_lanes}, "
                                 f"{batch}, ...) lane stack")
        elif k == NOISE_KEY:
            if math.prod(shape) != n_lanes:
                raise ValueError(f"noise_var holds {math.prod(shape)} "
                                 f"values for {n_lanes} lanes")
        elif not shape or shape[0] != n_lanes:
            raise ValueError(f"side info {k!r}: {shape} has no lane axis "
                             f"of {n_lanes}")
    slot = {k: (np.reshape(v, -1) if isinstance(v, np.ndarray)
                else torch.as_tensor(v).reshape(-1))
            if k == NOISE_KEY else v for k, v in slot.items()}
    return [
        LaneShard((i, j), mesh.devices[i, j], ls, ss,
                  _place_shard(slot, batched_keys, mesh.devices[i, j],
                               ls, ss, pending))
        for i, ls in enumerate(_split(n_lanes, mesh.cell))
        for j, ss in enumerate(_split(batch, mesh.batch))
    ]
