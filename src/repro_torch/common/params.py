"""Parameter schemas (port of :mod:`repro.common.params`): a model declares
a nested dict whose leaves are :class:`Param`, and :func:`init_params`
materializes it into the same nested dict of tensors.  From the schema
also come the logical axes (:func:`schema_axes`), shapes as ``meta``
tensors that allocate nothing (:func:`schema_shapes`) and the count
(:func:`count_params`); :func:`stack_schemas` stacks a per-layer schema
along a leading ``layers`` dim, the layout the LM models loop over.

Randomness comes from an explicit :class:`torch.Generator`, one draw per
leaf in the reference's leaf order (dict keys sorted, lists in order).
PyTorch cannot replay ``jax.random``, so freshly initialised weights match
the reference in distribution only; carry the reference's own arrays
across (``*_params_from_numpy`` in :mod:`repro_torch.phy.models`) to run
the same weights, and :func:`params_to_numpy` carries the port's back.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of a single parameter tensor."""

    shape: tuple
    axes: tuple  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones | scaled | uniform
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch"
            )


def _init_leaf(p: Param, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=p.dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=p.dtype, device=dev)
    # scaled in place: one leaf's draw is all the memory an init adds
    if p.init == "normal":
        return torch.randn(p.shape, generator=gen, device=dev).mul_(
            p.scale).to(p.dtype)
    if p.init == "scaled":  # 1/sqrt(fan_in), fan_in = second-to-last dim
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        return torch.randn(p.shape, generator=gen, device=dev).div_(
            math.sqrt(fan_in)).to(p.dtype)
    if p.init == "uniform":
        u = torch.rand(p.shape, generator=gen, device=dev)
        return ((2.0 * u - 1.0) * p.scale).to(p.dtype)
    raise ValueError(f"unknown init {p.init}")


def is_param(x: Any) -> bool:
    return isinstance(x, Param)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Apply ``fn`` leafwise over nested dicts / lists / tuples of the same
    structure (:class:`Param`, tensors and arrays are leaves)."""
    if isinstance(tree, dict):
        if any(sorted(r) != sorted(tree) for r in rest):
            raise ValueError(f"tree keys differ: {sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError(f"tree lengths differ: {len(tree)}")
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """Leaves in the reference's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def init_params(schema: PyTree, gen: torch.Generator) -> PyTree:
    """Materialize a schema on ``gen``'s device, one draw per leaf in the
    reference's leaf order."""
    leaves = iter([_init_leaf(p, gen) for p in tree_leaves(schema)])
    return _unflatten(schema, leaves)


def _unflatten(schema: PyTree, leaves) -> PyTree:
    if isinstance(schema, dict):
        out = {k: _unflatten(schema[k], leaves) for k in sorted(schema)}
        return {k: out[k] for k in schema}
    if isinstance(schema, (list, tuple)):
        return type(schema)(_unflatten(s, leaves) for s in schema)
    return next(leaves)


def check_shapes(schema: PyTree, tree: PyTree) -> None:
    """Raise unless ``tree`` has the schema's structure and leaf shapes."""
    def check(p: Param, x):
        if tuple(x.shape) != tuple(p.shape):
            raise ValueError(f"param shape {tuple(x.shape)} != schema "
                             f"{tuple(p.shape)}")

    tree_map(check, schema, tree)


def params_from_numpy(schema: PyTree, tree: PyTree,
                      device: torch.device, shardings: PyTree = None
                      ) -> PyTree:
    """Arrays laid out as ``schema`` (the reference's params as numpy) ->
    tensors of the schema's dtypes on ``device``; with ``shardings``
    (:func:`repro_torch.distributed.sharding.param_shardings`), DTensors
    placed by them (each rank keeps its shard of the full array)."""
    check_shapes(schema, tree)
    out = tree_map(lambda p, x: _from_numpy(x).to(device, p.dtype),
                   schema, tree)
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute

        out = distribute(out, shardings)
    return out


def _from_numpy(x) -> torch.Tensor:
    """A host copy of ``x``; a bfloat16 array (numpy has no such dtype of
    its own) is carried bit for bit through its 16-bit pattern."""
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_to_numpy(tree: PyTree) -> PyTree:
    """The reverse of :func:`params_from_numpy`: the same nested dict with
    each tensor as a numpy array on the host (the reference's layout)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def schema_axes(schema: PyTree) -> PyTree:
    """Logical-axis tree matching the parameter tree's structure."""
    return tree_map(lambda p: p.axes, schema)


def schema_shapes(schema: PyTree) -> PyTree:
    """The parameter tree as ``meta`` tensors of the schema's shapes and
    dtypes (no storage)."""
    return tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), schema)


def stack_schemas(schema: PyTree, n: int, axis_name: str = "layers"
                  ) -> PyTree:
    """Stack a per-layer schema ``n`` times along a leading dim with the
    logical axis ``axis_name`` (the models loop over that dim)."""
    return tree_map(
        lambda p: Param(shape=(n,) + tuple(p.shape),
                        axes=(axis_name,) + tuple(p.axes), init=p.init,
                        scale=p.scale, dtype=p.dtype),
        schema)


def cast_floating(tree: PyTree, dtype: torch.dtype) -> PyTree:
    """Every floating-point tensor of ``tree`` cast to ``dtype``; integer
    leaves unchanged."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def count_params(schema_or_params: PyTree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(schema_or_params))


def tree_size_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))
