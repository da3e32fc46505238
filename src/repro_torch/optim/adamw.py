"""Global-norm gradient clipping (port of the part of
:mod:`repro.optim.adamw` the neural-receiver trainer uses).

A gradient tree is a nested dict / list of tensors, as the models'
parameters are (:mod:`repro_torch.common.params`); leaves are summed in
the reference's flatten order.  The norm and the scale stay 0-d tensors on
the gradients' device, so clipping never waits on the card.
"""
from __future__ import annotations

import torch

from repro_torch.common.params import PyTree, tree_leaves, tree_map


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple:
    """-> (grads scaled by min(1, max_norm / max(norm, 1e-12)), each in its
    own dtype, and the norm before clipping)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm
