"""AdamW with warmup + cosine schedule and global-norm clipping (port of
:mod:`repro.optim.adamw`).

A tree is a nested dict / list of tensors, as the models' parameters are
(:mod:`repro_torch.common.params`); leaves are visited in the reference's
flatten order (dict keys sorted), so the gradient norm sums in its order.
The step counter, the learning rate, the bias corrections, the norm and
the clip scale stay tensors on the parameters' device, so an update never
waits on the card.

The decay is the reference's: ``wd * p`` is added to the Adam direction
before the learning rate scales it (``torch.optim.AdamW`` decays by
``lr * wd`` apart from the Adam step, another update).
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.params import PyTree, tree_leaves, tree_map
from repro_torch.configs.base import TrainConfig

F32 = torch.float32


def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(F32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def init(params: PyTree) -> dict:
    """Zero moments, always fp32 (parameters may be bf16: low-precision
    parameters, full-precision optimizer state), and a 0-d int32 step on
    the parameters' device."""
    zeros32 = lambda t: tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), t)
    dev = tree_leaves(params)[0].device
    return {"mu": zeros32(params), "nu": zeros32(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over every leaf of its squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple:
    """-> (grads scaled by min(1, max_norm / max(norm, 1e-12)), each in its
    own dtype, and the norm before clipping).  A low-precision leaf is
    scaled in fp32 and rounded once, as the reference's promotion does."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gnorm


def update(grads: PyTree, opt_state: dict, params: PyTree,
           tc: TrainConfig) -> tuple:
    """Returns (new_params, new_opt_state, metrics); the inputs are left
    as they were."""
    step = opt_state["step"] + 1
    lr = lr_schedule(tc, step)
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    b1, b2, eps, wd = tc.beta1, tc.beta2, tc.eps, tc.weight_decay
    c1 = 1.0 - b1 ** step.to(F32)
    c2 = 1.0 - b2 ** step.to(F32)

    new_m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.to(F32), grads,
                     opt_state["mu"])
    new_v = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(
        g.to(F32)), grads, opt_state["nu"])

    def upd(m, v, p):
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype)

    new_p = tree_map(upd, new_m, new_v, params)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, {"mu": new_m, "nu": new_v, "step": step}, metrics
