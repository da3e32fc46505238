"""Training step: chunked cross-entropy loss (never materializes the full
fp32 logits), gradient accumulation, AdamW update; port of
:mod:`repro.train.step`.

``make_train_step(model, tc)`` returns ``step(state, batch)``; ``state``
is a plain dict (checkpoint friendly):
  {"params": ..., "opt": {"mu", "nu", "step"}}
The step is functional, as the reference's: it returns a new state and
leaves its input as it was.  The gradients come from
``torch.autograd.grad`` on a leaf view of the parameters.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import tree_leaves, tree_map
from repro_torch.configs.base import TrainConfig
from repro_torch.distributed.sharding import carry_mesh, constrain
from repro_torch.models.registry import Model
from repro_torch.optim import adamw

PyTree = Any
F32 = torch.float32

LOSS_CHUNK = 512


def _chunk_loss(unembed_fn, h_c: torch.Tensor, y_c: torch.Tensor) -> tuple:
    """(summed CE over the labelled positions, their count) of one chunk."""
    logits = unembed_fn(h_c).to(F32)  # (B, chunk, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, torch.clamp(y_c, min=0)[..., None].long())
    # under a mesh: reduce the vocab shards' masked picks at once (DTensor
    # can apply a pending vocab reduction only to the gather's own shape)
    ll = constrain(ll, ("batch", "seq", None))[..., 0]
    mask = (y_c >= 0).to(F32)
    return torch.sum((lse - ll) * mask), torch.sum(mask)


def chunked_cross_entropy(unembed_fn, hidden: torch.Tensor,
                          labels: torch.Tensor,
                          chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Mean next-token CE, computed in seq chunks of ``chunk`` tokens.

    hidden: (B, S, D) post-final-norm; labels: (B, S) int, -1 = no label.
    Under grad each chunk runs in a non-reentrant checkpoint that saves
    only its inputs (the reference's ``nothing_saveable`` remat), so the
    unembed GEMM and the fp32 softmax of one chunk at a time are live:
    peak memory O(B*chunk*V), not O(B*S*V)."""
    hidden = constrain(hidden, ("batch", "seq", "embed"))
    b, s, d = hidden.shape
    # labels are already "next token": predict labels[t] from hidden[t]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s = s + pad
    nc = s // chunk
    hs = hidden.reshape(b, nc, chunk, d)
    ys = labels.reshape(b, nc, chunk)
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(nc):
        args = (unembed_fn, hs[:, i], ys[:, i])
        if torch.is_grad_enabled():
            loss_sum, n = checkpoint(carry_mesh(_chunk_loss), *args,
                                     use_reentrant=False)
        else:
            loss_sum, n = _chunk_loss(*args)
        tot, cnt = tot + loss_sum, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        hidden, aux = model.forward(params, batch, return_hidden=True)
        ce = chunked_cross_entropy(
            lambda h: model.unembed(params, h), hidden, batch["labels"]
        )
        loss = ce + sum(aux.values()) if aux else ce
        metrics = {"ce": ce, **aux}
        return loss, metrics

    return loss_fn


def _value_and_grad(loss_fn, params, batch) -> tuple:
    """((loss, metrics), grads) of ``loss_fn`` at ``params``, detached; a
    parameter the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives it."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    by_id = {id(p): (g if g is not None else torch.zeros_like(p))
             for p, g in zip(flat, grads)}
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda p: by_id[id(p)], leaves))


def make_train_step(model: Model, tc: TrainConfig):
    loss_fn = make_loss_fn(model)

    def compute_grads(params, batch):
        if tc.microbatches <= 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
            return loss, metrics, grads

        # gradient accumulation over microbatches (leading-dim split)
        def split(x):
            b = x.shape[0]
            assert b % tc.microbatches == 0, (
                f"batch {b} not divisible by microbatches {tc.microbatches}"
            )
            return x.reshape(tc.microbatches, b // tc.microbatches,
                             *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        acc = None
        for i in range(tc.microbatches):
            out = _value_and_grad(loss_fn, params,
                                  {k: v[i] for k, v in micro.items()})
            # the reference's scan carry starts at zeros: 0 + x is x
            acc = out if acc is None else tree_map(torch.add, acc, out)
        inv = 1.0 / tc.microbatches
        scale = lambda t: tree_map(lambda x: x * inv, t)
        (loss, metrics), grads = acc
        return scale(loss), scale(metrics), scale(grads)

    def step(state, batch):
        params, opt = state["params"], state["opt"]
        loss, metrics, grads = compute_grads(params, batch)
        new_params, new_opt, opt_metrics = adamw.update(grads, opt, params,
                                                        tc)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return {"params": new_params, "opt": new_opt}, metrics

    return step


def init_state(model: Model, gen: torch.Generator) -> dict:
    params = model.init(gen)
    return {"params": params, "opt": adamw.init(params)}
