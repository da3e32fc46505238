"""Error-feedback gradient compression (port of
:mod:`repro.optim.compression`).

Two codecs:
  int8  -- per-leaf symmetric quantization (scale = max|g| / 127)
  topk  -- keep the top-k fraction by magnitude, zero the rest

Both are used with error feedback: the compression residual is added back
to the next step's gradient (Karimireddy et al., 2019).  The reference
runs them inside a ``shard_map`` over its ``pod`` axis; the port has one
card and no such axis, so they are the pure per-leaf functions.
"""
from __future__ import annotations

import torch

from repro_torch.common.params import PyTree, tree_map

F32 = torch.float32


def int8_encode(g: torch.Tensor) -> tuple:
    """-> (int8 codes, fp32 scale); ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def topk_mask(g: torch.Tensor, fraction: float) -> torch.Tensor:
    """1 where |g| reaches the k-th largest |g| (ties at it kept), else 0."""
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(flat.numel() * fraction))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(g) >= thresh).to(g.dtype)


def compress_leaf(g: torch.Tensor, err: torch.Tensor, method: str,
                  topk_fraction: float = 0.05) -> tuple:
    """Returns (compressed_g, new_err); compressed_g is fp32 (decoded)."""
    g32 = g.to(F32) + err
    if method == "int8":
        q, scale = int8_encode(g32)
        dec = int8_decode(q, scale)
    elif method == "topk":
        dec = g32 * topk_mask(g32, topk_fraction)
    else:
        raise ValueError(method)
    return dec, g32 - dec


def compress_grads(grads: PyTree, err_state: PyTree, method: str,
                   topk_fraction: float = 0.05) -> tuple:
    """Error-feedback compression over a gradient tree."""
    dec = tree_map(lambda g, e: compress_leaf(g, e, method, topk_fraction)[0],
                   grads, err_state)
    new_err = tree_map(lambda g, e, d: g.to(F32) + e - d, grads, err_state,
                       dec)
    return dec, new_err


def init_error_state(params: PyTree) -> PyTree:
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
