"""Flash multi-head attention (port of :mod:`repro.kernels.mha`): q, k, v
(BH, S, D) with batch and heads flattened, scores ``q * D**-0.5 @ k^T``,
an optional causal mask (``q_pos >= k_pos``, -1e30 fill), softmax in fp32,
output in q's dtype.

:func:`mha` runs the plain PyTorch twin (:func:`mha_torch`, the reference
oracle's arithmetic) only because the tensor it was given lies on the CPU;
on a CUDA tensor it launches ``csrc/mha.cu`` (online softmax over key
tiles, scores never in device memory) or raises.  The quantized
``mha_quant`` is not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mha_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """Plain twin: the whole score matrix, masked, softmaxed, times v."""
    d = q.shape[-1]
    s = (q.to(torch.float32) * d ** -0.5) @ k.to(torch.float32).transpose(
        -1, -2)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)


def _lib():
    fn = _build.library("mha").mha_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True) -> torch.Tensor:
    """Launch ``csrc/mha.cu``: one block per (bh, 64-row query tile)."""
    if q.ndim != 3 or k.ndim != 3 or tuple(k.shape) != tuple(v.shape) or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"mha: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not (BH, Sq, D), (BH, Sk, D)")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"mha kernel has no instance for D={d}; "
                         f"instances: {HEAD_DIMS}")
    if min(bh, sq, sk) == 0:
        raise ValueError(f"mha: empty operand {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"mha kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    _build.require_cuda("mha", q=(q, q.dtype), k=(k, q.dtype),
                        v=(v, q.dtype))
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 bh, sq, sk, d, int(causal), d ** -0.5, _DTYPE_CODE[q.dtype],
                 _build.stream_of(q))
    _build.launches["mha"] += 1
    _build.check(err, "mha")
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True) -> torch.Tensor:
    """Attention over (BH, S, D) operands: the CUDA kernel on a CUDA tensor
    (laid out contiguously first), the plain twin on a CPU tensor."""
    if q.device.type == "cpu":
        return mha_torch(q, k, v, causal=causal)
    return mha_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                    causal=causal)
