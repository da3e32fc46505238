"""Fused FC + row softmax (port of :mod:`repro.kernels.fc_softmax`, the
paper's FC block, Sec. V-C): ``softmax(x @ w + bias)`` over the whole
output row, fp32 accumulate, output in x's dtype.

:func:`fc_softmax` runs the plain PyTorch twin (:func:`fc_softmax_torch`)
only because the tensor it was given lies on the CPU; on a CUDA tensor it
launches ``csrc/fc_softmax.cu`` (a thread-block cluster of up to 8
blocks owns 32 rows (fp32) or 64 rows (bf16) and the whole row of
N <= :data:`MAX_N` columns, 64 a block, so the softmax never leaves the
chip) or raises.  A wider row goes to ``te_gemm.cu``'s row softmax (two
passes, any N; counted as a ``te_gemm`` launch).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, te_gemm

MAX_N = 512  # the widest row one cluster of the kernel holds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fc_softmax_torch(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin: fp32 product, + bias, row softmax, cast to x's dtype."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        z = z + bias.to(torch.float32)
    return torch.softmax(z, dim=-1).to(x.dtype)


def _lib():
    fn = _build.library("fc_softmax").fc_softmax_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fc_softmax_cuda(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/fc_softmax.cu``: one cluster per 32 (fp32) or 64
    (bf16) rows, one block per 64 columns; above :data:`MAX_N` columns,
    ``te_gemm.cu``'s two-pass row softmax."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fc_softmax: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} is not (M, K) @ (K, N)")
    m, k = x.shape
    n = w.shape[1]
    if min(m, n, k) == 0:
        raise ValueError(f"fc_softmax: empty operand ({m}, {k}) @ "
                         f"({k}, {n})")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fc_softmax kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if n > MAX_N:  # wider than one cluster holds
        return te_gemm.te_gemm_cuda(x, w, bias, epilogue="softmax")
    args = dict(x=(x, x.dtype), w=(w, x.dtype))
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"fc_softmax: bias {tuple(bias.shape)} != "
                             f"({n},)")
        args["bias"] = (bias, torch.float32)
    _build.require_cuda("fc_softmax", **args)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _lib()(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 m, n, k, _DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.launches["fc_softmax"] += 1
    _build.check(err, "fc_softmax")
    return out


def fc_softmax(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(x @ w + bias)``, x (M, K), w (K, N), bias (N,) or None:
    the CUDA kernel on a CUDA tensor (operands laid out contiguously, the
    bias in fp32), the plain twin on a CPU tensor."""
    if x.device.type == "cpu":
        return fc_softmax_torch(x, w, bias)
    return fc_softmax_cuda(
        x.contiguous(), w.contiguous(),
        None if bias is None else bias.to(torch.float32).contiguous())
