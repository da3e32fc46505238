"""TE GEMM with a fused epilogue (port of :mod:`repro.kernels.te_gemm`,
the paper's RedMulE tensor engine): ``epi(x @ w + bias)`` with an fp32
accumulator, stored in ``x``'s dtype.  Epilogues: none, relu, silu and a
row softmax over the whole output row.

:func:`te_gemm` runs the plain PyTorch twin (:func:`te_gemm_torch`, the
reference oracle's arithmetic) only because the tensor it was given lies
on the CPU; on a CUDA tensor it launches ``csrc/te_gemm.cu`` (a tiled
fp32 SIMT GEMM that masks its own edges, so every shape works with no
padding) or raises.  The quantized ``te_gemm_quant`` is not ported yet
(ROADMAP queue 1).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

EPILOGUES = ("none", "relu", "silu", "softmax")
SOFTMAX_MAX_N = 256  # the widest row one block of the kernel holds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def te_gemm_torch(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  epilogue: str = "none") -> torch.Tensor:
    """Plain twin: fp32 product, + bias, epilogue, cast to x's dtype."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        z = z + bias.to(torch.float32)
    if epilogue == "relu":
        z = torch.clamp_min(z, 0.0)
    elif epilogue == "silu":
        z = z * torch.sigmoid(z)
    elif epilogue == "softmax":
        z = torch.softmax(z, dim=-1)
    return z.to(x.dtype)


def _lib():
    fn = _build.library("te_gemm").te_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def te_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 epilogue: str = "none") -> torch.Tensor:
    """Launch ``csrc/te_gemm.cu``: one block per output tile."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"te_gemm: x {tuple(x.shape)} @ w "
                         f"{tuple(w.shape)} is not (M, K) @ (K, N)")
    m, k = x.shape
    n = w.shape[1]
    if min(m, n, k) == 0:
        raise ValueError(f"te_gemm: empty operand ({m}, {k}) @ ({k}, {n})")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"te_gemm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if epilogue == "softmax" and n > SOFTMAX_MAX_N:
        raise ValueError(f"te_gemm row-softmax needs the row in one block: "
                         f"N={n} > {SOFTMAX_MAX_N}")
    args = dict(x=(x, x.dtype), w=(w, x.dtype))
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"te_gemm: bias {tuple(bias.shape)} != ({n},)")
        args["bias"] = (bias, x.dtype)
    _build.require_cuda("te_gemm", **args)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _lib()(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 m, n, k, EPILOGUES.index(epilogue), _DTYPE_CODE[x.dtype],
                 _build.stream_of(x))
    _build.launches["te_gemm"] += 1
    _build.check(err, "te_gemm")
    return out


def te_gemm(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            epilogue: str = "none") -> torch.Tensor:
    """``epi(x @ w + bias)``, x (M, K), w (K, N), bias (N,) or None: the
    CUDA kernel on a CUDA tensor (operands laid out contiguously first),
    the plain twin on a CPU tensor."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; have {EPILOGUES}")
    if x.device.type == "cpu":
        return te_gemm_torch(x, w, bias, epilogue=epilogue)
    return te_gemm_cuda(x.contiguous(), w.contiguous(),
                        None if bias is None else bias.contiguous(),
                        epilogue=epilogue)
