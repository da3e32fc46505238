"""Fused depthwise-separable conv block (port of
:mod:`repro.kernels.dwconv_block`, the paper's Sec. V-C block): depthwise
3x3 on a pre-padded x (B, H+2, W+2, C) with dw (3, 3, C), pointwise
(C, F) GEMM, LayerNorm over F (``var = mean((z - mu)**2)``,
``rsqrt(var + eps)``), gamma / beta, ReLU -> (B, H, W, F) in x's dtype.

:func:`dwconv_block` runs the plain PyTorch twin (:func:`dwconv_block_torch`)
only because the tensor it was given lies on the CPU; on a CUDA tensor it
launches ``csrc/dwconv_block.cu`` or raises: a block takes 64 pixels and a
slab of F, the pointwise product on tf32 wgmmas (3xTF32) fed by a TMA
ring; the slabs of a pixel tile meet for the LayerNorm in a cluster up to
F = 1024, a wider F is normalised by a second, row-wise pass.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

EPS = 1e-5
_CLUSTER_F = 1024  # the widest row one cluster normalises (8 slabs of 128)
_WIDE_SLAB = 128  # a wider row's slab: partial sums per (pixel, slab)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dwconv_block_torch(x_padded: torch.Tensor, dw: torch.Tensor,
                       pw: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Plain twin, in the reference kernel's order: the nine depthwise
    taps in fp32, the pointwise product, LayerNorm, gamma / beta, ReLU."""
    b, hp, wp, c = x_padded.shape
    h, w = hp - 2, wp - 2
    xf = x_padded.to(torch.float32)
    dwf = dw.to(torch.float32)
    y = torch.zeros((b, h, w, c), dtype=torch.float32,
                    device=x_padded.device)
    for di in range(3):
        for dj in range(3):
            y = y + xf[:, di: di + h, dj: dj + w, :] * dwf[di, dj]
    z = y.reshape(b * h * w, c) @ pw.to(torch.float32)
    mu = torch.mean(z, dim=-1, keepdim=True)
    var = torch.mean(torch.square(z - mu), dim=-1, keepdim=True)
    z = (z - mu) * torch.rsqrt(var + eps)
    z = z * gamma.to(torch.float32) + beta.to(torch.float32)
    return torch.clamp_min(z, 0.0).reshape(b, h, w, -1).to(x_padded.dtype)


def _lib():
    fn = _build.library("dwconv_block").dwconv_block_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data starts on 16 bytes (the kernel's
    copies are 16 bytes wide)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dwconv_block_cuda(x_padded: torch.Tensor, dw: torch.Tensor,
                      pw: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Launch ``csrc/dwconv_block.cu`` (the filters in fp32).  C is padded
    with zero channels to 16 bytes of x and pw's rows with zero columns
    to a multiple of 4, where they are not already, so that the kernel's
    copies are 16 bytes; the padding adds zeros to every sum."""
    if x_padded.ndim != 4 or x_padded.shape[1] < 3 or x_padded.shape[2] < 3:
        raise ValueError(f"dwconv_block: x {tuple(x_padded.shape)} is not "
                         f"(B, H+2, W+2, C)")
    b, hp, wp, c = x_padded.shape
    h, w = hp - 2, wp - 2
    f = pw.shape[-1]
    if tuple(dw.shape) != (3, 3, c) or tuple(pw.shape) != (c, f) or \
            tuple(gamma.shape) != (f,) or tuple(beta.shape) != (f,):
        raise ValueError(f"dwconv_block: dw {tuple(dw.shape)}, pw "
                         f"{tuple(pw.shape)}, gamma {tuple(gamma.shape)}, "
                         f"beta {tuple(beta.shape)} do not fit C={c}")
    if min(b, c, f) == 0:
        raise ValueError(f"dwconv_block: empty operand "
                         f"{tuple(x_padded.shape)} -> F={f}")
    if x_padded.dtype not in _DTYPE_CODE:
        raise TypeError(f"dwconv_block kernel takes float32 or bfloat16, "
                        f"got {x_padded.dtype}")
    f32 = torch.float32
    _build.require_cuda("dwconv_block", x=(x_padded, x_padded.dtype),
                        dw=(dw, f32), pw=(pw, f32), gamma=(gamma, f32),
                        beta=(beta, f32))
    ve = 16 // x_padded.element_size()
    if c % ve:
        pad_c = ve - c % ve
        x_padded = F.pad(x_padded, (0, pad_c))
        dw, pw = F.pad(dw, (0, pad_c)), F.pad(pw, (0, 0, 0, pad_c))
    if f % 4:
        pw = F.pad(pw, (0, 4 - f % 4))
    x_padded, dw, pw = map(_aligned, (x_padded, dw, pw))
    out = torch.empty((b, h, w, f), dtype=x_padded.dtype,
                      device=x_padded.device)
    stats = z = None
    if f > _CLUSTER_F:
        rows = b * h * w
        stats = torch.empty(rows * -(-f // _WIDE_SLAB), dtype=f32,
                            device=out.device)
        if out.dtype != f32:
            z = torch.empty(rows * f, dtype=f32, device=out.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib()(x_padded.data_ptr(), dw.data_ptr(), pw.data_ptr(),
                 pw.shape[1], gamma.data_ptr(), beta.data_ptr(),
                 out.data_ptr(), ptr(z), ptr(stats), b, h, w,
                 x_padded.shape[-1], f, eps, _DTYPE_CODE[x_padded.dtype],
                 _build.stream_of(x_padded))
    _build.launches["dwconv_block"] += 1
    _build.check(err, "dwconv_block")
    return out


def dwconv_block(x_padded: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor,
                 gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float = EPS) -> torch.Tensor:
    """The fused block: the CUDA kernel on a CUDA tensor (x laid out
    contiguously, the filters in contiguous fp32), the plain twin on a
    CPU tensor."""
    if x_padded.device.type == "cpu":
        return dwconv_block_torch(x_padded, dw, pw, gamma, beta, eps)
    return dwconv_block_cuda(
        x_padded.contiguous(),
        *(t.to(torch.float32).contiguous() for t in (dw, pw, gamma, beta)),
        eps=eps)
