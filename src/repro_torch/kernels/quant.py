"""Quantization core of the low-precision (int8/fp8) paths (port of
:mod:`repro.kernels.quant`).

* **Precision names**: ``fp32 | fp16 | bf16 | int8 | fp8``; ``fp8`` is
  e4m3 (``torch.float8_e4m3fn``, finite-only, max normal 448).
* **Scales**: symmetric, absmax-based, fp32, per axis, kept outside the
  quantized tensor, so dequantization is one multiply.
* **LLR grid**: demapper LLRs quantize onto one fixed symmetric int8 grid
  (clip at :data:`LLR_CLIP`) for both int8 and fp8, since LLR state is
  integer in silicon either way; layered min-sum is scale-equivariant, so
  the int8 decoder's state dequantizes with the same scalar.

Every division here is a true float32 division by a tensor on the
operand's device: PyTorch's CUDA division by a Python scalar multiplies by
the reciprocal instead, which would round differently from the CPU and
from the int8 decoder kernel's entry quantization.
"""
from __future__ import annotations

from typing import Optional

import torch

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0
INT8_MAX = 127.0

# demapper LLR saturation: max-log LLRs at the registered operating points
# live well inside +-20, and one fixed grid keeps the int8 step the same
# across slots
LLR_CLIP = 20.0

PRECISIONS = ("fp32", "fp16", "bf16", "int8", "fp8")
QUANTIZED = ("int8", "fp8")

_ALIASES = {
    "float32": "fp32", "float16": "fp16", "bfloat16": "bf16",
    "fp8e4m3": "fp8", "e4m3": "fp8", "float8_e4m3fn": "fp8",
    None: "fp32", "none": "fp32",
}

_STORAGE = {
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "int8": torch.int8,
    "fp8": FP8_DTYPE,
}

_ITEMSIZE = {"fp32": 4, "fp16": 2, "bf16": 2, "int8": 1, "fp8": 1}


def resolve_precision(precision: Optional[str]) -> str:
    """Canonical precision name; None -> fp32."""
    p = precision.lower() if isinstance(precision, str) else precision
    p = _ALIASES.get(p, p)
    if p not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; have {PRECISIONS}"
        )
    return p


def is_quantized(precision: Optional[str]) -> bool:
    return resolve_precision(precision) in QUANTIZED


def storage_dtype(precision: Optional[str]) -> torch.dtype:
    """The dtype quantized values are stored in."""
    return _STORAGE[resolve_precision(precision)]


def itemsize(precision: Optional[str]) -> int:
    """Modeled storage bytes per element (fp8 counts 1)."""
    return _ITEMSIZE[resolve_precision(precision)]


def dtype_name(dtype: torch.dtype) -> str:
    """Canonical dtype label (``int8`` and ``float8_e4m3fn`` never share
    one, though both are 1 byte)."""
    return str(dtype).removeprefix("torch.")


def precision_of_dtype(dtype: torch.dtype) -> str:
    """Map a dtype back onto a precision name (any float8 -> fp8)."""
    name = dtype_name(dtype)
    if name.startswith("float8"):
        return "fp8"
    return resolve_precision(name)


def true_div(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as a true float32 division on every device (``d`` a
    Python number or a tensor)."""
    if not isinstance(d, torch.Tensor):
        d = x.new_full((), d)
    return x / d


# ---------------------------------------------------------------------------
# tensor quantization (symmetric absmax, external fp32 scales)
# ---------------------------------------------------------------------------

def _absmax(x: torch.Tensor, axis) -> torch.Tensor:
    dims = tuple(range(x.ndim)) if axis is None else axis
    ax = torch.amax(torch.abs(x.to(torch.float32)), dim=dims, keepdim=True)
    return torch.clamp(ax, min=1e-12)  # all-zero slices: scale stays finite


def quantize(x: torch.Tensor, precision: str, axis=None):
    """-> (q, scale) with ``dequantize(q, scale) ~= x``.  ``axis`` is
    reduced for the absmax (keepdim), so the scale broadcasts back against
    ``x``; ``axis=None`` gives one scale for the whole tensor."""
    p = resolve_precision(precision)
    if p not in QUANTIZED:
        raise ValueError(f"quantize() is for int8/fp8, got {p!r}")
    amax = _absmax(x, axis)
    xf = x.to(torch.float32)
    if p == "int8":
        scale = true_div(amax, INT8_MAX)
        q = torch.clamp(torch.round(true_div(xf, scale)), -INT8_MAX,
                        INT8_MAX).to(torch.int8)
    else:  # e4m3: the slice absmax lands on the format max
        scale = true_div(amax, FP8_MAX)
        q = true_div(xf, scale).to(FP8_DTYPE)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, precision: Optional[str],
               axis=None) -> torch.Tensor:
    """Round-trip ``x`` through the precision's storage grid (same dtype
    out).  fp32 passes through; fp16/bf16 cast through the half dtype."""
    p = resolve_precision(precision)
    if p == "fp32":
        return x
    if p in ("fp16", "bf16"):
        return x.to(_STORAGE[p]).to(x.dtype)
    q, scale = quantize(x, p, axis=axis)
    return dequantize(q, scale).to(x.dtype)


# ---------------------------------------------------------------------------
# LLR quantization (one fixed symmetric grid)
# ---------------------------------------------------------------------------

def llr_scale(clip: float = LLR_CLIP) -> float:
    """LLR units per int8 code (a Python float: kernels take it as a
    constant)."""
    return clip / INT8_MAX


def quantize_llr(llr: torch.Tensor, clip: float = LLR_CLIP):
    """-> (q int8, scale as a 0-d float32 tensor on ``llr``'s device);
    saturates at +-clip.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    s = llr_scale(clip)
    llr = llr.to(torch.float32)
    q = torch.clamp(torch.round(true_div(llr, s)), -INT8_MAX,
                    INT8_MAX).to(torch.int8)
    return q, llr.new_full((), s)


def dequantize_llr(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def fake_quant_llr(llr: torch.Tensor, precision: Optional[str],
                   clip: float = LLR_CLIP) -> torch.Tensor:
    """LLRs round-tripped through the precision's grid (the int8 grid for
    both int8 and fp8)."""
    p = resolve_precision(precision)
    if p == "fp32":
        return llr
    if p in ("fp16", "bf16"):
        return llr.to(_STORAGE[p]).to(llr.dtype)
    q, s = quantize_llr(llr, clip)
    return dequantize_llr(q, s).to(llr.dtype)


# ---------------------------------------------------------------------------
# saturating integer arithmetic (int8 LLR state kept in int32 lanes)
# ---------------------------------------------------------------------------

def sat8(x: torch.Tensor) -> torch.Tensor:
    """Saturate integer values onto the symmetric int8 range [-127, 127]."""
    return torch.clamp(x, -127, 127)


def q8_factor(factor: float) -> int:
    """The 8-bit fixed-point code of a [0, 1) factor: round(f * 256)
    (Python's round, half to even)."""
    return int(round(factor * 256.0))


def scale_q8(mag: torch.Tensor, factor: float) -> torch.Tensor:
    """Integer multiply by a [0, 1) factor: ``(mag * round(f*256)) >> 8``,
    the fixed-point damping of a hardware min-sum datapath."""
    return (mag * q8_factor(factor)) >> 8
