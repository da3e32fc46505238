"""Precision registry (port of :mod:`repro.kernels.quant`, registry only).

The quantized (int8/fp8) datapaths are not ported yet (ROADMAP queue 1,
item 10); this module carries the precision names, their canonical
resolution and the modeled storage width that the receiver builders and
the energy model read.
"""
from __future__ import annotations

from typing import Optional

PRECISIONS = ("fp32", "fp16", "bf16", "int8", "fp8")
QUANTIZED = ("int8", "fp8")

_ALIASES = {
    "float32": "fp32", "float16": "fp16", "bfloat16": "bf16",
    "fp8e4m3": "fp8", "e4m3": "fp8", "float8_e4m3fn": "fp8",
    None: "fp32", "none": "fp32",
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


def itemsize(precision: Optional[str]) -> int:
    """Modeled storage bytes per element (fp8 counts 1)."""
    return _ITEMSIZE[resolve_precision(precision)]


def require_unquantized(precision: Optional[str]) -> str:
    """Resolve ``precision`` and refuse the quantized policies, whose
    int8 LLR grid and saturating decoder are not ported yet."""
    p = resolve_precision(precision)
    if p in QUANTIZED:
        raise NotImplementedError(
            f"precision={p!r}: the quantized LLR/decoder paths are not "
            "ported yet (ROADMAP queue 1, item 10: quantized paths end to "
            "end)"
        )
    return p
