"""TE GEMM with a fused epilogue (port of :mod:`repro.kernels.te_gemm`,
the paper's RedMulE tensor engine): ``epi(x @ w + bias)`` with an fp32
accumulator, stored in ``x``'s dtype.  Epilogues: none, relu, silu and a
row softmax over the whole output row.

:func:`te_gemm` runs the plain PyTorch twin (:func:`te_gemm_torch`, the
reference oracle's arithmetic) only because the tensor it was given lies
on the CPU; on a CUDA tensor it launches ``csrc/te_gemm.cu`` (persistent
wgmma blocks over a TMA / cp.async ring, fp32 as 3xTF32, edges masked so
every shape works with no padding) or raises.  Its launch shape (column
slab, persistent blocks an SM) is :func:`pick_block_shape`'s: a winner
of :mod:`repro_torch.kernels.tune`, else the static heuristic.  A softmax
row wider than the slab (with the heuristic, wider than
:data:`SOFTMAX_TILE_N`) takes two passes (per-tile logits and (max, sum)
pairs, then a normalising pass), so any N works.  Under grad it runs in
:class:`TeGemmFunction`, whose backward (every epilogue) is torch ops:
the reference's has no backward kernel either.

The quantized GEMM (``te_gemm_quant`` of the reference) splits as the
reference's does: :func:`quantize_gemm_operands` (torch ops on the
operands' device: per-row int8 / e4m3 codes of x, per-column of w, fp32
scales), then :func:`te_gemm_quantized` on the codes, which launches
``csrc/te_gemm_quant.cu`` on a CUDA tensor (int8 products summed exactly
in int32 by wgmma, e4m3 widened to bf16; a softmax row wider
than :data:`QUANT_SOFTMAX_MAX_N` runs it with no epilogue into fp32 logits,
then ``te_gemm.cu``'s normalising pass) and runs
:func:`te_gemm_quantized_torch` on a CPU one.  :func:`te_gemm_quant` is
the two in a row; :func:`te_gemm_quant_torch` is the twin of the
reference's ``te_gemm_quant_jnp``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.machine import H100_SXM
from repro_torch.kernels import _build, quant, tune

EPILOGUES = ("none", "relu", "silu", "softmax")
SOFTMAX_TILE_N = 64  # the widest softmax row te_gemm.cu ends in one pass
QUANT_SOFTMAX_MAX_N = 256  # the widest one te_gemm_quant.cu's block holds
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_QTYPE_CODE = {torch.int8: 0, quant.FP8_DTYPE: 1}
_EPILOGUE_CODE = {e: i for i, e in enumerate(EPILOGUES)}

# ---------------------------------------------------------------------------
# launch choices: te_gemm.cu's (column slab bn, persistent blocks an SM),
# te_gemm_quant.cu's (column slab bn,)
# ---------------------------------------------------------------------------

SLABS = (8, 16, 32, 64)  # te_gemm.cu's column slab instances (BN)
PER_SM_CAPS = (1, 2, 3, 4)  # blocks an SM its persistent grid may take
QUANT_SLABS = (32, 64, 128, 256)  # te_gemm_quant.cu's BN instances
_BM = 64  # rows of a tile (one wgmma's M)
_MIN_TILES = 64  # the heuristic narrows the slab below this many tiles
_W_BUDGET = 160 * 1024  # bytes of W te_gemm.cu holds at once
_RING_BYTES = 1024 + 4 * _BM * 128  # alignment pad + the X ring's stages
_ELEMENT = {torch.float32: 4, torch.bfloat16: 2}


def _w_slabs(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.float32 else 1  # fp32: W's hi and lo slabs


def _k_held(bn: int, dtype: torch.dtype) -> int:
    """K of a ``bn``-column W slab te_gemm.cu holds at once."""
    ka = 128 // _ELEMENT[dtype]
    return _W_BUDGET // (_w_slabs(dtype) * bn * 128) * ka


def _smem(bn: int, k: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of a te_gemm.cu launch at slab ``bn``."""
    ka = 128 // _ELEMENT[dtype]
    kpad = -(-k // ka) * ka
    return _RING_BYTES + (_w_slabs(dtype) * min(kpad, _k_held(bn, dtype))
                          // ka * bn * 128)


def _slab_heuristic(m: int, n: int, k: int, dtype: torch.dtype,
                    epilogue: str) -> tuple:
    """te_gemm.cu's launch shape before it took one: a slab as wide as N
    needs (up to 64), narrowed (unless it holds a whole softmax row) while
    the grid has under 64 tiles or W's whole K does not fit; then as many
    blocks an SM as its shared memory holds, 1 to 4."""
    bn = 8
    while bn < n and bn < SLABS[-1]:
        bn *= 2
    if epilogue != "softmax" or n > bn:
        rows = -(-m // _BM)
        ka = 128 // _ELEMENT[dtype]
        kpad = -(-k // ka) * ka
        while bn > SLABS[0] and (rows * -(-n // bn) < _MIN_TILES
                                 or kpad > _k_held(bn, dtype)):
            bn //= 2
    per_sm = H100_SXM.fast_mem_bytes // (_smem(bn, k, dtype) + 2048)
    return bn, min(max(per_sm, 1), PER_SM_CAPS[-1])


def _quant_heuristic(n: int, epilogue: str) -> tuple:
    """te_gemm_quant.cu's slab before it took one: the whole row for the
    softmax, else 32 or 64 columns (more blocks at small M)."""
    width = n if epilogue == "softmax" else (32 if n <= 32 else 64)
    return (next(b for b in QUANT_SLABS if b >= min(width, 256)),)


def _valid(choice: tuple, n: int, dtype: torch.dtype, epilogue: str) -> bool:
    """Whether the kernel of ``dtype`` has an instance for ``choice``."""
    if dtype in _QTYPE_CODE:
        return (len(choice) == 1 and choice[0] in QUANT_SLABS
                and (epilogue != "softmax" or choice[0] >= n))
    return (len(choice) == 2 and choice[0] in SLABS
            and choice[1] in PER_SM_CAPS)


def pick_block_shape(m: int, n: int, k: int, dtype=torch.float32,
                     epilogue: str = "none") -> tuple:
    """The launch shape of (m, k) @ (k, n) in ``dtype`` (float32 /
    bfloat16: ``te_gemm.cu``'s (bn, per_sm); int8 / float8_e4m3fn codes:
    ``te_gemm_quant.cu``'s (bn,)).

    A winner persisted by :mod:`repro_torch.kernels.tune` for this shape
    and dtype on ``cuda`` takes precedence (latency objective first, then
    energy) when the kernel has an instance for it; otherwise the static
    heuristic the kernels applied before they took the choice as an
    argument.  Memoized per (m, n, k, dtype, epilogue)
    (:func:`~repro_torch.kernels.tune.picked`).
    """
    return tune.picked(("te_gemm", m, n, k, dtype, epilogue),
                       lambda: _pick(m, n, k, dtype, epilogue))


def _pick(m, n, k, dtype, epilogue) -> tuple:
    if dtype in _QTYPE_CODE:
        heuristic = lambda: _quant_heuristic(n, epilogue)
    elif dtype in _DTYPE_CODE:
        heuristic = lambda: _slab_heuristic(m, n, k, dtype, epilogue)
    else:
        raise TypeError(f"te_gemm has no kernel for {dtype}")
    return tune.resolve("te_gemm", (m, n, k), quant.dtype_name(dtype),
                        lambda c: _valid(c, n, dtype, epilogue), heuristic,
                        objectives=("latency", "energy"))


def block_shape_candidates(m: int, n: int, k: int, dtype) -> list:
    """The tuner's candidates at (m, n, k) with no epilogue: ``te_gemm``'s
    slabs up to the row's width whose K fits the W budget (the narrowest
    always), times 1, 2 and 4 blocks an SM (and the heuristic's count);
    every slab ``te_gemm_quant`` compiles."""
    if dtype in _QTYPE_CODE:
        return [(b,) for b in QUANT_SLABS]
    ka = 128 // _ELEMENT[dtype]
    kpad = -(-k // ka) * ka
    bns = [b for b in SLABS if (b == SLABS[0] or b // 2 < n)
           and (b == SLABS[0] or kpad <= _k_held(b, dtype))]
    caps = sorted({1, 2, 4, _slab_heuristic(m, n, k, dtype, "none")[1]})
    return [(b, c) for b in bns for c in caps]


def _check_choice(choice: tuple, n: int, dtype, epilogue: str) -> None:
    """Refuse an explicit choice on the CPU as the kernel refuses it on
    the card."""
    choice = tuple(int(c) for c in choice)
    if not _valid(choice, n, dtype, epilogue):
        raise ValueError(f"te_gemm: no kernel instance for launch choice "
                         f"{choice} ({dtype}, N = {n}, {epilogue})")


def _epilogue(z: torch.Tensor, bias: Optional[torch.Tensor],
              epilogue: str) -> torch.Tensor:
    """fp32 ``z`` + bias, then the activation, as the reference's kernels
    apply them."""
    if bias is not None:
        z = z + bias.to(torch.float32)
    if epilogue == "relu":
        z = torch.clamp_min(z, 0.0)
    elif epilogue == "silu":
        z = z * torch.sigmoid(z)
    elif epilogue == "softmax":
        z = torch.softmax(z, dim=-1)
    return z


def te_gemm_torch(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  epilogue: str = "none") -> torch.Tensor:
    """Plain twin: fp32 product, + bias, epilogue, cast to x's dtype."""
    z = x.to(torch.float32) @ w.to(torch.float32)
    return _epilogue(z, bias, epilogue).to(x.dtype)


def _lib():
    fn = _build.library("te_gemm").te_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _softmax_lib():
    fn = _build.library("te_gemm").te_gemm_row_softmax_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def te_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 epilogue: str = "none",
                 choice: Optional[tuple] = None) -> torch.Tensor:
    """Launch ``csrc/te_gemm.cu``: persistent blocks, one column slab of W
    each, walking 64-row tiles; the bias in fp32.  ``choice`` is the
    launch shape (bn, per_sm), by default :func:`pick_block_shape`'s; the
    kernel refuses one it has no instance for.  A softmax row wider than
    the slab gets per-(row, tile) (max, sum) pairs and, for a bf16 output,
    fp32 logits as scratch, and a second kernel."""
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
    args = dict(x=(x, x.dtype), w=(w, x.dtype))
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"te_gemm: bias {tuple(bias.shape)} != ({n},)")
        args["bias"] = (bias, torch.float32)
    _build.require_cuda("te_gemm", **args)
    choice = (pick_block_shape(m, n, k, x.dtype, epilogue) if choice is None
              else tune.as_choice(choice, 2, "te_gemm", "(bn, per_sm)"))
    bn, per_sm = choice
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    logits = stats = None
    if epilogue == "softmax" and n > bn:
        stats = torch.empty(2 * m * ((n + 7) // 8), dtype=torch.float32,
                            device=x.device)
        if x.dtype != torch.float32:
            logits = torch.empty((m, n), dtype=torch.float32,
                                 device=x.device)
    err = _lib()(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if logits is None else logits.data_ptr(),
                 None if stats is None else stats.data_ptr(),
                 m, n, k, _EPILOGUE_CODE[epilogue], _DTYPE_CODE[x.dtype],
                 bn, per_sm, _build.stream_of(x))
    _build.launches["te_gemm"] += 1
    _build.launch_choices["te_gemm"] = choice
    _build.check(err, "te_gemm")
    return out


def _te_gemm_forward(x, w, bias, epilogue, choice):
    if x.device.type == "cpu":
        if choice is not None:
            _check_choice(choice, w.shape[-1], x.dtype, epilogue)
        return te_gemm_torch(x, w, bias, epilogue=epilogue)
    return te_gemm_cuda(
        x.contiguous(), w.contiguous(),
        None if bias is None else bias.to(torch.float32).contiguous(),
        epilogue=epilogue, choice=choice)


class TeGemmFunction(torch.autograd.Function):
    """:func:`te_gemm` with a gradient: the forward is the wrapper's own
    route (the kernel on a CUDA tensor, the twin on a CPU one), the
    backward plain torch ops in fp32 on either device, as the reference
    trains through XLA autodiff of its jnp path.  Each gradient is cast
    to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w, bias, epilogue, choice=None):
        out = _te_gemm_forward(x, w, bias, epilogue, choice)
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, w, bias, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, bias, out = ctx.saved_tensors
        x32, w32 = x.to(torch.float32), w.to(torch.float32)
        g = g.to(torch.float32)
        epi = ctx.epilogue

        def z():  # the fp32 pre-activation, recomputed
            return _epilogue(x32 @ w32, bias, "none")

        if epi == "relu":
            dz = g * (out > 0)
        elif epi == "silu":
            zz = z()
            s = torch.sigmoid(zz)
            dz = g * (s * (1.0 + zz * (1.0 - s)))
        elif epi == "softmax":  # an output rounded below fp32 is recomputed
            p = out if out.dtype == torch.float32 else torch.softmax(z(), -1)
            dz = p * (g - torch.sum(g * p, dim=-1, keepdim=True))
        else:
            dz = g
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        return ((dz @ w32.T).to(x.dtype) if need_x else None,
                (x32.T @ dz).to(w.dtype) if need_w else None,
                torch.sum(dz, dim=0).to(bias.dtype) if need_b else None,
                None, None)


def te_gemm(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None, *,
            epilogue: str = "none",
            choice: Optional[tuple] = None) -> torch.Tensor:
    """``epi(x @ w + bias)``, x (M, K), w (K, N), bias (N,) or None: the
    CUDA kernel on a CUDA tensor (operands laid out contiguously first,
    the bias in fp32, launched at ``choice`` = (bn, per_sm), by default
    :func:`pick_block_shape`'s), the plain twin on a CPU tensor (an
    explicit ``choice`` is still checked).  With grad mode on and an
    operand that requires grad, the same route runs inside
    :class:`TeGemmFunction`, whose backward is plain torch."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; have {EPILOGUES}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        return TeGemmFunction.apply(x, w, bias, epilogue, choice)
    return _te_gemm_forward(x, w, bias, epilogue, choice)


# ---------------------------------------------------------------------------
# quantized path (int8 / e4m3 codes, exact int32 or fp32 accumulate,
# dequant epilogue)
# ---------------------------------------------------------------------------

def quantize_gemm_operands(x: torch.Tensor, w: torch.Tensor,
                           precision: str):
    """-> (xq, wq, xs (M, 1), ws (1, N)): per-row codes of x and
    per-column codes of w with their fp32 scales, so each output element
    sees one (xs, ws) pair and the dequantization is exact with respect
    to the grid."""
    xq, xs = quant.quantize(x, precision, axis=1)
    wq, ws = quant.quantize(w, precision, axis=0)
    return xq, wq, xs, ws


def te_gemm_quantized_torch(xq: torch.Tensor, wq: torch.Tensor,
                            xs: torch.Tensor, ws: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *,
                            epilogue: str = "none",
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain twin on the codes: the exact integer product for int8 (in
    float64, where every partial sum of 8-bit products is an exact
    integer, so its rounding to fp32 is the int32 accumulator's), the fp32
    product of the e4m3 values otherwise; then ``acc * xs * ws``, + bias
    and the activation in fp32, cast to ``out_dtype``."""
    if xq.dtype == torch.int8:
        acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(
            torch.float32)
    else:
        acc = xq.to(torch.float32) @ wq.to(torch.float32)
    return _epilogue(acc * xs * ws, bias, epilogue).to(out_dtype)


def _quant_lib():
    fn = _build.library("te_gemm_quant").te_gemm_quant_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def te_gemm_quantized_cuda(xq: torch.Tensor, wq: torch.Tensor,
                           xs: torch.Tensor, ws: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, *,
                           epilogue: str = "none",
                           out_dtype: torch.dtype = torch.float32,
                           choice: Optional[tuple] = None
                           ) -> torch.Tensor:
    """Launch ``csrc/te_gemm_quant.cu``: persistent blocks walking 64-row
    tiles of a column slab (``choice`` = (bn,), by default
    :func:`pick_block_shape`'s; the kernel refuses one it has no instance
    for), wgmma on the codes (int8) or their bf16 values (e4m3); a
    softmax row wider than :data:`QUANT_SOFTMAX_MAX_N` ends in
    ``te_gemm.cu``'s normalising pass."""
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"te_gemm_quant: xq {tuple(xq.shape)} @ wq "
                         f"{tuple(wq.shape)} is not (M, K) @ (K, N)")
    m, k = xq.shape
    n = wq.shape[1]
    if min(m, n, k) == 0:
        raise ValueError(f"te_gemm_quant: empty operand ({m}, {k}) @ "
                         f"({k}, {n})")
    if xq.dtype not in _QTYPE_CODE:
        raise TypeError(f"te_gemm_quant kernel takes int8 or float8_e4m3fn "
                        f"codes, got {xq.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"te_gemm_quant kernel writes float32 or bfloat16, "
                        f"not {out_dtype}")
    if tuple(xs.shape) != (m, 1) or tuple(ws.shape) != (1, n):
        raise ValueError(f"te_gemm_quant: scales {tuple(xs.shape)}, "
                         f"{tuple(ws.shape)} are not ({m}, 1), (1, {n})")
    args = dict(xq=(xq, xq.dtype), wq=(wq, xq.dtype),
                xs=(xs, torch.float32), ws=(ws, torch.float32))
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"te_gemm_quant: bias {tuple(bias.shape)} != "
                             f"({n},)")
        args["bias"] = (bias, torch.float32)
    _build.require_cuda("te_gemm_quant", **args)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    # a row wider than one block: fp32 logits (+ bias), then the
    # normalising pass (in place for an fp32 output)
    wide = epilogue == "softmax" and n > QUANT_SOFTMAX_MAX_N
    epi = "none" if wide else epilogue
    choice = (pick_block_shape(m, n, k, xq.dtype, epi) if choice is None
              else tune.as_choice(choice, 1, "te_gemm_quant", "(bn,)"))
    logits = out if not wide or out_dtype == torch.float32 else \
        torch.empty((m, n), dtype=torch.float32, device=xq.device)
    err = _quant_lib()(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        None if bias is None else bias.data_ptr(), logits.data_ptr(), m, n,
        k, _EPILOGUE_CODE[epi], _QTYPE_CODE[xq.dtype],
        _DTYPE_CODE[torch.float32 if wide else out_dtype], choice[0],
        _build.stream_of(xq))
    if wide and err == 0:
        err = _softmax_lib()(logits.data_ptr(), out.data_ptr(), m, n,
                             _DTYPE_CODE[out_dtype], _build.stream_of(xq))
    _build.launches["te_gemm_quant"] += 1
    _build.launch_choices["te_gemm_quant"] = choice
    _build.check(err, "te_gemm_quant")
    return out


def te_gemm_quantized(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                      ws: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, epilogue: str = "none",
                      out_dtype: torch.dtype = torch.float32,
                      choice: Optional[tuple] = None) -> torch.Tensor:
    """The quantized GEMM on codes (the reference's ``pallas_call``
    operands): the CUDA kernel on a CUDA tensor (operands laid out
    contiguously, the bias in fp32, launched at ``choice`` = (bn,), by
    default :func:`pick_block_shape`'s), the plain twin on a CPU tensor
    (an explicit ``choice`` is still checked)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; have {EPILOGUES}")
    if xq.device.type == "cpu":
        if choice is not None:
            n = wq.shape[-1]
            wide = epilogue == "softmax" and n > QUANT_SOFTMAX_MAX_N
            _check_choice(choice, n, xq.dtype, "none" if wide else epilogue)
        return te_gemm_quantized_torch(xq, wq, xs, ws, bias,
                                       epilogue=epilogue,
                                       out_dtype=out_dtype)
    return te_gemm_quantized_cuda(
        xq.contiguous(), wq.contiguous(), xs.contiguous(), ws.contiguous(),
        None if bias is None else bias.to(torch.float32).contiguous(),
        epilogue=epilogue, out_dtype=out_dtype, choice=choice)


def te_gemm_quant(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, *,
                  precision: str = "int8", epilogue: str = "none",
                  out_dtype: Optional[torch.dtype] = None,
                  choice: Optional[tuple] = None) -> torch.Tensor:
    """``epi(x @ w + bias)`` over int8 / e4m3 operands: quantize (torch
    ops on x's device), then :func:`te_gemm_quantized` (at ``choice``).
    Output in ``out_dtype`` (default x's dtype)."""
    xq, wq, xs, ws = quantize_gemm_operands(x, w, precision)
    return te_gemm_quantized(xq, wq, xs, ws, bias, epilogue=epilogue,
                             out_dtype=out_dtype or x.dtype, choice=choice)


def te_gemm_quant_torch(x: torch.Tensor, w: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        precision: str = "int8", epilogue: str = "none",
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Plain twin of :func:`te_gemm_quant` (the reference's
    ``te_gemm_quant_jnp``) on any device."""
    xq, wq, xs, ws = quantize_gemm_operands(x, w, precision)
    return te_gemm_quantized_torch(xq, wq, xs, ws, bias, epilogue=epilogue,
                                   out_dtype=out_dtype or x.dtype)
