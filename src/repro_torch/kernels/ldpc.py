"""Batched layered normalized-min-sum LDPC decoder (port of
:mod:`repro.kernels.ldpc`): fp32, and the saturating int8 datapath.

Per layer of the quasi-cyclic code: variable-to-check messages ``t`` (the
posterior minus the layer's previous check message), min / second-min
magnitudes excluding self (the first argmin takes the second min), the
sign product, ``alpha`` damping, and the write-back through the inverse
circulant rolls.  Converged codewords freeze (per-codeword syndrome early
exit) and the per-codeword iteration count is an output.

:func:`ldpc_decode` runs the plain PyTorch twin (:func:`ldpc_decode_torch`,
the reference core's arithmetic) only because the tensor it was given lies
on the CPU; on a CUDA tensor it launches ``csrc/ldpc_minsum.cu`` (one block
per codeword, any code: past what one block's registers and shared memory
hold, the check messages go to a global workspace; the route and its
lanes a row are :func:`pick_segment`'s, a winner of
:mod:`repro_torch.kernels.tune` or the static heuristic) or raises.

``precision="int8"|"fp8"`` selects the integer datapath (the same for both
1-byte policies): channel LLRs quantized onto the int8 grid
(``round(v / llr_scale())``, half to even, clipped at +-127), int8 check
messages, a 12-bit posterior saturating at +-``_SAT_V``, the fixed-point
damping ``(mag * round(alpha*256)) >> 8``, and a dequantized posterior.
Its twin is :func:`_decode_core_q`; its kernels ``ldpc_minsum_q_kernel``
and ``ldpc_minsum_q_kernel_any`` in the same source, the fp32 kernels'
designs over the integer datapath.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build, quant, tune

DEFAULT_MAX_ITERS = 12
DEFAULT_ALPHA = 0.8  # normalized-min-sum damping


# ---------------------------------------------------------------------------
# plain twin (standard convention inside: v = log P(0)/P(1))
# ---------------------------------------------------------------------------

def _syndrome_ok(v: torch.Tensor, layers: tuple) -> torch.Tensor:
    """(n_b, z, B) -> (B,) bool: all parity checks hold for the codeword."""
    hard = (v < 0).to(torch.int32)
    bad = []
    for edges in layers:
        p = torch.roll(hard[edges[0][0]], -edges[0][1], dims=0)
        for c, s in edges[1:]:
            p = p ^ torch.roll(hard[c], -s, dims=0)
        bad.append(p)
    return torch.all(torch.all(torch.stack(bad) == 0, dim=0), dim=0)


def _layered_iteration(v: torch.Tensor, c2v: tuple, layers: tuple,
                       alpha: float):
    """One sweep over the layers (layers see each other's updates)."""
    v = v.clone()
    new_c2v = []
    for li, edges in enumerate(layers):
        t = torch.stack(
            [torch.roll(v[c], -s, dims=0) for c, s in edges]
        ) - c2v[li]  # (E, z, B)
        at = torch.abs(t)
        sg = torch.where(t < 0.0, -1.0, 1.0)
        m1 = torch.amin(at, dim=0, keepdim=True)
        amin = torch.argmin(at, dim=0)  # first index on ties
        is_min = (
            torch.arange(len(edges), device=v.device)[:, None, None]
            == amin[None]
        )
        m2 = torch.amin(torch.where(is_min, float("inf"), at), dim=0,
                        keepdim=True)
        mag = torch.where(is_min, m2, m1)
        par = torch.prod(sg, dim=0, keepdim=True)
        upd = alpha * par * sg * mag
        vn = t + upd
        for e, (c, s) in enumerate(edges):
            v[c] = torch.roll(vn[e], s, dims=0)
        new_c2v.append(upd)
    return v, tuple(new_c2v)


def _iterate(v0: torch.Tensor, layers: tuple, max_iters: int, sweep):
    """Iterate ``sweep(v, c2v)`` to convergence from ``v0`` (n_b, z, B);
    returns (posterior, iters (B,)).  A converged codeword's state and
    messages freeze (identical numerics to stopping it); the loop ends
    when all have converged."""
    c2v = tuple(
        torch.zeros((len(e),) + v0.shape[1:], dtype=v0.dtype,
                    device=v0.device)
        for e in layers
    )
    v = v0
    done = _syndrome_ok(v0, layers)
    iters = torch.zeros(v0.shape[-1], dtype=torch.int32, device=v0.device)
    it = 0
    while it < max_iters and not bool(torch.all(done)):
        vn, c2vn = sweep(v, c2v)
        keep = done[None, None, :]
        v = torch.where(keep, v, vn)
        c2v = tuple(torch.where(keep, a, b) for a, b in zip(c2v, c2vn))
        iters = iters + torch.where(done, 0, 1).to(torch.int32)
        done = torch.logical_or(done, _syndrome_ok(v, layers))
        it += 1
    return v, iters


def _decode_core(v0: torch.Tensor, layers: tuple, max_iters: int,
                 alpha: float):
    """fp32 decode: v0 (n_b, z, B) -> (posterior, iters (B,))."""
    return _iterate(v0, layers, max_iters,
                    lambda v, c2v: _layered_iteration(v, c2v, layers, alpha))


# ---------------------------------------------------------------------------
# plain twin of the int8 datapath
# ---------------------------------------------------------------------------

_INT_INF = 32767  # second-min sentinel
# posterior saturation: check messages stay on the int8 grid, the variable
# state gets 12 bits (an int8 accumulator saturates on the first extrinsic
# add at the registered operating points)
_SAT_V = 2047


def _layered_iteration_q(v: torch.Tensor, c2v: tuple, layers: tuple,
                         alpha: float):
    """One layered sweep in saturating integer arithmetic (int32 lanes):
    exact min / second-min / sign product, the damping
    ``scale_q8(mag, alpha)`` applied to the magnitude before the sign,
    int8-saturated messages and a posterior clipped at +-``_SAT_V``."""
    v = v.clone()
    new_c2v = []
    for li, edges in enumerate(layers):
        t = torch.stack(
            [torch.roll(v[c], -s, dims=0) for c, s in edges]
        ) - c2v[li]  # (E, z, B): |t| <= _SAT_V + 127
        at = torch.abs(t)
        sg = torch.where(t < 0, -1, 1).to(torch.int32)
        m1 = torch.amin(at, dim=0, keepdim=True)
        amin = torch.argmin(at, dim=0)  # first index on ties
        is_min = (
            torch.arange(len(edges), device=v.device)[:, None, None]
            == amin[None]
        )
        m2 = torch.amin(torch.where(is_min, _INT_INF, at), dim=0,
                        keepdim=True)
        mag = torch.where(is_min, m2, m1)
        par = torch.prod(sg, dim=0, keepdim=True, dtype=torch.int32)
        upd = quant.sat8(par * sg * quant.scale_q8(mag, alpha))
        vn = torch.clamp(t + upd, -_SAT_V, _SAT_V)
        for e, (c, s) in enumerate(edges):
            v[c] = torch.roll(vn[e], s, dims=0)
        new_c2v.append(upd)
    return v, tuple(new_c2v)


def _decode_core_q(v0: torch.Tensor, layers: tuple, max_iters: int,
                   alpha: float, step: float):
    """Int8 twin of :func:`_decode_core`: quantize the fp32 channel lanes
    onto the int8 grid (``step`` LLR units per code; a true float32
    division, half to even), iterate in saturating integers, dequantize
    the posterior."""
    vq0 = torch.clamp(
        torch.round(quant.true_div(v0.to(torch.float32), step)), -127, 127
    ).to(torch.int32)
    vq, iters = _iterate(
        vq0, layers, max_iters,
        lambda v, c2v: _layered_iteration_q(v, c2v, layers, alpha))
    return vq.to(torch.float32) * step, iters


def _core_for(precision: Optional[str]):
    """The decode core of a precision policy: fp32 lanes in and out either
    way; int8 and fp8 select the saturating integer state."""
    if not quant.is_quantized(precision):
        return _decode_core
    return functools.partial(_decode_core_q, step=quant.llr_scale())


def _to_lanes(llr: torch.Tensor, n_b: int, z: int) -> torch.Tensor:
    """(B, n_b*z) log P(1)/P(0) LLRs -> (n_b, z, B) internal state."""
    b = llr.shape[0]
    return -torch.movedim(llr.reshape(b, n_b, z).to(torch.float32), 0, -1)


def _from_lanes(v: torch.Tensor) -> torch.Tensor:
    """(n_b, z, B) internal posterior -> (B, n_b*z) repo convention."""
    n_b, z, b = v.shape
    return -torch.movedim(v, -1, 0).reshape(b, n_b * z)


def ldpc_decode_torch(llr: torch.Tensor, code, *,
                      max_iters: int = DEFAULT_MAX_ITERS,
                      alpha: float = DEFAULT_ALPHA,
                      precision: Optional[str] = None):
    """llr (B, n_mother) -> (posterior LLRs (B, n_mother), iters (B,))."""
    v, iters = _core_for(precision)(
        _to_lanes(llr, code.n_b, code.z), code.layers(), max_iters, alpha
    )
    return _from_lanes(v), iters


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _schedule(code, device: torch.device):
    """The layer schedule as CSR int32 tensors on ``device``: layer
    offsets, edge block columns, edge circulant shifts (reduced mod z, as
    the kernels take them)."""
    layers = code.layers()
    off = [0]
    for edges in layers:
        off.append(off[-1] + len(edges))
    cols = [c for edges in layers for c, _ in edges]
    shifts = [s % code.z for edges in layers for _, s in edges]
    as_t = lambda xs: torch.tensor(xs, dtype=torch.int32, device=device)
    return as_t(off), as_t(cols), as_t(shifts), max(map(len, layers))


# launch choice: ldpc_minsum.cu's lanes a lifted row (seg,); 0 is the row
# kernels
SEGMENTS = (4, 8, 16)
ROW_KERNEL = 0
_SEG_LAYERS = 16  # the segment kernels' codes: at most this many layers
_BLOCK_THREADS = 1024


def _code_shape(code) -> tuple:
    """(layers, widest layer, z) of ``code``."""
    return code.m_b, max(map(len, code.layers())), code.z


def _valid_seg(choice: tuple, n_layers: int, max_deg: int, z: int) -> bool:
    if len(choice) != 1:
        return False
    seg = choice[0]
    return seg == ROW_KERNEL or (seg in SEGMENTS and seg >= max_deg
                                 and n_layers <= _SEG_LAYERS
                                 and z * seg <= _BLOCK_THREADS)


def _seg_heuristic(n_layers: int, max_deg: int, z: int) -> tuple:
    """ldpc_minsum.cu's route before it took one: the widest layer to a
    power of two (at least 4) where z rows of it fit a block, else the row
    kernels."""
    seg = next((s for s in SEGMENTS if s >= max_deg), SEGMENTS[-1])
    ok = _valid_seg((seg,), n_layers, max_deg, z)
    return (seg if ok else ROW_KERNEL,)


def pick_segment(code, max_iters: int = DEFAULT_MAX_ITERS,
                 max_deg: Optional[int] = None) -> tuple:
    """The LDPC decoders' lanes a lifted row (seg,) for ``code`` (0: the
    row kernels): the ``cuda`` winner of :mod:`repro_torch.kernels.tune`
    for ("ldpc_decode", (k_b, m_b, z, max_iters)) when the segment
    kernels take it at this code, else the static heuristic.  Both
    datapaths read it, as the reference's share the key.  ``max_deg``,
    the widest layer, is computed when not given.  Memoized
    (:func:`~repro_torch.kernels.tune.picked`)."""
    n_layers, z = code.m_b, code.z
    if max_deg is None:
        max_deg = _code_shape(code)[1]
    return tune.picked(
        ("ldpc_decode", code.k_b, n_layers, z, max_iters, max_deg),
        lambda: tune.resolve(
            "ldpc_decode", (code.k_b, code.m_b, z, max_iters), "",
            lambda c: _valid_seg(c, n_layers, max_deg, z),
            lambda: _seg_heuristic(n_layers, max_deg, z)))


def segment_candidates(code) -> list:
    """The tuner's candidates: every segment width the code fits, and the
    row kernels."""
    n_layers, max_deg, z = _code_shape(code)
    return [(s,) for s in SEGMENTS
            if _valid_seg((s,), n_layers, max_deg, z)] + [(ROW_KERNEL,)]


def _ldpc_lib(quantized: bool):
    lib = _build.library("ldpc_minsum")
    if quantized:
        fn = lib.ldpc_minsum_q_launch
        scalars = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int]
    else:
        fn = lib.ldpc_minsum_launch
        scalars = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int]
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + scalars + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ldpc_decode_cuda(llr: torch.Tensor, code, *,
                     max_iters: int = DEFAULT_MAX_ITERS,
                     alpha: float = DEFAULT_ALPHA,
                     precision: Optional[str] = None,
                     choice: Optional[tuple] = None):
    """Launch ``csrc/ldpc_minsum.cu``, one block per codeword, for fp32 or
    the int8 datapath (``precision="int8"|"fp8"``): the segment kernel at
    ``choice`` = (seg,) lanes a row, or the row kernel at (0,), whose
    check messages (and a posterior past the device's shared memory) go
    to the workspace allocated here; by default :func:`pick_segment`'s
    (the kernel refuses a seg the code does not fit)."""
    quantized = quant.is_quantized(precision)
    if llr.ndim != 2 or llr.shape[1] != code.n_mother:
        raise ValueError(f"llr {tuple(llr.shape)} is not (B, {code.n_mother})")
    _build.require_cuda("ldpc_minsum", llr=(llr, torch.float32))
    off, cols, shifts, max_deg = _schedule(code, llr.device)
    choice = (pick_segment(code, max_iters, max_deg) if choice is None
              else tune.as_choice(choice, 1, "ldpc_decode", "(seg,)"))
    n_edges = int(cols.numel())
    n_cw = llr.shape[0]
    ws = torch.empty(n_cw * (n_edges + code.n_b) * code.z, device=llr.device,
                     dtype=torch.int32 if quantized else torch.float32)
    post = torch.empty_like(llr)
    iters = torch.empty(n_cw, dtype=torch.int32, device=llr.device)
    if quantized:
        scalars = (int(max_iters), quant.q8_factor(alpha),
                   float(quant.llr_scale()))
    else:
        scalars = (int(max_iters), float(alpha))
    err = _ldpc_lib(quantized)(
        llr.data_ptr(), post.data_ptr(), iters.data_ptr(), off.data_ptr(),
        cols.data_ptr(), shifts.data_ptr(), ws.data_ptr(),
        n_cw, code.n_b, code.z, code.m_b, n_edges, max_deg, *scalars,
        choice[0], _build.stream_of(llr),
    )
    counter = "ldpc_decode_q" if quantized else "ldpc_decode"
    _build.launches[counter] += 1
    _build.launch_choices[counter] = choice
    _build.check(err, "ldpc_minsum")
    return post, iters


def ldpc_decode(llr: torch.Tensor, code, *,
                max_iters: int = DEFAULT_MAX_ITERS,
                alpha: float = DEFAULT_ALPHA,
                precision: Optional[str] = None,
                choice: Optional[tuple] = None):
    """Layered normalized-min-sum decode of ``llr`` (B, n_mother) in the
    log P(1)/P(0) convention (zero = punctured).  Returns (posterior LLRs,
    per-codeword iteration counts); hard decisions are ``posterior > 0``.
    ``precision="int8"|"fp8"`` runs the saturating integer datapath.
    The CUDA kernel on a CUDA tensor (at ``choice`` = (seg,), by default
    :func:`pick_segment`'s), the plain twin on a CPU tensor (an explicit
    ``choice`` is still checked)."""
    precision = quant.resolve_precision(precision)
    if llr.device.type == "cpu":
        if choice is not None and not _valid_seg(tuple(choice),
                                                 *_code_shape(code)):
            raise ValueError(f"ldpc_decode: no kernel instance for launch "
                             f"choice {tuple(choice)}")
        return ldpc_decode_torch(llr, code, max_iters=max_iters,
                                 alpha=alpha, precision=precision)
    return ldpc_decode_cuda(llr.contiguous(), code, max_iters=max_iters,
                            alpha=alpha, precision=precision, choice=choice)
