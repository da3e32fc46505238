"""Fused classical-receiver kernels (port of :mod:`repro.kernels.rx_fused`).

* ``ls_che``: DMRS comb extract -> pilot-symbol average -> per-pilot
  divide and frequency interpolation, folded into one complex GEMM against
  the static operator of :func:`make_ls_interp_operator`.  On a CUDA
  tensor: ``csrc/ls_che.cu``.
* ``mmse_detect_demap``: the regularized Gram and an unpivoted Gauss
  solve of the augmented system [H^H y | G], unbiasing and max-log LLRs,
  with no Gram / equalized-symbol grid in memory.  On a CUDA tensor:
  ``detect_demap_kernel`` of ``csrc/detect_demap.cu``, which factors each
  subcarrier's system once and applies it to every symbol; any
  ``(n_rx, n_tx)`` (a shape with no compiled instance runs with runtime
  sizes).
* ``sic_detect_demap``: successive interference cancellation, the MU-MIMO
  near-far receiver.  Stage ``k`` runs the same solve over the streams
  ``k..n_tx-1`` not cancelled yet, keeps stream ``k``'s estimate and LLRs,
  hard-remodulates it and subtracts its contribution from the residual.
  On a CUDA tensor: ``sic_demap_kernel`` of the same source, which
  factors each stage's system once per subcarrier and runs the stage
  chain per RE.

Each wrapper runs its plain PyTorch twin (``*_torch``, the same arithmetic
in the same order) only because the tensor it was given lies on the CPU;
on a CUDA tensor it launches the hand-written kernel or raises, at the
launch choice of its picker (:func:`pick_subcarrier_tile`,
:func:`pick_threads_per_output`: a winner of
:mod:`repro_torch.kernels.tune`, else the static heuristic).
``precision="int8"|"fp8"`` rounds the LLRs onto the fixed int8 grid of
:mod:`repro_torch.kernels.quant` after the kernel, as the reference does.

``noise_var`` is one value, or one per lane of a multi-cell step
(:func:`noise_var_rows`): the batch's B rows are L contiguous lane blocks
of B / L rows, and row ``b`` reads value ``b // (B // L)``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build, quant, tune


def noise_var_rows(noise_var, rows: int) -> torch.Tensor:
    """``noise_var`` as the batch's rows read it: one value as a 0-d
    tensor (every row reads it, the single-cell computation unchanged), or
    L values, one per lane, each repeated over its lane's ``rows // L``
    contiguous rows, as a (rows,) tensor."""
    nv = torch.as_tensor(noise_var)
    n = nv.numel()
    if n == 1:
        return nv.reshape(())
    if n == 0 or rows % n:
        raise ValueError(f"{n} noise values for {rows} rows: 1 value, or "
                         "one per lane of an equal share of the rows")
    return nv.reshape(-1).repeat_interleave(rows // n)


def _cmul(ar, ai, br, bi):
    """(ar + i*ai) * (br + i*bi) in split-complex form."""
    return ar * br - ai * bi, ar * bi + ai * br


# ---------------------------------------------------------------------------
# fused equalize -> demap: plain twin
# ---------------------------------------------------------------------------

def _bit_of_table(n_levels: int, nb: int):
    """bit_of[p][j]: bit p (MSB first) of the axis-level index j."""
    return [[(j >> (nb - 1 - p)) & 1 for j in range(n_levels)]
            for p in range(nb)]


def _detect_demap_core(yr, yi, hr, hi, nv, levels: Sequence[float],
                       norm: float, nb: int):
    """Gram -> Gauss solve -> unbias -> max-log LLRs on split-complex
    lists (``yr/yi`` per rx, ``hr/hi`` [rx][tx], broadcastable), in the
    reference core's operation order.  Returns per-tx lists
    (xr, xi, nve, llr) with ``llr[t]`` the 2*nb per-bit list."""
    n_rx, n_tx = len(yr), len(hr[0])
    n_lv = len(levels)

    gr = [[None] * n_tx for _ in range(n_tx)]
    gi = [[None] * n_tx for _ in range(n_tx)]
    for t in range(n_tx):
        for u in range(n_tx):
            sr, si = 0.0, 0.0
            for r in range(n_rx):
                pr, pi = _cmul(hr[r][t], -hi[r][t], hr[r][u], hi[r][u])
                sr, si = sr + pr, si + pi
            gr[t][u], gi[t][u] = sr, si

    ar = [[gr[t][u] + nv if t == u else gr[t][u] + 0.0
           for u in range(n_tx)] for t in range(n_tx)]
    ai = [[gi[t][u] + 0.0 for u in range(n_tx)] for t in range(n_tx)]
    nrhs = 1 + n_tx
    br = [[None] * nrhs for _ in range(n_tx)]
    bi = [[None] * nrhs for _ in range(n_tx)]
    for t in range(n_tx):
        sr, si = 0.0, 0.0
        for r in range(n_rx):
            pr, pi = _cmul(hr[r][t], -hi[r][t], yr[r], yi[r])
            sr, si = sr + pr, si + pi
        br[t][0], bi[t][0] = sr, si
        for u in range(n_tx):
            br[t][1 + u], bi[t][1 + u] = gr[t][u], gi[t][u]

    for kd in range(n_tx):
        dr, di = ar[kd][kd], ai[kd][kd]
        den = dr * dr + di * di
        ivr, ivi = dr / den, -di / den
        for i in range(kd + 1, n_tx):
            fr, fi = _cmul(ar[i][kd], ai[i][kd], ivr, ivi)
            for u in range(kd, n_tx):
                pr, pi = _cmul(fr, fi, ar[kd][u], ai[kd][u])
                ar[i][u], ai[i][u] = ar[i][u] - pr, ai[i][u] - pi
            for j in range(nrhs):
                pr, pi = _cmul(fr, fi, br[kd][j], bi[kd][j])
                br[i][j], bi[i][j] = br[i][j] - pr, bi[i][j] - pi
    zr = [[None] * nrhs for _ in range(n_tx)]
    zi = [[None] * nrhs for _ in range(n_tx)]
    for kd in range(n_tx - 1, -1, -1):
        dr, di = ar[kd][kd], ai[kd][kd]
        den = dr * dr + di * di
        ivr, ivi = dr / den, -di / den
        for j in range(nrhs):
            sr, si = br[kd][j], bi[kd][j]
            for u in range(kd + 1, n_tx):
                pr, pi = _cmul(ar[kd][u], ai[kd][u], zr[u][j], zi[u][j])
                sr, si = sr - pr, si - pi
            zr[kd][j], zi[kd][j] = _cmul(sr, si, ivr, ivi)

    scale = float(np.sqrt(norm))
    bit_of = _bit_of_table(n_lv, nb)
    xr, xi, nve, llr = [], [], [], []
    for t in range(n_tx):
        mu = torch.clamp(zr[t][1 + t], 1e-6, 1.0 - 1e-6)
        ux, uy = zr[t][0] / mu, zi[t][0] / mu
        ne = (1.0 - mu) / mu
        nvs = torch.clamp(ne * norm, min=1e-6)
        xr.append(ux)
        xi.append(uy)
        nve.append(ne)
        bits = []
        for comp in (ux, uy):
            d = [(comp * scale - lv) ** 2 for lv in levels]
            for p in range(nb):
                d0 = d1 = None
                for j in range(n_lv):
                    if bit_of[p][j]:
                        d1 = d[j] if d1 is None else torch.minimum(d1, d[j])
                    else:
                        d0 = d[j] if d0 is None else torch.minimum(d0, d[j])
                bits.append((d0 - d1) / nvs)
        llr.append(bits)
    return xr, xi, nve, llr


def _hard_axis(comp, levels: Sequence[float], scale: float):
    """Nearest per-axis constellation level of ``comp`` (unit-power
    domain): the hard re-modulation of one SIC stage.  Levels in the
    modem's order, a strict ``<`` (the first level wins a tie), and a true
    division by ``scale`` on every device."""
    v = comp * scale
    best = levels[0] + 0.0 * v
    best_d = (v - levels[0]) ** 2
    for lv in levels[1:]:
        d = (v - lv) ** 2
        best = torch.where(d < best_d, lv, best)
        best_d = torch.minimum(d, best_d)
    return quant.true_div(best, scale)


def _sic_core(yr, yi, hr, hi, nv, levels: Sequence[float], norm: float,
              nb: int):
    """Successive interference cancellation over :func:`_detect_demap_core`:
    stage ``k`` solves the suffix system over streams ``k..n_tx-1``, keeps
    stream ``k``'s unbiased estimate and LLRs, hard-remodulates it and
    subtracts ``h[:, k] * x_k`` (the original column) from the residual.
    Streams cancel in index order.  Same return contract as
    :func:`_detect_demap_core`."""
    n_rx, n_tx = len(yr), len(hr[0])
    scale = float(np.sqrt(norm))
    yr, yi = list(yr), list(yi)
    xr_o, xi_o, nve_o, llr_o = [], [], [], []
    for k in range(n_tx):
        sub_hr = [[hr[r][t] for t in range(k, n_tx)] for r in range(n_rx)]
        sub_hi = [[hi[r][t] for t in range(k, n_tx)] for r in range(n_rx)]
        xr, xi, nve, llr = _detect_demap_core(
            yr, yi, sub_hr, sub_hi, nv, levels, norm, nb
        )
        xr_o.append(xr[0])
        xi_o.append(xi[0])
        nve_o.append(nve[0])
        llr_o.append(llr[0])
        if k < n_tx - 1:
            hxr = _hard_axis(xr[0], levels, scale)
            hxi = _hard_axis(xi[0], levels, scale)
            for r in range(n_rx):
                cr, ci = _cmul(hr[r][k], hi[r][k], hxr, hxi)
                yr[r] = yr[r] - cr
                yi[r] = yi[r] - ci
    return xr_o, xi_o, nve_o, llr_o


def _demap_torch(core, y, h, noise_var, modem):
    """Whole-grid form of a fused demap core (``h`` broadcast over the
    symbol axis, never materialized per symbol)."""
    n_rx, n_tx = y.shape[-1], h.shape[-1]
    nb = modem.bits_per_symbol // 2
    f32 = lambda v: v.to(torch.float32)
    yr = [f32(y[..., r].real) for r in range(n_rx)]
    yi = [f32(y[..., r].imag) for r in range(n_rx)]
    hr = [[f32(h[:, None, :, r, t].real) for t in range(n_tx)]
          for r in range(n_rx)]
    hi = [[f32(h[:, None, :, r, t].imag) for t in range(n_tx)]
          for r in range(n_rx)]
    nv = noise_var_rows(noise_var, y.shape[0])
    if nv.ndim:  # a value per batch row, broadcast over (n_sym, n_sc)
        nv = nv[:, None, None]
    xr, xi, nve, llr = core(
        yr, yi, hr, hi, nv, modem.levels, modem.norm, nb
    )
    shape = y.shape[:-1]
    x_hat = torch.stack(
        [torch.complex(xr[t], xi[t]).expand(shape) for t in range(n_tx)],
        dim=-1,
    )
    nv_eff = torch.stack([nve[t].expand(shape) for t in range(n_tx)], dim=-1)
    llr_out = torch.stack(
        [torch.stack([b.expand(shape) for b in llr[t]], dim=-1)
         for t in range(n_tx)], dim=-2,
    )
    return x_hat, nv_eff, llr_out


def mmse_detect_demap_torch(y, h, noise_var, modem):
    """Plain PyTorch twin of the fused detect+demap kernel.

    y (B, n_sym, n_sc, n_rx) complex, h (B, n_sc, n_rx, n_tx) complex (flat
    in time), noise_var one value or one per lane (module doc) ->
    (x_hat (B, n_sym, n_sc, n_tx) complex64,
    nv_eff (B, n_sym, n_sc, n_tx), llr (B, n_sym, n_sc, n_tx, 2*nb)).
    """
    return _demap_torch(_detect_demap_core, y, h, noise_var, modem)


def sic_detect_demap_torch(y, h, noise_var, modem):
    """Plain PyTorch twin of the fused SIC detect+demap kernel; the
    contract of :func:`mmse_detect_demap_torch`, per original stream."""
    return _demap_torch(_sic_core, y, h, noise_var, modem)


# ---------------------------------------------------------------------------
# fused equalize -> demap: CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _levels_on(levels: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(levels, dtype=torch.float32, device=device)


# launch choice: detect_demap.cu's subcarriers a block (sct,)
SUBCARRIER_TILES = (8, 16, 32)
DEFAULT_SUBCARRIER_TILE = 16  # every route has it
_MAX_COMPILED_NB = 4  # bits per axis of the compiled antenna shapes
_REGISTERED = ((1, 1), (2, 2), (4, 4), (8, 4))
# the compiled (n_rx, n_tx, nb) routes with every tile (detect_demap.cu's
# tiled_route), besides the runtime-sized one: the main paths' shapes
TILED_ROUTES = {False: ((1, 1, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2),
                        (8, 4, 3)),
                True: ((4, 4, 2),)}


def _tiles_of_route(sic: bool, n_rx: int, n_tx: int, nb: int) -> tuple:
    """The subcarrier tiles the kernel compiles for the route a launch at
    (n_rx, n_tx, nb) takes: every tile on a runtime-sized route or a
    tiled one, else only the default."""
    sic = sic and n_tx > 1  # one stream runs the joint kernel
    compiled = (n_rx, n_tx) in _REGISTERED and nb <= _MAX_COMPILED_NB
    if not compiled or (n_rx, n_tx, nb) in TILED_ROUTES[sic]:
        return SUBCARRIER_TILES
    return (DEFAULT_SUBCARRIER_TILE,)


def pick_subcarrier_tile(sic: bool, n_sym: int, n_sc: int, n_rx: int,
                         n_tx: int, nb: int) -> tuple:
    """The subcarriers a block (sct,) of ``detect_demap.cu``'s joint
    (``sic`` False) or SIC kernel: the ``cuda`` winner of
    :mod:`repro_torch.kernels.tune` for ("rx_detect_demap" or
    "rx_sic_demap", (n_sym, n_sc, n_rx, n_tx, 2^nb)) when the route has
    that tile, else 16.  Every tile gives the same outputs.  Memoized
    (:func:`~repro_torch.kernels.tune.picked`)."""
    op = "rx_sic_demap" if sic else "rx_detect_demap"
    return tune.picked(
        (op, n_sym, n_sc, n_rx, n_tx, nb),
        lambda: tune.resolve(
            op, (n_sym, n_sc, n_rx, n_tx, 1 << nb), "",
            lambda c: len(c) == 1 and c[0] in _tiles_of_route(
                sic, n_rx, n_tx, nb),
            lambda: (DEFAULT_SUBCARRIER_TILE,)))


def subcarrier_tile_candidates(sic: bool, n_rx: int, n_tx: int,
                               nb: int) -> list:
    """The tuner's candidates: every tile the launch's route compiles."""
    return [(t,) for t in _tiles_of_route(sic, n_rx, n_tx, nb)]


def _demap_lib(entry: str):
    fn = getattr(_build.library("detect_demap"), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
            [ctypes.c_void_p] + [ctypes.c_float] * 2 + \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_floats(sic: bool, b: int, n_sym: int, n_sc: int, n_rx: int,
                      n_tx: int, nb: int, sct: int) -> int:
    """Floats of the workspace a launch at subcarrier tile ``sct`` needs
    (``detect_demap_workspace`` of the source): 0 for the compiled
    instances (the registered antenna shapes at 1..4 bits per axis) and
    for the launches whose runtime-sized state fits a block's shared
    memory."""
    fn = _build.library("detect_demap").detect_demap_workspace
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 8
        fn.restype = ctypes.c_longlong
    return int(fn(int(sic), b, n_sym, n_sc, n_rx, n_tx, nb, sct))


def _demap_cuda(entry: str, counter: str, y, h, noise_var, modem, choice):
    """Launch ``entry`` of ``csrc/detect_demap.cu`` at any (n_rx, n_tx)
    and 1..14 bits per axis (the source's ``kMaxNb``: its 2^nb levels sit
    in a block's shared memory), with the workspace the source asks for,
    at the subcarrier tile ``choice`` = (sct,) (by default
    :func:`pick_subcarrier_tile`'s; the kernel refuses a tile its route
    does not compile).  ``noise_var`` holds 1 value or one per lane, a
    divisor of B."""
    b, n_sym, n_sc, n_rx = y.shape
    n_tx = h.shape[-1]
    nb = modem.bits_per_symbol // 2
    if not 1 <= nb <= 14 or len(modem.levels) != 1 << nb:
        raise ValueError(f"modem {modem.name}: {len(modem.levels)} levels "
                         f"for {nb} bits per axis (1..14 taken)")
    if tuple(h.shape) != (b, n_sc, n_rx, n_tx):
        raise ValueError(f"h {tuple(h.shape)} != {(b, n_sc, n_rx, n_tx)}")
    nv = noise_var.reshape(-1)  # the kernel reads n_nv floats at nv
    n_nv = nv.numel()
    if n_nv < 1 or b % n_nv:
        raise ValueError(f"noise_var holds {n_nv} values for a batch of "
                         f"{b}: 1 value, or one per lane (a divisor of B)")
    _build.require_cuda("detect_demap", y=(y, torch.complex64),
                        h=(h, torch.complex64),
                        noise_var=(nv, torch.float32))
    sic = entry == "sic_demap_launch"
    choice = (pick_subcarrier_tile(sic, n_sym, n_sc, n_rx, n_tx, nb)
              if choice is None else tune.as_choice(choice, 1, entry, "(sct,)"))
    sct = choice[0]
    lv = _levels_on(tuple(float(v) for v in modem.levels), y.device)
    x_hat = torch.empty((b, n_sym, n_sc, n_tx), dtype=torch.complex64,
                        device=y.device)
    nv_eff = torch.empty((b, n_sym, n_sc, n_tx), dtype=torch.float32,
                         device=y.device)
    llr = torch.empty((b, n_sym, n_sc, n_tx, 2 * nb), dtype=torch.float32,
                      device=y.device)
    n_ws = _workspace_floats(sic, b, n_sym, n_sc, n_rx, n_tx, nb, sct)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=y.device)
          if n_ws else None)
    err = _demap_lib(entry)(
        y.data_ptr(), h.data_ptr(), nv.data_ptr(), n_nv,
        lv.data_ptr(),
        float(modem.norm), float(np.sqrt(modem.norm)), x_hat.data_ptr(),
        nv_eff.data_ptr(), llr.data_ptr(),
        None if ws is None else ws.data_ptr(), b, n_sym, n_sc, n_rx, n_tx,
        nb, sct, _build.stream_of(y))
    _build.launches[counter] += 1
    _build.launch_choices[counter] = choice
    _build.check(err, entry)
    return x_hat, nv_eff, llr


def mmse_detect_demap_cuda(y, h, noise_var, modem, choice=None):
    """Launch ``detect_demap_kernel``: a block per (batch row, sct
    subcarriers) factors each subcarrier's system once and applies it to
    every symbol's RE."""
    return _demap_cuda("detect_demap_launch", "mmse_detect_demap", y, h,
                       noise_var, modem, choice)


def sic_detect_demap_cuda(y, h, noise_var, modem, choice=None):
    """Launch ``sic_demap_kernel``: a block per (batch row, sct
    subcarriers) factors every stage's system of each subcarrier once,
    then one thread per RE runs the stages on its residual (for a shape
    with no compiled instance, its vectors in shared memory or the
    workspace).  One stream has nothing to cancel; ``sic_demap_launch``
    then runs ``detect_demap_kernel``, the same operations."""
    return _demap_cuda("sic_demap_launch", "sic_detect_demap", y, h,
                       noise_var, modem, choice)


def _dispatch(twin, kernel, y, h, noise_var, modem, precision, choice,
              sic):
    """The twin on a CPU tensor (an explicit ``choice`` checked against
    the route's tiles), the kernel (on contiguous operands) on a CUDA one;
    quantized precisions round the LLRs onto the int8 grid."""
    if y.device.type == "cpu":
        tiles = _tiles_of_route(sic, y.shape[-1], h.shape[-1],
                                modem.bits_per_symbol // 2)
        if choice is not None and tuple(choice) not in [(t,) for t in tiles]:
            raise ValueError(f"detect + demap: no kernel instance for "
                             f"launch choice {tuple(choice)}")
        out = twin(y, h, noise_var, modem)
    else:
        out = kernel(y.contiguous(), h.contiguous(), noise_var, modem,
                     choice)
    if not quant.is_quantized(precision):
        return out
    x_hat, nv_eff, llr = out
    return x_hat, nv_eff, quant.fake_quant_llr(llr, precision)


def mmse_detect_demap(y, h, noise_var, modem, *,
                      precision: Optional[str] = None,
                      choice: Optional[tuple] = None):
    """Fused MMSE equalize -> demap: the CUDA kernel on a CUDA tensor (at
    the subcarrier tile ``choice`` = (sct,), by default
    :func:`pick_subcarrier_tile`'s), the plain twin on a CPU tensor.
    ``precision="int8"|"fp8"`` returns LLRs rounded onto the fixed int8
    grid (still float32, so the chain keeps its shapes and dtypes);
    :func:`mmse_detect_demap_int8` gives the raw (codes, scale) pair."""
    return _dispatch(mmse_detect_demap_torch, mmse_detect_demap_cuda, y, h,
                     noise_var, modem, precision, choice, False)


def sic_detect_demap(y, h, noise_var, modem, *,
                     precision: Optional[str] = None,
                     choice: Optional[tuple] = None):
    """Fused SIC equalize -> demap, dispatched and quantized as
    :func:`mmse_detect_demap`."""
    return _dispatch(sic_detect_demap_torch, sic_detect_demap_cuda, y, h,
                     noise_var, modem, precision, choice, True)


def mmse_detect_demap_int8(y, h, noise_var, modem, *,
                           llr_clip: float = quant.LLR_CLIP):
    """Quantized-LLR demap: (x_hat, nv_eff, llr_q int8, scale).
    ``dequantize_llr(llr_q, scale)`` is what the ``precision="int8"`` path
    of :func:`mmse_detect_demap` feeds the decoder."""
    x_hat, nv_eff, llr = mmse_detect_demap(y, h, noise_var, modem)
    llr_q, scale = quant.quantize_llr(llr, clip=llr_clip)
    return x_hat, nv_eff, llr_q, scale


# ---------------------------------------------------------------------------
# fused LS channel estimation
# ---------------------------------------------------------------------------

def make_ls_interp_operator(n_sc: int, n_tx: int, pilot_stride: int,
                            seq: np.ndarray) -> np.ndarray:
    """(n_tx, n_p, n_sc) complex64 operator folding the per-pilot divide
    and the clamped linear frequency interpolation into one GEMM:
    ``H_ls[..., t] = ybar[comb_t] @ op[t]`` (unit-power pilots: dividing
    by ``seq`` is multiplying by its conjugate)."""
    spacing = pilot_stride * n_tx
    if n_sc % spacing:
        raise ValueError(
            f"n_sc={n_sc} not a multiple of the comb spacing {spacing}"
        )
    n_p = n_sc // spacing
    seq = np.asarray(seq)
    pos = np.arange(n_sc, dtype=np.float64)
    op = np.zeros((n_tx, n_p, n_sc), np.complex64)
    for t in range(n_tx):
        p_idx = np.arange(t * pilot_stride, n_sc, spacing)
        xp = pos[p_idx]
        for s in range(n_sc):
            x = pos[s]
            if x <= xp[0]:
                w = {0: 1.0}
            elif x >= xp[-1]:
                w = {n_p - 1: 1.0}
            else:
                i = int(np.searchsorted(xp, x, side="right") - 1)
                f = (x - xp[i]) / (xp[i + 1] - xp[i])
                w = {i: 1.0 - f, i + 1: f}
            for i, wt in w.items():
                op[t, i, s] += wt * np.conj(seq[p_idx[i]])
    return op


def _comb_extract(y, pilot_symbols: tuple, pilot_stride: int, n_tx: int):
    """(B, n_psym, n_tx, n_p, n_rx) strided gather of the DMRS REs."""
    spacing = pilot_stride * n_tx
    yp = y[:, list(pilot_symbols)]  # (B, n_psym, n_sc, n_rx)
    return torch.stack(
        [yp[:, :, t * pilot_stride::spacing, :] for t in range(n_tx)], dim=2
    )


def ls_che_torch(y, pilot_symbols: tuple, pilot_stride: int, op):
    """Plain PyTorch twin of the fused LS-CHE kernel.
    y (B, n_sym, n_sc, n_rx), op (n_tx, n_p, n_sc)
    -> H (B, n_sc, n_rx, n_tx).  The product is a multiply and a sum
    over the pilots, so a row's result does not depend on the batch
    (a GEMM's rounding does, on the CPU below four rows), as the kernel's
    does not."""
    n_tx = op.shape[0]
    comb = torch.mean(
        _comb_extract(y, pilot_symbols, pilot_stride, n_tx), dim=1
    )  # (B, n_tx, n_p, n_rx)
    h = torch.sum(comb[:, :, :, None, :] * op[None, :, :, :, None], dim=2)
    return h.permute(0, 2, 3, 1)  # (B, t, s, r) -> (B, s, r, t)


def _ls_lib():
    fn = _build.library("ls_che").ls_che_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + \
            [ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _symbol_mask(symbols: tuple, n_sym: int, device: torch.device) -> tuple:
    """The pilot symbols as a mask of 64-bit words, bit k of word w for
    symbol 64 w + k: word 0 (the kernel takes it by value) and the others
    on ``device`` (None for a slot of up to 64 symbols)."""
    words = [sum(1 << (s - 64 * w) for s in symbols if s // 64 == w)
             for w in range(-(-n_sym // 64))]
    rest = (torch.tensor([w - (1 << 64) if w >= 1 << 63 else w
                          for w in words[1:]], dtype=torch.int64,
                         device=device) if len(words) > 1 else None)
    return words[0], rest


# launch choice: ls_che.cu's threads an output (tpo,)
THREADS_PER_OUTPUT = (1, 2)
_LS_SC, _LS_RB = 16, 64  # a block's subcarriers and (batch, rx) rows
_LS_TPO2_OUTPUTS = 256  # outputs a block covers at two threads an output


def _valid_tpo(choice: tuple, rows: int) -> bool:
    return len(choice) == 1 and (choice[0] == 1 or (
        choice[0] == 2 and min(rows, _LS_RB) * _LS_SC <= _LS_TPO2_OUTPUTS))


def pick_threads_per_output(n_sc: int, n_rx: int, n_tx: int, n_p: int,
                            rows: int) -> tuple:
    """``ls_che.cu``'s threads an output (tpo,) for ``rows`` = batch x
    n_rx: the ``cuda`` winner of :mod:`repro_torch.kernels.tune` for
    ("rx_ls_che", (n_sc, n_rx, n_tx, n_p)) when the kernel has it at these
    rows, else 2 where a block holds at most 128 outputs (8 rows), else 1.
    Memoized (:func:`~repro_torch.kernels.tune.picked`)."""
    return tune.picked(
        ("rx_ls_che", n_sc, n_rx, n_tx, n_p, rows),
        lambda: tune.resolve(
            "rx_ls_che", (n_sc, n_rx, n_tx, n_p), "",
            lambda c: _valid_tpo(c, rows),
            lambda: (2 if rows * _LS_SC <= 128 else 1,)))


def threads_per_output_candidates(rows: int) -> list:
    """The tuner's candidates at ``rows`` = batch x n_rx."""
    return [(t,) for t in THREADS_PER_OUTPUT if _valid_tpo((t,), rows)]


def ls_che_cuda(y, pilot_symbols: tuple, pilot_stride: int, op,
                choice: Optional[tuple] = None):
    """Launch ``csrc/ls_che.cu``: one block per slab of 16 subcarriers
    of one tx and up to 64 (batch, rx) rows, ``choice`` = (tpo,) threads
    an output (by default :func:`pick_threads_per_output`'s; the kernel
    refuses a tpo it has no instance for at these rows); the pilot
    symbols (any indices) go to the kernel as a mask of ``n_sym``
    bits."""
    b, n_sym, n_sc, n_rx = y.shape
    n_tx, n_p, n_sc_op = op.shape
    if n_sc_op != n_sc or n_p * pilot_stride * n_tx != n_sc:
        raise ValueError(f"operator {tuple(op.shape)} does not fit a "
                         f"{n_sc}-subcarrier grid at stride {pilot_stride}")
    symbols = tuple(sorted(int(s) for s in pilot_symbols))
    if not symbols or symbols[0] < 0 or symbols[-1] >= n_sym or \
            len(set(symbols)) != len(symbols):
        raise ValueError(f"bad pilot symbols {pilot_symbols} for "
                         f"{n_sym} symbols")
    _build.require_cuda("ls_che", y=(y, torch.complex64),
                        op=(op, torch.complex64))
    choice = (pick_threads_per_output(n_sc, n_rx, n_tx, n_p, b * n_rx)
              if choice is None else tune.as_choice(choice, 1, "ls_che",
                                                    "(tpo,)"))
    mask0, rest = _symbol_mask(symbols, n_sym, y.device)
    h = torch.empty((b, n_sc, n_rx, n_tx), dtype=torch.complex64,
                    device=y.device)
    err = _ls_lib()(y.data_ptr(), op.data_ptr(), h.data_ptr(), b, n_sym,
                    n_sc, n_rx, n_tx, pilot_stride, mask0,
                    None if rest is None else rest.data_ptr(), len(symbols),
                    choice[0], _build.stream_of(y))
    _build.launches["ls_che"] += 1
    _build.launch_choices["ls_che"] = choice
    _build.check(err, "ls_che")
    return h


def ls_che(y, pilot_symbols: tuple, pilot_stride: int, op, *,
           choice: Optional[tuple] = None):
    """Fused LS CHE (comb extract -> divide -> interp): the CUDA kernel on
    a CUDA tensor (laid out contiguously first, at ``choice`` = (tpo,),
    by default :func:`pick_threads_per_output`'s), the plain twin on a CPU
    tensor (an explicit ``choice`` is still checked)."""
    if y.device.type == "cpu":
        if choice is not None and not _valid_tpo(
                tuple(choice), y.shape[0] * y.shape[-1]):
            raise ValueError(f"ls_che: no kernel instance for launch "
                             f"choice {tuple(choice)}")
        return ls_che_torch(y, pilot_symbols, pilot_stride, op)
    return ls_che_cuda(y.contiguous(), pilot_symbols, pilot_stride, op,
                       choice)
