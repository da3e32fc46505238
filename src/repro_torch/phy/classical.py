"""Classical wireless signal processing (port of
:mod:`repro.phy.classical`): CFFT, LS / Wiener channel estimation,
unbiased MIMO-MMSE detection and its successive-interference-cancellation
composition.

The Wiener smoother's (n_sc x n_sc) solve, the FFT and the small batched
MMSE solves of the unfused detector stay library calls, as the reference
leaves them to XLA outside any Pallas kernel; ``cfft_radix2`` writes the
PEs' radix-2 butterflies out in torch ops, as the reference does in jnp.  Solves go through
``torch.linalg.solve_ex`` so they never block the host on an error check.

``noise_var`` is one value or one per lane of a multi-cell step
(:func:`repro_torch.kernels.rx_fused.noise_var_rows`): L contiguous lane
blocks of the batch rows, each read with its own lane's value.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.rx_fused import noise_var_rows


def cfft(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Complex FFT (the PE CFFT kernel; paper Fig. 8)."""
    return torch.fft.fft(x, dim=axis)


def cfft_auto(x: torch.Tensor, axis: int = -1,
              prefer_butterfly: bool = False) -> torch.Tensor:
    """CFFT for any transform length: ``torch.fft.fft``, or with
    ``prefer_butterfly=True`` the radix-2 butterflies of
    :func:`cfft_radix2` for a power-of-two length (any other length still
    takes ``torch.fft.fft``)."""
    n = x.shape[axis]
    if prefer_butterfly and n > 1 and n & (n - 1) == 0:
        return torch.movedim(cfft_radix2(torch.movedim(x, axis, -1)), -1,
                             axis)
    return torch.fft.fft(x, dim=axis)


def cfft_radix2(x: torch.Tensor) -> torch.Tensor:
    """Iterative radix-2 DIT FFT over the last axis (power-of-two length):
    the explicit butterfly formulation that runs on the paper's PEs, in
    complex64."""
    n = x.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"radix-2 needs a power-of-two length, got {n}")
    bits = n.bit_length() - 1
    idx = torch.arange(n, device=x.device)
    rev = torch.zeros_like(idx)
    for b in range(bits):  # bit-reversal permutation
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    y = x[..., rev].to(torch.complex64)
    size = 2
    while size <= n:
        half = size // 2
        tw = torch.exp(-2j * np.pi * torch.arange(
            half, device=x.device, dtype=torch.float32) / size)
        y = y.reshape(*y.shape[:-1], n // size, size)
        even, odd = y[..., :half], y[..., half:] * tw
        y = torch.cat([even + odd, even - odd], dim=-1).reshape(
            *y.shape[:-2], n)
        size *= 2
    return y


def ls_channel_estimate(
    y: torch.Tensor,  # (B, n_sym, n_sc) received grid
    pilots: torch.Tensor,  # (n_sc,) known pilot symbols
    pilot_mask: torch.Tensor,  # (n_sym, n_sc) bool
    pilot_stride: int = 4,  # static pilot subcarrier spacing
) -> torch.Tensor:
    """LS estimate averaged over the pilot symbols, then clamped linear
    interpolation from the comb ``0::pilot_stride`` to every subcarrier.
    Returns H_hat (B, n_sc), flat in time within the slot."""
    est = y / pilots[None, None, :]  # (B, n_sym, n_sc)
    w = pilot_mask.to(torch.float32)[None]
    h_p = torch.sum(est * w, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                  min=1e-9)
    n_sc = y.shape[-1]
    return _interp_rows(h_p[:, ::pilot_stride], n_sc, 0, pilot_stride)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_ex(a, b)[0]


def mmse_channel_estimate(
    h_ls: torch.Tensor,  # (B, n_sc) LS estimate
    noise_var: torch.Tensor,
    corr_len: float = 16.0,
) -> torch.Tensor:
    """Wiener smoothing of the LS estimate with an exponential frequency
    correlation model: H_mmse = R (R + sigma^2 I)^-1 H_ls.

    With L noise values there is one (n_sc, n_sc) operator per lane, and
    lane l's operator smooths its B / L rows.  Each lane's solve and
    product are the one-value computation at that lane's shapes, so a
    lane's rows come out as a step of its own would give them.  The
    product is a multiply and a sum over ``k``, not a GEMM: a GEMM's
    rounding depends on its row count (on the CPU below four rows), and a
    lane's rows must not depend on how many of them a grid entry holds."""
    n_sc = h_ls.shape[-1]
    ar = torch.arange(n_sc, device=h_ls.device)
    d = torch.abs(ar[:, None] - ar[None, :])
    r = torch.exp(-d / corr_len).to(torch.complex64)
    eye = torch.eye(n_sc, dtype=torch.complex64, device=h_ls.device)
    nv = torch.as_tensor(noise_var).reshape(-1)
    if h_ls.shape[0] % nv.numel():
        raise ValueError(f"{nv.numel()} noise values for {h_ls.shape[0]} "
                         "rows: 1 value, or one per lane of an equal share")
    # w (n_sc, n_sc) per lane, applied as sum_k w[s, k] h[b, k]
    out = [torch.sum(_solve(r + v * eye, r)[None] * h_l[:, None, :], dim=-1)
           for v, h_l in zip(nv, h_ls.reshape(nv.numel(), -1, n_sc))]
    return out[0] if len(out) == 1 else torch.cat(out)


def _regularized_gram_rhs(y, h, noise_var):
    """Shared MMSE front end: (gram H^H H, A = gram + s2 I, rhs H^H y)
    for y (B, n_sc, n_rx), h (B, n_sc, n_rx, n_tx)."""
    n_tx = h.shape[-1]
    hh = torch.conj(torch.swapaxes(h, -1, -2))  # (B, n_sc, n_tx, n_rx)
    gram = torch.einsum("bstr,bsru->bstu", hh, h)
    nv = noise_var_rows(noise_var, h.shape[0])
    if nv.ndim:  # a value per row
        nv = nv[:, None, None, None]
    a = gram + nv * torch.eye(n_tx, dtype=h.dtype, device=h.device)
    rhs = torch.einsum("bstr,bsr->bst", hh, y)
    return gram, a, rhs


def mimo_mmse_detect(y, h, noise_var):
    """Per-subcarrier MMSE equalizer x = (H^H H + s2 I)^-1 H^H y for
    y (B, n_sc, n_rx), h (B, n_sc, n_rx, n_tx) -> (B, n_sc, n_tx)."""
    _, a, rhs = _regularized_gram_rhs(y, h, noise_var)
    return _solve(a, rhs[..., None])[..., 0]


def mimo_mmse_detect_ext(y, h, noise_var):
    """Unbiased MMSE detection with per-stream post-equalization noise.

    Returns (x_hat_unbiased (B, n_sc, n_tx), nv_eff (B, n_sc, n_tx)):
    the MMSE output divided by mu_t = Re[(H^H H + s2 I)^-1 H^H H]_tt and
    the residual noise variance (1 - mu_t) / mu_t.
    """
    gram, a, rhs = _regularized_gram_rhs(y, h, noise_var)
    sol = _solve(a, torch.cat([rhs[..., None], gram], dim=-1))
    x_mmse = sol[..., 0]
    mu = torch.clamp(
        torch.diagonal(sol[..., 1:], dim1=-2, dim2=-1).real,
        1e-6, 1.0 - 1e-6,
    )  # (B, n_sc, n_tx)
    return x_mmse / mu, (1.0 - mu) / mu


def mimo_sic_detect_ext(y, h, noise_var, modem):
    """Successive interference cancellation over the unbiased MMSE
    detector, staged: detect a stream, hard-decide it on the modem's grid
    (max-log hard bits back through the modem, the nearest point of a gray
    square QAM), subtract its contribution and re-solve the shrunken
    system for the remaining streams.  Streams cancel in index order.

    y (B, n_sc, n_rx), h (B, n_sc, n_rx, n_tx) -> (x_hat (B, n_sc, n_tx),
    nv_eff (B, n_sc, n_tx)), per original stream.
    """
    n_tx = h.shape[-1]
    y_res = y
    xs, nvs = [], []
    for k in range(n_tx):
        x_all, nv_all = mimo_mmse_detect_ext(y_res, h[..., k:], noise_var)
        x_k, nv_k = x_all[..., 0], nv_all[..., 0]
        xs.append(x_k)
        nvs.append(nv_k)
        if k < n_tx - 1:
            hard = (modem.demod_llr(x_k, nv_k) > 0).to(torch.int32)
            y_res = y_res - h[..., k] * modem.mod(hard)[..., None]
    return torch.stack(xs, dim=-1), torch.stack(nvs, dim=-1)


@functools.lru_cache(maxsize=None)
def _interp_weights(n_sc: int, offset: int, spacing: int):
    """Static operands of ``jnp.interp(pos, pos[p_idx], fp)``: the upper
    neighbour ``i``, the float32 fraction ``delta / dx`` and the clamp
    masks, computed exactly as ``jnp.interp`` computes them."""
    pos = np.arange(n_sc, dtype=np.float32)
    xp = pos[offset::spacing]
    i = np.clip(np.searchsorted(xp, pos, side="right"), 1, len(xp) - 1)
    frac = (pos - xp[i - 1]) / (xp[i] - xp[i - 1])  # float32 divide
    return i, frac.astype(np.float32), pos < xp[0], pos > xp[-1]


@functools.lru_cache(maxsize=None)
def _interp_weights_on(n_sc: int, offset: int, spacing: int,
                       device: torch.device) -> tuple:
    """:func:`_interp_weights` on ``device``, built once per device (a
    captured step copies nothing from the host), with the lower neighbour
    ``i - 1`` beside ``i``."""
    i, frac, left, right = _interp_weights(n_sc, offset, spacing)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (i - 1, i, frac, left, right))


def _interp_rows(fp: torch.Tensor, n_sc: int, offset: int,
                 spacing: int) -> torch.Tensor:
    """Clamped linear interpolation of each row of ``fp`` (rows, n_p) from
    the comb ``offset::spacing`` onto all ``n_sc`` subcarriers: the same
    arithmetic and end clamping as ``jnp.interp``, on real and imaginary
    parts alike."""
    i_lo, i, frac, left, right = _interp_weights_on(n_sc, offset, spacing,
                                                    fp.device)
    out = []
    for part in (fp.real, fp.imag):
        lo, hi = part[:, i_lo], part[:, i]
        f = lo + frac * (hi - lo)
        f = torch.where(left, part[:, :1], f)
        f = torch.where(right, part[:, -1:], f)
        out.append(f)
    return torch.complex(out[0], out[1])


def ls_channel_estimate_link(
    y: torch.Tensor,  # (B, n_sym, n_sc, n_rx) received grid
    pilot_seq: torch.Tensor,  # (n_sc,) known pilot symbols
    pilot_masks: torch.Tensor,  # (n_tx, n_sym, n_sc) staggered per-tx combs
    pilot_stride: int,
) -> torch.Tensor:
    """Per-(rx, tx) LS estimate from staggered DMRS combs + clamped linear
    interpolation.  Returns H_hat (B, n_sc, n_rx, n_tx)."""
    n_tx = pilot_masks.shape[0]
    b, n_sym, n_sc, n_rx = y.shape
    spacing = pilot_stride * n_tx
    est = y / pilot_seq[None, None, :, None]  # (B, n_sym, n_sc, n_rx)
    outs = []
    for t in range(n_tx):
        w = pilot_masks[t].to(torch.float32)[None, :, :, None]
        h_p = torch.sum(est * w, dim=1) / torch.clamp(
            torch.sum(w, dim=1), min=1e-9
        )  # (B, n_sc, n_rx), nonzero only on tx t's comb
        fp = torch.movedim(h_p[:, t * pilot_stride::spacing, :], 1, -1)
        full = _interp_rows(
            fp.reshape(b * n_rx, -1), n_sc, t * pilot_stride, spacing
        ).reshape(b, n_rx, n_sc)
        outs.append(torch.movedim(full, 1, -1))  # (B, n_sc, n_rx)
    return torch.stack(outs, dim=-1)  # (B, n_sc, n_rx, n_tx)


def mmse_smooth_link(
    h_ls: torch.Tensor,  # (B, n_sc, n_rx, n_tx)
    noise_var: torch.Tensor,
    corr_len: float = 16.0,
) -> torch.Tensor:
    """Wiener smoothing of a per-(rx, tx) LS estimate (antenna pairs fold
    into the batch of :func:`mmse_channel_estimate`)."""
    b, n_sc, n_rx, n_tx = h_ls.shape
    flat = torch.movedim(h_ls, 1, -1).reshape(b * n_rx * n_tx, n_sc)
    sm = mmse_channel_estimate(flat, noise_var, corr_len=corr_len)
    return torch.movedim(sm.reshape(b, n_rx, n_tx, n_sc), -1, 1)
