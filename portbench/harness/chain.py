"""Frozen plain receive chain: the pieces the configurations' references
(``portbench/reference/<name>.py``) compose.

A copy of the port's plain path as it stood when the benchmark was
written: CFFT, the staggered-comb LS estimate with clamped linear
interpolation, Wiener smoothing (one operator per noise value), the
unbiased MMSE detector through a linear solve, the max-log demapper,
de-rate-matching with the HARQ prior, the layered normalized min-sum
decoder and the CRC check.  Plain PyTorch in float32 with TF32 off; it
imports nothing of the program.

The control that a comparison has to fail takes the products of the
Wiener operator and of the detector with TF32 operands (:func:`tf32`:
rounded to TF32's 10 mantissa bits, accumulated in float32), as a TF32
matrix product on the card would.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from harness.generator import crc_matrix, rv_offset
from harness.spec import data_re_index, pilot_masks_np, pilot_sequence_np


def fp32_only() -> None:
    """Every float32 product in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as the tensor cores take a float32 operand; complex parts
    alike."""
    if t.is_complex():
        return torch.complex(tf32(t.real), tf32(t.imag))
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def cfft(y_time: torch.Tensor) -> torch.Tensor:
    """(B, n_sym, n_sc, n_rx) time samples -> frequency grid."""
    return torch.fft.fft(y_time, dim=2)


@functools.lru_cache(maxsize=None)
def _interp_weights(n_sc: int, offset: int, spacing: int):
    pos = np.arange(n_sc, dtype=np.float32)
    xp = pos[offset::spacing]
    i = np.clip(np.searchsorted(xp, pos, side="right"), 1, len(xp) - 1)
    frac = (pos - xp[i - 1]) / (xp[i] - xp[i - 1])
    return i, frac.astype(np.float32), pos < xp[0], pos > xp[-1]


def _interp_rows(fp: torch.Tensor, n_sc: int, offset: int,
                 spacing: int) -> torch.Tensor:
    """Clamped linear interpolation of each row of ``fp`` from the comb
    ``offset::spacing`` onto every subcarrier."""
    i, frac, left, right = (torch.from_numpy(a).to(fp.device) for a in
                            _interp_weights(n_sc, offset, spacing))
    out = []
    for part in (fp.real, fp.imag):
        lo, hi = part[:, i - 1], part[:, i]
        f = lo + frac * (hi - lo)
        f = torch.where(left, part[:, :1], f)
        f = torch.where(right, part[:, -1:], f)
        out.append(f)
    return torch.complex(out[0], out[1])


def ls_estimate(grid, y: torch.Tensor) -> torch.Tensor:
    """Per-(rx, tx) LS estimate on the staggered DMRS combs, averaged over
    the pilot symbols and interpolated: (B, n_sc, n_rx, n_tx)."""
    dev = y.device
    seq = torch.from_numpy(pilot_sequence_np(grid)).to(dev)
    masks = torch.from_numpy(pilot_masks_np(grid)).to(dev)
    n_tx = masks.shape[0]
    b, n_sym, n_sc, n_rx = y.shape
    spacing = grid.pilot_stride * n_tx
    est = y / seq[None, None, :, None]
    outs = []
    for t in range(n_tx):
        w = masks[t].to(torch.float32)[None, :, :, None]
        h_p = torch.sum(est * w, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                      min=1e-9)
        fp = torch.movedim(h_p[:, t * grid.pilot_stride::spacing, :], 1, -1)
        full = _interp_rows(fp.reshape(b * n_rx, -1), n_sc,
                            t * grid.pilot_stride, spacing
                            ).reshape(b, n_rx, n_sc)
        outs.append(torch.movedim(full, 1, -1))
    return torch.stack(outs, dim=-1)


def wiener(h_ls: torch.Tensor, nv: torch.Tensor, corr_len: float,
           operand=_same) -> torch.Tensor:
    """Wiener smoothing R (R + s2 I)^-1 h_ls of each (rx, tx) pair over
    the subcarriers, exponential correlation; ``nv`` (B,) one noise
    variance a slot, one operator per distinct value; ``operand`` is
    applied to both factors of the operator's product."""
    b, n_sc, n_rx, n_tx = h_ls.shape
    flat = torch.movedim(h_ls, 1, -1).reshape(b, n_rx * n_tx, n_sc)
    ar = torch.arange(n_sc, device=h_ls.device)
    r = torch.exp(-torch.abs(ar[:, None] - ar[None, :]) / corr_len).to(
        torch.complex64)
    eye = torch.eye(n_sc, dtype=torch.complex64, device=h_ls.device)
    out = torch.empty_like(flat)
    for v in torch.unique(nv):
        rows = nv == v
        w = torch.linalg.solve_ex(r + v * eye, r)[0]
        out[rows] = torch.sum(operand(w)[None, None]
                              * operand(flat[rows])[:, :, None, :], dim=-1)
    return torch.movedim(out.reshape(b, n_rx, n_tx, n_sc), -1, 1)


def mmse_detect(y: torch.Tensor, h: torch.Tensor, nv: torch.Tensor,
                operand=_same):
    """Unbiased per-RE MMSE detection of y (B, n_sym, n_sc, n_rx) through
    h (B, n_sc, n_rx, n_tx) flat in time: (x_hat, nv_eff), each
    (B, n_sym, n_sc, n_tx); ``operand`` is applied to the factors of the
    Gram and matched-filter products."""
    b, n_sym, n_sc, n_rx = y.shape
    n_tx = h.shape[-1]
    hb = h[:, None].expand(b, n_sym, n_sc, n_rx, n_tx)
    hh = operand(torch.conj(torch.swapaxes(hb, -1, -2)))
    gram = torch.einsum("bmstr,bmsru->bmstu", hh, operand(hb))
    eye = torch.eye(n_tx, dtype=h.dtype, device=h.device)
    a = gram + nv[:, None, None, None, None] * eye
    rhs = torch.einsum("bmstr,bmsr->bmst", hh, operand(y))
    sol = torch.linalg.solve_ex(a, torch.cat([rhs[..., None], gram], -1))[0]
    mu = torch.clamp(torch.diagonal(sol[..., 1:], dim1=-2, dim2=-1).real,
                     1e-6, 1.0 - 1e-6)
    return sol[..., 0] / mu, (1.0 - mu) / mu


def demap(modem, x: torch.Tensor, nv_eff: torch.Tensor) -> torch.Tensor:
    """Max-log LLRs log P(1)/P(0) of gray square QAM: (..., n_tx) ->
    (..., n_tx, bits_per_symbol)."""
    nb = modem.bits_per_axis
    dev = x.device
    lv = torch.tensor(modem.levels, dtype=torch.float32, device=dev)
    bit_of = torch.tensor([[(j >> (nb - 1 - p)) & 1 for j in
                            range(len(modem.levels))] for p in range(nb)],
                          dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    s = float(np.sqrt(np.float32(modem.norm)))
    nv = torch.clamp(nv_eff * modem.norm, min=1e-6)

    def axis(u):
        d = (u[..., None] - lv) ** 2
        return [torch.amin(torch.where(bit_of[p], inf, d), dim=-1)
                - torch.amin(torch.where(bit_of[p], d, inf), dim=-1)
                for p in range(nb)]

    llrs = axis(x.real * s) + axis(x.imag * s)
    return torch.stack(llrs, dim=-1) / nv[..., None]


def combine(rung, llr: torch.Tensor, rv: torch.Tensor,
            prior: torch.Tensor) -> torch.Tensor:
    """Grid LLRs (B, n_sym, n_sc, n_tx, nb) -> the combined mother-code
    buffer (B, C, n_mother): each codeword's transmitted bits off the data
    REs, put back at their circular-buffer positions of the slot's RV,
    plus the HARQ prior."""
    code, c = rung.code, rung.codewords_per_slot
    sym, sc = (torch.from_numpy(a).to(llr.device)
               for a in data_re_index(rung.grid))
    b = llr.shape[0]
    data = llr[:, sym, sc].reshape(b, -1)[:, : c * code.e_bits]
    buf = data.reshape(b, c, code.e_bits).to(torch.float32)
    n = code.n_mother
    buf = torch.cat([buf, torch.zeros(b, c, n - code.e_bits,
                                      device=buf.device)], dim=-1)
    off = rv_offset(code, rv.long()).reshape(b, 1, 1)
    idx = torch.remainder(torch.arange(n, device=buf.device) - off, n)
    return torch.gather(buf, -1, idx.expand(buf.shape)) + prior


def _syndrome_ok(v: torch.Tensor, layers: tuple) -> torch.Tensor:
    hard = (v < 0).to(torch.int32)
    bad = []
    for edges in layers:
        p = torch.roll(hard[edges[0][0]], -edges[0][1], dims=0)
        for c, s in edges[1:]:
            p = p ^ torch.roll(hard[c], -s, dims=0)
        bad.append(p)
    return torch.all(torch.all(torch.stack(bad) == 0, dim=0), dim=0)


def _sweep(v, c2v, layers, alpha, q):
    v = v.clone()
    new = []
    for li, edges in enumerate(layers):
        t = torch.stack([torch.roll(v[c], -s, dims=0)
                         for c, s in edges]) - c2v[li]
        at = torch.abs(t)
        sg = torch.where(t < 0.0, -1.0, 1.0)
        m1 = torch.amin(at, dim=0, keepdim=True)
        amin = torch.argmin(at, dim=0)
        is_min = (torch.arange(len(edges), device=v.device)[:, None, None]
                  == amin[None])
        m2 = torch.amin(torch.where(is_min, float("inf"), at), dim=0,
                        keepdim=True)
        mag = torch.where(is_min, m2, m1)
        upd = q(alpha * torch.prod(sg, dim=0, keepdim=True) * sg * mag)
        vn = q(t + upd)
        for e, (c, s) in enumerate(edges):
            v[c] = torch.roll(vn[e], s, dims=0)
        new.append(upd)
    return v, tuple(new)


def ldpc_decode(code, llr: torch.Tensor, max_iters: int, alpha: float,
                q=_same):
    """Layered normalized min-sum, per-codeword syndrome early exit:
    llr (N, n_mother) log P(1)/P(0) -> (posterior (N, n_mother),
    iterations (N,))."""
    layers = code.layers()
    n = llr.shape[0]
    v = -torch.movedim(llr.reshape(n, code.n_b, code.z).float(), 0, -1)
    c2v = tuple(torch.zeros((len(e),) + v.shape[1:], device=v.device)
                for e in layers)
    done = _syndrome_ok(v, layers)
    iters = torch.zeros(n, dtype=torch.int32, device=v.device)
    it = 0
    while it < max_iters and not bool(torch.all(done)):
        vn, c2vn = _sweep(v, c2v, layers, alpha, q)
        keep = done[None, None, :]
        v = torch.where(keep, v, vn)
        c2v = tuple(torch.where(keep, a, b) for a, b in zip(c2v, c2vn))
        iters = iters + torch.where(done, 0, 1).to(torch.int32)
        done = torch.logical_or(done, _syndrome_ok(v, layers))
        it += 1
    return -torch.movedim(v, -1, 0).reshape(n, -1), iters


def crc_ok(code, hard: torch.Tensor) -> torch.Tensor:
    """(..., k) hard bits -> (...,) True where the CRC holds."""
    info, crc = hard[..., : code.k_info], hard[..., code.k_info:]
    m = torch.from_numpy(crc_matrix(code.k_info, code.crc_bits).astype(
        np.float32)).to(hard.device)
    got = torch.remainder(info.to(torch.float32) @ m, 2.0).to(torch.int32)
    return torch.all(got == crc.to(torch.int32), dim=-1)


def decode(rung, cw_llr: torch.Tensor, decoder: dict, q=_same) -> dict:
    """(B, C, n_mother) combined LLRs -> ``crc_ok`` and the decoder's
    ``iters``, each (B, C)."""
    code = rung.code
    b, c, n = cw_llr.shape
    post, iters = ldpc_decode(code, cw_llr.reshape(b * c, n),
                              decoder["max_iters"], decoder["alpha"], q)
    hard = (post[:, : code.k] > 0).to(torch.int32)
    return {"crc_ok": crc_ok(code, hard).reshape(b, c),
            "iters": iters.reshape(b, c)}
