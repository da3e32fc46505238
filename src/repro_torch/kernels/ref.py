"""Plain oracles of every kernel (port of :mod:`repro.kernels.ref`).

The compute blocks' (``te_gemm_ref``, ``mha_ref``, ``fc_softmax_ref``,
``dwconv_block_ref``) compute the whole function in fp32 with no tiling
and cast once to the input's dtype.  The PHY kernels' compose the unfused
production path instead, as the reference's do: ``mmse_detect_demap_ref``
and ``sic_detect_demap_ref`` the batched linalg-solve detector
(:func:`repro_torch.phy.classical.mimo_mmse_detect_ext`) and the modem's
max-log demapper, ``ls_che_ref`` the staggered-comb LS estimate with
clamped interpolation (:func:`~repro_torch.phy.classical.
ls_channel_estimate_link`), and ``ldpc_decode_ref`` is a per-codeword
numpy loop independent of the batched core.  The tests and
``chip_smoke.py`` hold the kernels and their twins to them.  (Lazy
imports: :mod:`repro_torch.phy` imports this package at module load.)"""
from __future__ import annotations

import numpy as np
import torch


def te_gemm_ref(x, w, bias=None, epilogue: str = "none"):
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


def mha_ref(q, k, v, causal: bool = True):
    """q, k, v: (BH, S, D)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * (d ** -0.5)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def fc_softmax_ref(x, w, bias=None):
    z = x.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        z = z + bias.to(torch.float32)
    return torch.softmax(z, dim=-1).to(x.dtype)


def dwconv_block_ref(x_padded, dw, pw, gamma, beta, eps: float = 1e-5):
    """x_padded: (B, H+2, W+2, C); returns (B, H, W, F)."""
    b, hp, wp, c = x_padded.shape
    h, w = hp - 2, wp - 2
    xf = x_padded.to(torch.float32)
    dwf = dw.to(torch.float32)
    y = torch.zeros((b, h, w, c), dtype=torch.float32,
                    device=x_padded.device)
    for di in range(3):
        for dj in range(3):
            y = y + xf[:, di: di + h, dj: dj + w, :] * dwf[di, dj]
    z = torch.einsum("bhwc,cf->bhwf", y, pw.to(torch.float32))
    mu = torch.mean(z, dim=-1, keepdim=True)
    var = torch.mean(torch.square(z - mu), dim=-1, keepdim=True)
    z = (z - mu) * torch.rsqrt(var + eps)
    z = z * gamma.to(torch.float32) + beta.to(torch.float32)
    return torch.clamp_min(z, 0.0).to(x_padded.dtype)


def _per_symbol(y, h):
    """y (B, n_sym, n_sc, n_rx) as (B * n_sym, n_sc, n_rx) rows and h
    (B, n_sc, n_rx, n_tx) broadcast over the symbols to match."""
    b, n_sym, n_sc, n_rx = y.shape
    n_tx = h.shape[-1]
    hb = torch.broadcast_to(
        h[:, None], (b, n_sym, n_sc, n_rx, n_tx)
    ).reshape(b * n_sym, n_sc, n_rx, n_tx)
    return y.reshape(b * n_sym, n_sc, n_rx), hb


def mmse_detect_demap_ref(y, h, noise_var, modem):
    """Unfused oracle for the fused equalize -> demap kernel: the
    production linalg-solve detector + the modem's max-log demapper,
    composed.

    y (B, n_sym, n_sc, n_rx), h (B, n_sc, n_rx, n_tx); returns
    (x_hat, nv_eff, llr) with the fused kernel's shapes.
    """
    from repro_torch.phy.classical import mimo_mmse_detect_ext

    b, n_sym, n_sc, _ = y.shape
    n_tx = h.shape[-1]
    yr, hb = _per_symbol(y, h)
    x_hat, nv_eff = mimo_mmse_detect_ext(yr, hb, noise_var)
    x_hat = x_hat.reshape(b, n_sym, n_sc, n_tx)
    nv_eff = nv_eff.reshape(b, n_sym, n_sc, n_tx)
    return x_hat, nv_eff, modem.demod_llr(x_hat, nv_eff)


def sic_detect_demap_ref(y, h, noise_var, modem):
    """Unfused oracle for the fused SIC equalize -> demap kernel: stage
    ``k`` demaps stream ``k`` from the MMSE solve over the not-yet-cancelled
    suffix, hard-remodulates it, and subtracts its reconstructed
    contribution before the next stage.

    y (B, n_sym, n_sc, n_rx), h (B, n_sc, n_rx, n_tx); returns
    (x_hat, nv_eff, llr) with the fused kernel's shapes (llr
    (B, n_sym, n_sc, n_tx, bits_per_symbol)).
    """
    from repro_torch.phy.classical import mimo_mmse_detect_ext

    b, n_sym, n_sc, _ = y.shape
    n_tx = h.shape[-1]
    y_res, hb = _per_symbol(y, h)
    xs, nvs, llrs = [], [], []
    for k in range(n_tx):
        x_all, nv_all = mimo_mmse_detect_ext(y_res, hb[..., k:], noise_var)
        x_k, nv_k = x_all[..., 0], nv_all[..., 0]
        llr_k = modem.demod_llr(x_k, nv_k)
        xs.append(x_k)
        nvs.append(nv_k)
        llrs.append(llr_k)
        if k < n_tx - 1:
            hard = (llr_k > 0).to(torch.int32)
            y_res = y_res - hb[..., k] * modem.mod(hard)[..., None]
    x_hat = torch.stack(xs, dim=-1).reshape(b, n_sym, n_sc, n_tx)
    nv_eff = torch.stack(nvs, dim=-1).reshape(b, n_sym, n_sc, n_tx)
    llr = torch.stack(llrs, dim=-2).reshape(
        b, n_sym, n_sc, n_tx, modem.bits_per_symbol
    )
    return x_hat, nv_eff, llr


def ls_che_ref(y, pilot_seq, pilot_masks, pilot_stride: int):
    """Mask-and-interp oracle for the fused LS-CHE kernel: the production
    per-(rx, tx) staggered-comb LS + clamped linear interpolation."""
    from repro_torch.phy.classical import ls_channel_estimate_link

    return ls_channel_estimate_link(y, pilot_seq, pilot_masks, pilot_stride)


def ldpc_decode_ref(llr, code, max_iters: int = 12, alpha: float = 0.8):
    """Per-codeword numpy oracle for the layered min-sum LDPC decoder.

    Independent of the batched core: plain per-layer loops, exact
    min-excluding-self per edge, syndrome early exit at the top of each
    iteration.  llr (B, n_mother) in the repo's log P(1)/P(0) convention
    (a tensor on any device, or an array); returns (posterior LLRs,
    per-codeword iteration counts) as tensors on ``llr``'s device (the
    CPU for an array).
    """
    device = llr.device if isinstance(llr, torch.Tensor) else "cpu"
    if isinstance(llr, torch.Tensor):
        llr = llr.detach().cpu().numpy()
    layers = code.layers()
    z = code.z
    llr = np.asarray(llr, np.float32)
    out = np.empty_like(llr)
    iters_out = np.zeros(llr.shape[0], np.int32)

    def syndrome_ok(v):
        hard = (v < 0).astype(np.int32)
        for edges in layers:
            p = np.zeros(z, np.int32)
            for c, s in edges:
                p ^= np.roll(hard[c], -s)
            if p.any():
                return False
        return True

    for b in range(llr.shape[0]):
        v = -llr[b].reshape(code.n_b, z).copy()
        c2v = [np.zeros((len(e), z), np.float32) for e in layers]
        n_it = 0
        for _ in range(max_iters):
            if syndrome_ok(v):
                break
            for li, edges in enumerate(layers):
                t = np.stack(
                    [np.roll(v[c], -s) for c, s in edges]
                ) - c2v[li]
                at = np.abs(t)
                mag = np.empty_like(at)
                for e in range(len(edges)):
                    mag[e] = np.delete(at, e, axis=0).min(axis=0)
                sg = np.where(t < 0.0, -1.0, 1.0).astype(np.float32)
                upd = (alpha * np.prod(sg, axis=0) * sg * mag).astype(
                    np.float32
                )
                vn = t + upd
                for e, (c, s) in enumerate(edges):
                    v[c] = np.roll(vn[e], s)
                c2v[li] = upd
            n_it += 1
        out[b] = -v.reshape(-1)
        iters_out[b] = n_it
    return (torch.from_numpy(out).to(device),
            torch.from_numpy(iters_out).to(device))
