"""Frozen copy of the port's coded uplink slot generator
(``repro_torch.phy.coding.make_coded_slot`` and the OFDM and channel code
it calls), over :mod:`harness.spec`'s rungs.

It draws the same slots as the port did when it was copied, for the same
:class:`torch.Generator` state (``tests/test_portbench_traffic.py`` holds
it to the port at a shrunk grid).  It is the benchmark's radio: a later
change to the program's generator does not move the traffic.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from harness.spec import (Grid, Rung, data_re_index, pilot_masks_np,
                          pilot_sequence_np)

CRC16_POLY = 0x1021
N_RV = 4  # redundancy versions cycling the circular buffer


@functools.lru_cache(maxsize=None)
def crc_matrix(k_info: int, n_crc: int, poly: int = CRC16_POLY
               ) -> np.ndarray:
    """(k_info, n_crc) binary M with crc(bits) = bits @ M mod 2 (row i is
    the CRC of the unit message e_i; zero init, no xor-out)."""
    m = np.zeros((k_info, n_crc), np.int8)
    for i in range(k_info):
        reg = 0
        for j in range(k_info):
            bit = 1 if j == i else 0
            top = (reg >> (n_crc - 1)) & 1
            reg = (reg << 1) & ((1 << n_crc) - 1)
            if top ^ bit:
                reg ^= poly
        m[i] = [(reg >> (n_crc - 1 - b)) & 1 for b in range(n_crc)]
    return m


def crc_of(info: torch.Tensor, n_crc: int) -> torch.Tensor:
    m = torch.from_numpy(crc_matrix(info.shape[-1], n_crc).astype(
        np.float32)).to(info.device)
    return torch.remainder(info.to(torch.float32) @ m, 2.0).to(torch.int32)


def encode(code, bits: torch.Tensor) -> torch.Tensor:
    """Systematic QC-LDPC encode, (..., k) -> (..., n_mother): parity is
    the cumulative XOR of the block rows' systematic syndromes."""
    u = bits.reshape(bits.shape[:-1] + (code.k_b, code.z)).to(torch.int32)
    synd = []
    for edges in code.info_edges:
        s = torch.zeros(u.shape[:-2] + (code.z,), dtype=torch.int32,
                        device=u.device)
        for c, sh in edges:
            s = s + torch.roll(u[..., c, :], -sh, dims=-1)
        synd.append(s)
    p = torch.remainder(torch.cumsum(torch.stack(synd, dim=-2), dim=-2),
                        2).to(torch.int32)
    return torch.cat([u, p], dim=-2).reshape(bits.shape[:-1]
                                             + (code.n_mother,))


def rv_offset(code, rv):
    """Start offset (mother-code bits) of redundancy version ``rv``."""
    return ((rv % N_RV) * code.n_b) // N_RV * code.z


def rate_match(code, cw: torch.Tensor, rv: int = 0) -> torch.Tensor:
    off = int(rv_offset(code, rv))
    if off == 0:
        return cw[..., : code.e_bits]
    return torch.roll(cw, -off, dims=-1)[..., : code.e_bits]


def modulate(modem, bits: torch.Tensor) -> torch.Tensor:
    """bits (..., bits_per_symbol) -> unit-power gray-QAM symbols."""
    nb = modem.bits_per_axis
    lv = torch.tensor(modem.levels, dtype=torch.float32, device=bits.device)
    w = 2 ** torch.arange(nb - 1, -1, -1, device=bits.device)
    idx_re = torch.sum(bits[..., :nb].long() * w, dim=-1)
    idx_im = torch.sum(bits[..., nb:].long() * w, dim=-1)
    return torch.complex(lv[idx_re], lv[idx_im]) / math.sqrt(modem.norm)


def _pdp(g: Grid, device) -> torch.Tensor:
    pdp = torch.exp(-torch.arange(g.n_taps, dtype=torch.float32,
                                  device=device) / g.delay_spread)
    return pdp / torch.sum(pdp)


def _cnormal(gen: torch.Generator, shape) -> torch.Tensor:
    re = torch.randn(shape, generator=gen, device=gen.device)
    im = torch.randn(shape, generator=gen, device=gen.device)
    return torch.complex(re, im)


def tdl_channel(gen: torch.Generator, g: Grid, batch: int) -> torch.Tensor:
    """Rayleigh TDL -> frequency response (batch, n_rx, n_tx, n_sc)."""
    pdp = _pdp(g, gen.device)
    taps = _cnormal(gen, (batch, g.n_rx, g.n_tx, g.n_taps))
    taps = taps * torch.sqrt(pdp / 2.0)
    return torch.fft.fft(taps, n=g.fft_size, dim=-1)[..., : g.n_subcarriers]


def tdl_channel_time_varying(gen: torch.Generator, g: Grid, batch: int,
                             n_steps: int, rho: float) -> torch.Tensor:
    """Gauss-Markov per-symbol taps: (batch, n_steps, n_rx, n_tx, n_sc)."""
    pdp_amp = torch.sqrt(_pdp(g, gen.device) / 2.0)
    shape = (batch, g.n_rx, g.n_tx, g.n_taps)
    taps = [_cnormal(gen, shape) * pdp_amp]
    innov = _cnormal(gen, (n_steps - 1,) + shape) * pdp_amp
    for w in innov:
        taps.append(rho * taps[-1] + math.sqrt(1.0 - rho ** 2) * w)
    h = torch.fft.fft(torch.stack(taps, dim=1), n=g.fft_size, dim=-1)
    return h[..., : g.n_subcarriers]


def make_link_slot(gen: torch.Generator, rung: Rung, batch: int,
                   bits: torch.Tensor) -> dict:
    """The radio: modulate ``bits`` (B, n_sym, n_sc, n_tx, nb), embed the
    DMRS, pass a Rayleigh TDL channel (per-stream gains, co-channel QPSK
    interferers) and AWGN, and return the unified slot schema."""
    g, modem, dev = rung.grid, rung.modem, gen.device
    x = modulate(modem, bits)
    pm_tx = torch.from_numpy(pilot_masks_np(g)).to(dev)
    union = torch.any(pm_tx, dim=0)
    seq = torch.from_numpy(pilot_sequence_np(g)).to(dev)
    pm_grid = torch.movedim(pm_tx, 0, -1)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    x = torch.where(pm_grid[None], seq[None, None, :, None],
                    torch.where(union[None, ..., None], zero, x))
    if rung.doppler_rho < 1.0:
        h = tdl_channel_time_varying(gen, g, batch, g.n_symbols,
                                     rung.doppler_rho)
    else:
        h = tdl_channel(gen, g, batch)[:, None]
    h = torch.movedim(h, -1, 2)  # (B, T, n_sc, n_rx, n_tx)
    if rung.user_power_db is not None:
        h = h * torch.tensor([10.0 ** (p / 20.0) for p in rung.user_power_db],
                             dtype=torch.float32, device=dev)
    hb = h.expand(batch, g.n_symbols, *h.shape[2:])
    y = torch.einsum("bmsrt,bmst->bmsr", hb, x)
    snr = 10.0 ** (rung.snr_db / 10.0)
    noise_var = g.n_tx / snr
    if rung.interferer_db:
        icfg = dataclasses.replace(g, n_tx=1)
        for p_db in rung.interferer_db:
            if rung.doppler_rho < 1.0:
                hi = tdl_channel_time_varying(gen, icfg, batch, g.n_symbols,
                                              rung.doppler_rho)
            else:
                hi = tdl_channel(gen, icfg, batch)[:, None]
            hi = torch.movedim(hi, -1, 2)
            hib = hi.expand(batch, g.n_symbols, *hi.shape[2:])
            qi = torch.randint(0, 4, (batch, g.n_symbols, g.n_subcarriers),
                               generator=gen, device=dev)
            si = torch.exp(1j * (math.pi / 4 + math.pi / 2 * qi.float()))
            y = y + 10.0 ** (p_db / 20.0) * hib[..., 0] * si[..., None]
        noise_var = noise_var + sum(10.0 ** (p / 10.0)
                                    for p in rung.interferer_db)
    y = y + _cnormal(gen, y.shape) * math.sqrt(g.n_tx / snr / 2.0)
    return {
        "y_time": torch.fft.ifft(y, dim=2), "y": y, "x": x, "h": h,
        "bits": bits,
        "noise_var": torch.tensor(noise_var, dtype=torch.float32,
                                  device=dev),
        "pilot_seq": seq, "pilot_masks": pm_tx, "data_mask": ~union,
    }


def make_coded_slot(gen: torch.Generator, rung: Rung, batch: int,
                    rv=None, info=None) -> dict:
    """``batch`` coded slots of ``rung`` on ``gen``'s device: payloads
    (drawn, or ``info`` (B, C, k_info) re-sent), CRC, LDPC encode, rate
    match at ``rv``, laid on the data REs symbol-major (random filler
    after the last codeword), then :func:`make_link_slot`.  Adds
    ``info_bits`` and, for a non-None ``rv``, ``rv`` (B,)."""
    code, g, dev = rung.code, rung.grid, gen.device
    nb = rung.modem.bits_per_symbol
    c = rung.codewords_per_slot
    if c < 1:
        raise ValueError(f"{rung.name}: no whole codeword fits a slot")
    if info is None:
        info = torch.randint(0, 2, (batch, c, code.k_info), generator=gen,
                             device=dev, dtype=torch.int32)
    else:
        info = torch.as_tensor(info, device=dev).to(torch.int32)
        if tuple(info.shape) != (batch, c, code.k_info):
            raise ValueError(f"info shape {tuple(info.shape)} != "
                             f"{(batch, c, code.k_info)}")
    crc = torch.cat([info.to(torch.int32), crc_of(info, code.crc_bits)],
                    dim=-1)
    tx = rate_match(code, encode(code, crc), rv=rv or 0)
    flat = tx.reshape(batch, c * code.e_bits)
    n_fill = rung.data_bits_per_slot - c * code.e_bits
    if n_fill:
        filler = torch.randint(0, 2, (batch, n_fill), generator=gen,
                               device=dev, dtype=torch.int32)
        flat = torch.cat([flat, filler], dim=-1)
    sym, sc = (torch.from_numpy(a).to(dev) for a in data_re_index(g))
    bits = torch.zeros((batch, g.n_symbols, g.n_subcarriers, g.n_tx, nb),
                       dtype=torch.int32, device=dev)
    bits[:, sym, sc] = flat.reshape(batch, len(sym), g.n_tx, nb)
    slot = make_link_slot(gen, rung, batch, bits)
    slot["info_bits"] = info
    if rv is not None:
        slot["rv"] = torch.full((batch,), int(rv), dtype=torch.int32,
                                device=dev)
    return slot
