"""Channel-coding chain (port of :mod:`repro.phy.coding`).

CRC-16 as a GF(2) matrix product, the base-graph-lite QC-LDPC code with a
dual-diagonal parity part (encode is a cumulative XOR), circular-buffer
rate matching with redundancy versions, de-rate-matching with HARQ prior
accumulation, and the coded slot generator that lays codewords onto the
data REs in canonical order.

The static structure (CRC matrix, protograph, data-RE order) is built with
numpy exactly as the reference builds it, so both packages agree on every
codeword bit.  The decoder itself is :mod:`repro_torch.kernels.ldpc`.

CRC products run in float32: each sum counts at most ``k_info`` ones, far
below 2**24, so the float product is exact and ``mod 2`` recovers GF(2)
(PyTorch has no integer matmul on CUDA).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.phy import ofdm

# CRC-16-CCITT generator polynomial (x^16 + x^12 + x^5 + 1), MSB-first
CRC16_POLY = 0x1021
CRC_BITS = 16


# ---------------------------------------------------------------------------
# CRC over GF(2) as a matrix product
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def crc_matrix(k_info: int, poly: int = CRC16_POLY,
               n_crc: int = CRC_BITS) -> np.ndarray:
    """(k_info, n_crc) binary matrix M with crc(bits) = bits @ M mod 2.

    Row i is the CRC of the unit message e_i (zero-init, no xor-out).
    """
    m = np.zeros((k_info, n_crc), np.int8)
    for i in range(k_info):
        reg = 0
        for j in range(k_info):
            bit = 1 if j == i else 0
            top = (reg >> (n_crc - 1)) & 1
            reg = ((reg << 1) & ((1 << n_crc) - 1)) | 0
            if top ^ bit:
                reg ^= poly
        m[i] = [(reg >> (n_crc - 1 - b)) & 1 for b in range(n_crc)]
    return m


@functools.lru_cache(maxsize=None)
def _crc_matrix_on(k_info: int, n_crc: int,
                   device: torch.device) -> torch.Tensor:
    """:func:`crc_matrix` as float32 on ``device``, built once per device
    (a captured step copies nothing from the host)."""
    return torch.from_numpy(
        crc_matrix(k_info, n_crc=n_crc).astype(np.float32)).to(device)


def _crc_of(info: torch.Tensor, n_crc: int) -> torch.Tensor:
    m = _crc_matrix_on(info.shape[-1], n_crc, info.device)
    return torch.remainder(info.to(torch.float32) @ m, 2.0).to(torch.int32)


def crc_attach(info: torch.Tensor, n_crc: int = CRC_BITS) -> torch.Tensor:
    """info (..., k_info) int bits -> (..., k_info + n_crc) with CRC."""
    return torch.cat([info.to(torch.int32), _crc_of(info, n_crc)], dim=-1)


def crc_check(bits: torch.Tensor, n_crc: int = CRC_BITS) -> torch.Tensor:
    """bits (..., k_info + n_crc) -> (...,) bool, True when the CRC holds."""
    info, crc = bits[..., :-n_crc], bits[..., -n_crc:]
    return torch.all(_crc_of(info, n_crc) == crc.to(torch.int32), dim=-1)


# ---------------------------------------------------------------------------
# Base-graph-lite QC-LDPC code
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodeConfig:
    """One rate point of the base-graph-lite QC-LDPC code: ``k_b``
    systematic and ``m_b`` parity block columns lifted by circulant size
    ``z``; ``info_edges[j]`` lists block row ``j``'s systematic
    ``(block_col, shift)`` circulants; the parity part is dual-diagonal.
    Rate matching transmits the systematic bits plus ``p_tx_b`` parity
    blocks."""
    name: str
    z: int
    k_b: int
    m_b: int
    p_tx_b: int
    info_edges: tuple  # per block-row: ((col, shift), ...)
    crc_bits: int = CRC_BITS

    @property
    def n_b(self) -> int:
        return self.k_b + self.m_b

    @property
    def k(self) -> int:
        """Systematic bits per codeword (CRC included)."""
        return self.k_b * self.z

    @property
    def k_info(self) -> int:
        """Payload bits per codeword (CRC excluded)."""
        return self.k - self.crc_bits

    @property
    def n_mother(self) -> int:
        return self.n_b * self.z

    @property
    def e_bits(self) -> int:
        """Transmitted (rate-matched) bits per codeword."""
        return (self.k_b + self.p_tx_b) * self.z

    @property
    def rate(self) -> float:
        return self.k / self.e_bits

    def layers(self) -> tuple:
        """Per block-row edge lists ((col, shift), ...) including the
        dual-diagonal parity circulants: the layered decoder's schedule."""
        out = []
        for j in range(self.m_b):
            edges = list(self.info_edges[j])
            if j > 0:
                edges.append((self.k_b + j - 1, 0))
            edges.append((self.k_b + j, 0))
            out.append(tuple(edges))
        return tuple(out)

    def punctured_blocks(self) -> tuple:
        """Block columns whose bits are never transmitted (zero LLRs)."""
        return tuple(range(self.k_b + self.p_tx_b, self.n_b))


def _make_info_edges(k_b: int, m_b: int, z: int, col_degree: int,
                     seed: int) -> tuple:
    """Deterministic pseudo-random protograph for the systematic part
    (balanced row degrees, no repeated (row, col) pair)."""
    rng = np.random.default_rng(seed)
    rows_of = [[] for _ in range(m_b)]
    for c in range(k_b):
        order = sorted(range(m_b),
                       key=lambda r: (len(rows_of[r]), rng.random()))
        for r in order[:col_degree]:
            rows_of[r].append((c, int(rng.integers(z))))
    return tuple(tuple(sorted(edges)) for edges in rows_of)


@functools.lru_cache(maxsize=None)
def make_code(rate: str = "r12", z: int = 32, k_b: int = 12,
              col_degree: int = 3, seed: int = 7) -> CodeConfig:
    """One rate point: ``"r12"`` transmits the full rate-1/2 mother;
    ``"r34"`` punctures a rate-2/3 mother's last two parity blocks."""
    m_b, p_tx = {
        "r12": (k_b, k_b),
        "r34": (k_b // 2, k_b // 3),
    }[rate]
    if not 0 < p_tx <= m_b:
        raise ValueError(f"bad rate point {rate}: p_tx={p_tx}, m_b={m_b}")
    edges = _make_info_edges(k_b, m_b, z, col_degree, seed)
    return CodeConfig(
        name=f"bg-lite-{rate}-z{z}", z=z, k_b=k_b, m_b=m_b, p_tx_b=p_tx,
        info_edges=edges,
    )


def dense_parity_matrix(code: CodeConfig) -> np.ndarray:
    """Expand the lifted graph to the dense (m_b*z, n_b*z) binary H, int8
    (a test and oracle helper, never on the hot path)."""
    z = code.z
    h = np.zeros((code.m_b * z, code.n_b * z), np.int8)
    r = np.arange(z)
    for j, edges in enumerate(code.layers()):
        for c, s in edges:
            h[j * z + r, c * z + (r + s) % z] = 1
    return h


# ---------------------------------------------------------------------------
# Encode / rate matching
# ---------------------------------------------------------------------------

def _rot(u: torch.Tensor, s: int) -> torch.Tensor:
    """Shift-``s`` circulant: row r of the block picks bit (r + s) mod z."""
    return torch.roll(u, -s, dims=-1)


def encode(code: CodeConfig, bits: torch.Tensor) -> torch.Tensor:
    """Systematic QC-LDPC encode.  bits (..., k) -> codeword (..., n_mother).
    Parity is the cumulative XOR of the block rows' systematic syndromes."""
    if bits.shape[-1] != code.k:
        raise ValueError(f"bits {tuple(bits.shape)} do not end in k={code.k}")
    u = bits.reshape(bits.shape[:-1] + (code.k_b, code.z)).to(torch.int32)
    synd = []
    for edges in code.info_edges:
        s = torch.zeros(u.shape[:-2] + (code.z,), dtype=torch.int32,
                        device=u.device)
        for c, sh in edges:
            s = s + _rot(u[..., c, :], sh)
        synd.append(s)
    s = torch.stack(synd, dim=-2)  # (..., m_b, z)
    p = torch.remainder(torch.cumsum(s, dim=-2), 2).to(torch.int32)
    cw = torch.cat([u, p], dim=-2)
    return cw.reshape(bits.shape[:-1] + (code.n_mother,))


N_RV = 4  # redundancy versions cycling the circular buffer (5G-style)


def rv_offset(code: CodeConfig, rv):
    """Start offset (mother-code bits) of redundancy version ``rv`` (an int
    or an int tensor of per-codeword RVs)."""
    return ((rv % N_RV) * code.n_b) // N_RV * code.z


def rate_match(code: CodeConfig, cw: torch.Tensor,
               rv: int = 0) -> torch.Tensor:
    """codeword (..., n_mother) -> transmitted bits (..., e_bits): the
    circular-buffer window starting at :func:`rv_offset`."""
    off = int(rv_offset(code, rv))
    if off == 0:
        return cw[..., : code.e_bits]
    return torch.roll(cw, -off, dims=-1)[..., : code.e_bits]


def derate_match(code: CodeConfig, llr_e: torch.Tensor, rv=None,
                 prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Received LLRs (..., e_bits) -> mother-code LLRs (..., n_mother).

    Scatters the window back to its circular-buffer positions (zero LLRs
    on untransmitted bits), then adds ``prior`` (the combined channel LLRs
    of earlier HARQ rounds).  ``rv`` is an int (static window) or an int
    tensor of leading batch shape (per-codeword RVs, one gather).
    """
    pad = code.n_mother - code.e_bits
    buf = llr_e.to(torch.float32)
    if pad:
        zeros = torch.zeros(llr_e.shape[:-1] + (pad,), dtype=torch.float32,
                            device=buf.device)
        buf = torch.cat([buf, zeros], dim=-1)
    if isinstance(rv, int):
        off = int(rv_offset(code, rv))
        if off:
            buf = torch.roll(buf, off, dims=-1)
    elif rv is not None:
        # mother bit i of codeword b was received at window position
        # (i - off[b]) mod n (the zero pad covers the untransmitted tail)
        n = code.n_mother
        off = rv_offset(code, torch.as_tensor(rv, device=buf.device).long())
        off = off.reshape(off.shape + (1,) * (buf.ndim - off.ndim))
        idx = torch.remainder(
            torch.arange(n, device=buf.device) - off, n
        )
        buf = torch.gather(buf, -1, idx.expand(buf.shape))
    if prior is not None:
        buf = buf + torch.as_tensor(prior, device=buf.device).to(torch.float32)
    return buf


# ---------------------------------------------------------------------------
# Mapping codewords onto the OFDM grid
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _data_re_index(grid: ofdm.GridConfig):
    """Static (sym_idx, sc_idx) arrays of the data REs in canonical
    (symbol-major, subcarrier-minor) order."""
    union = ofdm.link_pilot_masks_np(grid).any(axis=0)
    return np.nonzero(~union)


@functools.lru_cache(maxsize=None)
def _data_re_index_t(grid: ofdm.GridConfig, device: torch.device):
    sym, sc = _data_re_index(grid)
    return (torch.from_numpy(sym).to(device),
            torch.from_numpy(sc).to(device))


def codewords_per_slot(scenario) -> int:
    """Whole codewords that fit a slot's data REs (rest is filler)."""
    return scenario.data_bits_per_slot // scenario.code.e_bits


def info_bits_per_slot(scenario) -> int:
    """Payload (post-CRC) bits per slot: the goodput numerator."""
    return codewords_per_slot(scenario) * scenario.code.k_info


def goodput_bits(scenario, bler: float, n_slots: int) -> float:
    """Delivered payload bits for ``n_slots`` slots at block error
    ``bler``."""
    return (1.0 - bler) * info_bits_per_slot(scenario) * n_slots


def make_coded_slot(gen: torch.Generator, scenario, batch: int,
                    rv: Optional[int] = None, info=None) -> dict:
    """Simulate one coded uplink slot batch of ``scenario`` on ``gen``'s
    device: per-slot transport blocks, CRC, LDPC encode and rate match,
    laid onto the data REs in canonical order (trailing REs carry random
    filler), then the channel/noise simulation.  Adds ``info_bits``
    (B, C, k_info); ``info`` re-transmits fixed blocks and a non-None
    ``rv`` picks the redundancy version and stamps ``rv`` (B,)."""
    code, g = scenario.code, scenario.grid
    dev = gen.device
    nb = scenario.modem.bits_per_symbol
    c = codewords_per_slot(scenario)
    if c < 1:
        raise ValueError(
            f"{scenario.name}: e_bits={code.e_bits} exceeds the slot's "
            f"{scenario.data_bits_per_slot} data bits"
        )
    if info is None:
        info = torch.randint(0, 2, (batch, c, code.k_info), generator=gen,
                             device=dev, dtype=torch.int32)
    else:
        info = torch.as_tensor(info, device=dev).to(torch.int32)
        if tuple(info.shape) != (batch, c, code.k_info):
            raise ValueError(f"info shape {tuple(info.shape)} != "
                             f"{(batch, c, code.k_info)}")
    tx = rate_match(code, encode(code, crc_attach(info, code.crc_bits)),
                    rv=rv or 0)
    flat = tx.reshape(batch, c * code.e_bits)
    n_fill = scenario.data_bits_per_slot - c * code.e_bits
    if n_fill:
        filler = torch.randint(0, 2, (batch, n_fill), generator=gen,
                               device=dev, dtype=torch.int32)
        flat = torch.cat([flat, filler], dim=-1)

    sym_idx, sc_idx = _data_re_index_t(g, dev)
    bits_data = flat.reshape(batch, len(sym_idx), g.n_tx, nb)
    bits = torch.zeros((batch, g.n_symbols, g.n_subcarriers, g.n_tx, nb),
                       dtype=torch.int32, device=dev)
    bits[:, sym_idx, sc_idx] = bits_data

    slot = ofdm.make_link_slot(
        gen, g, scenario.modem, batch, scenario.snr_db,
        doppler_rho=scenario.doppler_rho, bits=bits,
        interferer_db=scenario.interferer_db,
        user_power_db=scenario.user_power_db,
    )
    slot["info_bits"] = info
    if rv is not None:
        slot["rv"] = torch.full((batch,), int(rv), dtype=torch.int32,
                                device=dev)
    return slot


def coded_llrs(scenario, llr: torch.Tensor) -> torch.Tensor:
    """llr (B, n_sym, n_sc, n_tx, nb) -> (B, C, e_bits): the per-codeword
    transmitted-bit LLRs gathered back off the grid (filler dropped)."""
    c = codewords_per_slot(scenario)
    e = scenario.code.e_bits
    sym_idx, sc_idx = _data_re_index_t(scenario.grid, llr.device)
    data = llr[:, sym_idx, sc_idx]  # (B, n_data, n_tx, nb)
    return data.reshape(llr.shape[0], -1)[:, : c * e].reshape(
        llr.shape[0], c, e
    )


def decode_blocks(scenario, llr: torch.Tensor, *, max_iters: int = 12,
                  alpha: float = 0.8, rv=None,
                  prior_llr: Optional[torch.Tensor] = None,
                  precision: Optional[str] = None) -> dict:
    """Receive-side coding chain on a detector state's LLRs: de-rate-match
    (+ HARQ prior), layered min-sum decode (the saturating int8 datapath
    for ``precision="int8"|"fp8"``), CRC check.

    Returns ``info_bits_hat`` (B, C, k_info), ``crc_ok`` (B, C),
    ``decode_iters`` (B, C) and ``cw_llr`` (B, C, n_mother), the combined
    channel LLR buffer a HARQ process stores.
    """
    from repro_torch.kernels import ldpc

    code = scenario.code
    cw_llr = derate_match(code, coded_llrs(scenario, llr), rv=rv,
                          prior=prior_llr)  # (B, C, n)
    b, c, n = cw_llr.shape
    post, iters = ldpc.ldpc_decode(
        cw_llr.reshape(b * c, n), code, max_iters=max_iters, alpha=alpha,
        precision=precision,
    )
    hard = (post[:, : code.k] > 0).to(torch.int32)
    ok = crc_check(hard, code.crc_bits)
    return {
        "info_bits_hat": hard[:, : code.k_info].reshape(b, c, code.k_info),
        "crc_ok": ok.reshape(b, c),
        "decode_iters": iters.reshape(b, c),
        "cw_llr": cw_llr,
    }
