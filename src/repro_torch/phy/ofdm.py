"""OFDM uplink simulation substrate (port of :mod:`repro.phy.ofdm`).

Resource grid, gray-coded square-QAM modems (QPSK/16/64/256-QAM), Rayleigh
TDL channel with exponential power delay profile (optionally time-varying
for Doppler scenarios) and AWGN: everything needed to generate uplink
slots of the unified link schema, SISO through MIMO.

Random draws take an explicit :class:`torch.Generator`; the slot lands on
that generator's device.  Torch cannot replay ``jax.random`` streams, so a
reference slot enters the port through :func:`slot_from_numpy`, and the
port's own generator is held to the reference statistically.  The static
geometry (pilot sequence and masks) is built with numpy and is identical to
the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GridConfig:
    n_subcarriers: int = 512  # frequency bins (REs per symbol)
    n_symbols: int = 14  # OFDM symbols per slot (one TTI)
    pilot_stride: int = 4  # pilot every k-th subcarrier
    pilot_symbols: tuple = (2, 11)  # DMRS symbol positions
    n_tx: int = 1
    n_rx: int = 1
    fft_size: int = 512
    n_taps: int = 8  # channel delay taps
    delay_spread: float = 2.0  # exponential PDP decay (in taps)


def make_generator(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A seeded generator on ``device`` (None -> CUDA)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


# ---------------------------------------------------------------------------
# Constellation-parameterized modem (gray-coded square QAM)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Modem:
    """Gray-coded square-QAM modem.

    ``levels[j]`` is the per-axis amplitude for the axis-bit integer ``j``
    (MSB first).  Bits are laid out (..., bits_per_symbol) with the first
    half on the real axis, the second half on the imaginary axis.
    """
    name: str
    bits_per_symbol: int
    levels: tuple  # indexed by the bit-int of one axis
    norm: float  # mean symbol energy of the un-normalized grid

    @property
    def bits_per_axis(self) -> int:
        return self.bits_per_symbol // 2

    def mod(self, bits: torch.Tensor) -> torch.Tensor:
        """bits (..., bits_per_symbol) -> unit-power complex symbols."""
        nb = self.bits_per_axis
        lv, _, _ = _modem_tables(self.levels, nb, bits.device)
        w = 2 ** torch.arange(nb - 1, -1, -1, device=bits.device)
        idx_re = torch.sum(bits[..., :nb].long() * w, dim=-1)
        idx_im = torch.sum(bits[..., nb:].long() * w, dim=-1)
        return torch.complex(lv[idx_re], lv[idx_im]) / math.sqrt(self.norm)

    def demod_llr(self, y: torch.Tensor,
                  noise_var: torch.Tensor) -> torch.Tensor:
        """Max-log LLRs. y (...,) complex -> (..., bits_per_symbol).

        Convention: llr = log P(b=1)/P(b=0); hard decision is ``llr > 0``.
        ``noise_var`` broadcasts against ``y`` (scalar or per-element).
        """
        nb = self.bits_per_axis
        lv, bit_of, inf = _modem_tables(self.levels, nb, y.device)
        s = float(np.sqrt(np.float32(self.norm)))
        nv = torch.clamp(
            torch.broadcast_to(
                torch.as_tensor(noise_var, device=y.device), y.shape
            ) * self.norm,
            min=1e-6,
        )

        def axis_llrs(u):
            d = (u[..., None] - lv) ** 2  # (..., L)
            out = []
            for p in range(nb):
                one = bit_of[p]
                d0 = torch.amin(torch.where(one, inf, d), dim=-1)
                d1 = torch.amin(torch.where(one, d, inf), dim=-1)
                out.append(d0 - d1)
            return out

        llrs = axis_llrs(y.real * s) + axis_llrs(y.imag * s)
        return torch.stack(llrs, dim=-1) / nv[..., None]


@functools.lru_cache(maxsize=None)
def _modem_tables(levels: tuple, nb: int, device: torch.device) -> tuple:
    """A modem's constant tensors on ``device``, built once per device (a
    captured step copies nothing from the host): the levels (L,) float32,
    ``bit_of`` (nb, L) bool (bit p, MSB first, of the level index) and
    +inf."""
    lv = torch.tensor(levels, dtype=torch.float32, device=device)
    bit_of = torch.tensor(
        [[(j >> (nb - 1 - p)) & 1 for j in range(len(levels))]
         for p in range(nb)], dtype=torch.bool, device=device,
    )
    inf = torch.tensor(float("inf"), device=device)
    return lv, bit_of, inf


_MODEMS = {
    "qpsk": Modem("qpsk", 2, (-1.0, 1.0), 2.0),
    "qam16": Modem("qam16", 4, (-3.0, -1.0, 3.0, 1.0), 10.0),
    "qam64": Modem(
        "qam64", 6, (-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0), 42.0
    ),
    # levels[gray(k)] = 2k - 15: binary-reflected gray over 16 amplitudes
    "qam256": Modem(
        "qam256", 8,
        (-15.0, -13.0, -9.0, -11.0, -1.0, -3.0, -7.0, -5.0,
         15.0, 13.0, 9.0, 11.0, 1.0, 3.0, 7.0, 5.0), 170.0
    ),
}
_ORDER_TO_NAME = {4: "qpsk", 16: "qam16", 64: "qam64", 256: "qam256"}


def make_modem(modulation) -> Modem:
    """Look up a modem by name or order (4/16/64/256)."""
    if isinstance(modulation, Modem):
        return modulation
    if isinstance(modulation, int):
        modulation = _ORDER_TO_NAME[modulation]
    return _MODEMS[modulation]


def qam16_mod(bits: torch.Tensor) -> torch.Tensor:
    """bits: (..., 4) -> complex symbol (gray-coded 16-QAM, unit power)."""
    return _MODEMS["qam16"].mod(bits)


def qam16_demod_llr(y: torch.Tensor, noise_var) -> torch.Tensor:
    """Max-log LLRs for gray 16-QAM. y: (...,) complex -> (..., 4)."""
    return _MODEMS["qam16"].demod_llr(y, noise_var)


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------

def _pdp(cfg: GridConfig, device) -> torch.Tensor:
    pdp = torch.exp(
        -torch.arange(cfg.n_taps, dtype=torch.float32, device=device)
        / cfg.delay_spread
    )
    return pdp / torch.sum(pdp)


def _cnormal(gen: torch.Generator, shape) -> torch.Tensor:
    re = torch.randn(shape, generator=gen, device=gen.device)
    im = torch.randn(shape, generator=gen, device=gen.device)
    return torch.complex(re, im)


def tdl_channel(gen: torch.Generator, cfg: GridConfig,
                batch: int) -> torch.Tensor:
    """Rayleigh TDL -> frequency response H (batch, n_rx, n_tx, n_sc)."""
    pdp = _pdp(cfg, gen.device)
    taps = _cnormal(gen, (batch, cfg.n_rx, cfg.n_tx, cfg.n_taps))
    taps = taps * torch.sqrt(pdp / 2.0)
    h = torch.fft.fft(taps, n=cfg.fft_size, dim=-1)
    return h[..., : cfg.n_subcarriers]


def tdl_channel_time_varying(gen: torch.Generator, cfg: GridConfig,
                             batch: int, n_steps: int,
                             rho: float) -> torch.Tensor:
    """Gauss-Markov time-varying Rayleigh TDL with per-symbol tap
    correlation ``rho``.  Returns (batch, n_steps, n_rx, n_tx, n_sc)."""
    pdp_amp = torch.sqrt(_pdp(cfg, gen.device) / 2.0)
    shape = (batch, cfg.n_rx, cfg.n_tx, cfg.n_taps)
    taps = [_cnormal(gen, shape) * pdp_amp]
    innov = _cnormal(gen, (n_steps - 1,) + shape) * pdp_amp
    for w in innov:
        taps.append(rho * taps[-1] + math.sqrt(1.0 - rho ** 2) * w)
    taps = torch.stack(taps, dim=1)  # (B, T, r, t, taps)
    h = torch.fft.fft(taps, n=cfg.fft_size, dim=-1)
    return h[..., : cfg.n_subcarriers]


# ---------------------------------------------------------------------------
# Pilots (static geometry, numpy)
# ---------------------------------------------------------------------------

def pilot_sequence_np(cfg: GridConfig) -> np.ndarray:
    """(n_sc,) complex64 unit-power QPSK DMRS sequence."""
    k = np.arange(cfg.n_subcarriers, dtype=np.int32) % 4
    theta = (np.float32(np.pi / 4)
             + np.float32(np.pi / 2) * k.astype(np.float32))
    return np.exp(1j * theta.astype(np.float32)).astype(np.complex64)


def pilot_sequence(cfg: GridConfig, device: DeviceLike = None) -> torch.Tensor:
    """(n_sc,) known unit-power QPSK DMRS sequence on ``device``."""
    return torch.from_numpy(pilot_sequence_np(cfg)).to(resolve_device(device))


def pilot_mask_np(cfg: GridConfig) -> np.ndarray:
    """(n_symbols, n_subcarriers) bool mask of the uncoded grid's pilot
    REs: every ``pilot_stride``-th subcarrier of the pilot symbols."""
    m = np.zeros((cfg.n_symbols, cfg.n_subcarriers), bool)
    m[list(cfg.pilot_symbols)] = (
        np.arange(cfg.n_subcarriers) % cfg.pilot_stride == 0)
    return m


def pilot_mask(cfg: GridConfig, device: DeviceLike = None) -> torch.Tensor:
    """:func:`pilot_mask_np` on ``device``."""
    return torch.from_numpy(pilot_mask_np(cfg)).to(resolve_device(device))


def link_pilot_masks_np(cfg: GridConfig) -> np.ndarray:
    """(n_tx, n_symbols, n_subcarriers) bool: staggered per-tx DMRS combs.

    Tx ``t`` transmits pilots on subcarriers ``sc % (stride * n_tx) ==
    t * stride`` of the pilot symbols; on another tx's comb it is silent.
    """
    spacing = cfg.pilot_stride * cfg.n_tx
    sc = np.arange(cfg.n_subcarriers)
    masks = np.zeros((cfg.n_tx, cfg.n_symbols, cfg.n_subcarriers), bool)
    for t in range(cfg.n_tx):
        comb = sc % spacing == t * cfg.pilot_stride
        for sym in cfg.pilot_symbols:
            masks[t, sym] = comb
    return masks


def link_pilot_masks(cfg: GridConfig,
                     device: DeviceLike = None) -> torch.Tensor:
    return torch.from_numpy(link_pilot_masks_np(cfg)).to(
        resolve_device(device)
    )


# ---------------------------------------------------------------------------
# Slots
# ---------------------------------------------------------------------------

def make_slot(gen: torch.Generator, cfg: GridConfig, batch: int,
              snr_db: float) -> dict:
    """Simulate one uncoded SISO uplink slot on ``gen``'s device (the
    training and estimator-comparison grid).

    Returns dict(y, x, h, bits, pilots, pilot_mask, noise_var):
      y (B, n_sym, n_sc) received grid, x transmitted 16-QAM symbols with
      the QPSK pilots on ``pilot_mask`` (n_sym, n_sc), h (B, n_sc) channel
      (flat in time within the slot), bits (B, n_sym, n_sc, 4) int32,
      pilots (n_sc,), noise_var 0-d float32.
    """
    dev = gen.device
    bits = torch.randint(0, 2, (batch, cfg.n_symbols, cfg.n_subcarriers, 4),
                         generator=gen, device=dev, dtype=torch.int32)
    x = qam16_mod(bits)  # (B, n_sym, n_sc)
    h = tdl_channel(gen, cfg, batch)[:, 0, 0, :]  # (B, n_sc)
    pm = pilot_mask(cfg, dev)
    pilots = pilot_sequence(cfg, dev)
    x = torch.where(pm[None], pilots[None, None, :], x)
    noise_var = 1.0 / 10.0 ** (snr_db / 10.0)
    y = x * h[:, None, :] + _cnormal(gen, x.shape) * math.sqrt(
        noise_var / 2.0)
    return {
        "y": y, "x": x, "h": h, "bits": bits,
        "pilots": pilots, "pilot_mask": pm,
        "noise_var": torch.tensor(noise_var, dtype=torch.float32,
                                  device=dev),
    }


def make_mimo_slot(gen: torch.Generator, cfg: GridConfig, batch: int,
                   snr_db: float) -> dict:
    """MIMO slot, flat per subcarrier, for MMSE detection on ``gen``'s
    device: y (B, n_sc, n_rx), h (B, n_sc, n_rx, n_tx), x (B, n_sc, n_tx)
    16-QAM, bits (B, n_sc, n_tx, 4) int32, noise_var = n_tx / snr (0-d
    float32)."""
    dev = gen.device
    bits = torch.randint(0, 2, (batch, cfg.n_subcarriers, cfg.n_tx, 4),
                         generator=gen, device=dev, dtype=torch.int32)
    x = qam16_mod(bits)  # (B, n_sc, n_tx)
    h = torch.movedim(tdl_channel(gen, cfg, batch), -1, 1)
    noise_var = cfg.n_tx / 10.0 ** (snr_db / 10.0)
    noise = _cnormal(gen, (batch, cfg.n_subcarriers, cfg.n_rx))
    y = torch.einsum("bsrt,bst->bsr", h, x) + noise * math.sqrt(
        noise_var / 2.0)
    return {
        "y": y, "h": h, "x": x, "bits": bits,
        "noise_var": torch.tensor(noise_var, dtype=torch.float32,
                                  device=dev),
    }


def make_link_slot(
    gen: torch.Generator,
    cfg: GridConfig,
    modem: Modem,
    batch: int,
    snr_db: float,
    doppler_rho: float = 1.0,
    bits=None,
    interferer_db: tuple = (),
    user_power_db=None,
) -> dict:
    """Simulate one uplink slot of the unified link schema (SISO..MIMO)
    on ``gen``'s device.

    Returns dict with batched tensors
      y_time (B, n_sym, n_sc, n_rx)  time-domain input of the CFFT stage,
      y      (B, n_sym, n_sc, n_rx)  received frequency grid,
      x      (B, n_sym, n_sc, n_tx)  transmitted symbols (pilots embedded),
      h      (B, T, n_sc, n_rx, n_tx) channel (T=1 static, T=n_sym Doppler),
      bits   (B, n_sym, n_sc, n_tx, bits_per_symbol),
    and unbatched side info: noise_var (0-d), pilot_seq (n_sc,),
    pilot_masks (n_tx, n_sym, n_sc), data_mask (n_sym, n_sc).

    ``bits`` injects pre-drawn payload bits of that grid shape; None draws
    i.i.d. uncoded bits.  ``user_power_db`` (len n_tx) folds per-stream
    receive-power gains into the channel; ``interferer_db`` adds one
    co-channel QPSK interferer per entry (independent TDL channel, every RE
    including DMRS) and folds its mean power into ``noise_var``.
    """
    dev = gen.device
    nb = modem.bits_per_symbol
    if bits is None:
        bits = torch.randint(
            0, 2, (batch, cfg.n_symbols, cfg.n_subcarriers, cfg.n_tx, nb),
            generator=gen, device=dev, dtype=torch.int32,
        )
    x = modem.mod(bits)  # (B, n_sym, n_sc, n_tx)

    pm_tx = link_pilot_masks(cfg, dev)  # (n_tx, n_sym, n_sc)
    union = torch.any(pm_tx, dim=0)  # (n_sym, n_sc)
    seq = pilot_sequence(cfg, dev)
    pm_grid = torch.movedim(pm_tx, 0, -1)  # (n_sym, n_sc, n_tx)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    x = torch.where(
        pm_grid[None], seq[None, None, :, None],
        torch.where(union[None, ..., None], zero, x),
    )

    if doppler_rho < 1.0:
        h = tdl_channel_time_varying(
            gen, cfg, batch, cfg.n_symbols, doppler_rho
        )  # (B, n_sym, n_rx, n_tx, n_sc)
    else:
        h = tdl_channel(gen, cfg, batch)[:, None]  # (B, 1, n_rx, n_tx, n_sc)
    h = torch.movedim(h, -1, 2)  # (B, T, n_sc, n_rx, n_tx)
    if user_power_db is not None:
        if len(user_power_db) != cfg.n_tx:
            raise ValueError(
                f"user_power_db needs one entry per tx stream "
                f"({len(user_power_db)} != {cfg.n_tx})"
            )
        gains = torch.tensor(
            [10.0 ** (p / 20.0) for p in user_power_db],
            dtype=torch.float32, device=dev,
        )
        h = h * gains

    hb = h.expand(batch, cfg.n_symbols, *h.shape[2:])
    y = torch.einsum("bmsrt,bmst->bmsr", hb, x)
    snr = 10.0 ** (snr_db / 10.0)
    noise_var = cfg.n_tx / snr
    if interferer_db:
        icfg = dataclasses.replace(cfg, n_tx=1)
        for p_db in interferer_db:
            if doppler_rho < 1.0:
                hi = tdl_channel_time_varying(
                    gen, icfg, batch, cfg.n_symbols, doppler_rho
                )
            else:
                hi = tdl_channel(gen, icfg, batch)[:, None]
            hi = torch.movedim(hi, -1, 2)  # (B, T, n_sc, n_rx, 1)
            hib = hi.expand(batch, cfg.n_symbols, *hi.shape[2:])
            qi = torch.randint(
                0, 4, (batch, cfg.n_symbols, cfg.n_subcarriers),
                generator=gen, device=dev,
            )
            si = torch.exp(1j * (math.pi / 4 + math.pi / 2 * qi.float()))
            amp = 10.0 ** (p_db / 20.0)
            y = y + amp * hib[..., 0] * si[..., None]
        noise_var = noise_var + sum(
            10.0 ** (p / 10.0) for p in interferer_db
        )
    thermal_var = cfg.n_tx / snr
    y = y + _cnormal(gen, y.shape) * math.sqrt(thermal_var / 2.0)
    y_time = torch.fft.ifft(y, dim=2)
    return {
        "y_time": y_time, "y": y, "x": x, "h": h, "bits": bits,
        "noise_var": torch.tensor(noise_var, dtype=torch.float32,
                                  device=dev),
        "pilot_seq": seq, "pilot_masks": pm_tx, "data_mask": ~union,
    }


def slot_from_numpy(slot: dict, device: DeviceLike = None) -> dict:
    """A reference slot (any array values, e.g. ``np.asarray`` of each JAX
    value) as the port's slot: the same dtypes, as tensors on ``device``."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v)).to(dev) for k, v in slot.items()
    }
