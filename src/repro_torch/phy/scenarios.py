"""Named link scenarios and MCS ladders (port of
:mod:`repro.phy.scenarios`).

A :class:`LinkScenario` fixes everything a receiver pipeline needs: the
OFDM grid (incl. MIMO dims), the modem, SNR, channel dynamics and the
optional channel code.  The catalogue and the three MCS ladders are the
reference's, field for field, so a scenario name means the same link in
both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.phy import ofdm
from repro_torch.phy.coding import CodeConfig, make_code


@dataclasses.dataclass(frozen=True)
class LinkScenario:
    name: str
    grid: ofdm.GridConfig
    modulation: str  # "qpsk" | "qam16" | "qam64" | "qam256"
    snr_db: float
    doppler_rho: float = 1.0  # per-symbol tap correlation; 1.0 = static
    description: str = ""
    # channel code; None = uncoded (raw-LLR terminal, BER-scored)
    code: Optional[CodeConfig] = None
    # co-channel interferers: receive power in dB relative to a 0 dB user
    interferer_db: tuple = ()
    # MU-MIMO near-far profile: per-tx-stream receive power offsets (dB)
    user_power_db: Optional[tuple] = None

    def __post_init__(self):
        if self.user_power_db is not None and \
                len(self.user_power_db) != self.grid.n_tx:
            raise ValueError(
                f"scenario {self.name!r}: user_power_db has "
                f"{len(self.user_power_db)} entries for a "
                f"{self.grid.n_tx}-stream grid"
            )

    @property
    def modem(self) -> ofdm.Modem:
        return ofdm.make_modem(self.modulation)

    @property
    def is_mimo(self) -> bool:
        return self.grid.n_tx > 1 or self.grid.n_rx > 1

    @property
    def bits_per_slot(self) -> int:
        g = self.grid
        return (g.n_symbols * g.n_subcarriers * g.n_tx
                * self.modem.bits_per_symbol)

    @property
    def data_bits_per_slot(self) -> int:
        """Payload bits per slot (data REs only)."""
        g = self.grid
        union = ofdm.link_pilot_masks_np(g).any(axis=0)
        return int((union.size - union.sum()) * g.n_tx
                   * self.modem.bits_per_symbol)

    @property
    def coded(self) -> bool:
        return self.code is not None

    @property
    def n_users(self) -> int:
        return self.grid.n_tx if self.user_power_db is not None else 1

    def make_batch(self, gen: torch.Generator, batch: int) -> dict:
        """Simulate a batch of uplink slots on ``gen``'s device."""
        if self.code is not None:
            from repro_torch.phy import coding

            return coding.make_coded_slot(gen, self, batch)
        return ofdm.make_link_slot(
            gen, self.grid, self.modem, batch, self.snr_db,
            doppler_rho=self.doppler_rho,
            interferer_db=self.interferer_db,
            user_power_db=self.user_power_db,
        )

    def build(self, receiver: str = "classical", **options):
        """Build a receiver pipeline for this scenario."""
        from repro_torch.phy.link import build_pipeline

        return build_pipeline(receiver, self, **options)

    def replace(self, **kw) -> "LinkScenario":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MCSLadder:
    """An ordered family of same-grid coded scenarios (MCS rungs) in
    rising spectral efficiency."""
    name: str
    rungs: tuple

    def __post_init__(self):
        if not self.rungs:
            raise ValueError(f"ladder {self.name!r} has no rungs")
        scns = self.scenarios()
        for prev, cur in zip(scns, scns[1:]):
            if cur.grid != prev.grid:
                raise ValueError(
                    f"ladder {self.name!r} mixes grids: rung "
                    f"{prev.name!r} and rung {cur.name!r} differ"
                )
        uncoded = [s.name for s in scns if s.code is None]
        if uncoded:
            raise ValueError(
                f"ladder {self.name!r} has uncoded rungs {uncoded} — "
                "link adaptation needs CRC ACK/NACK feedback"
            )
        eff = [self.efficiency(i) for i in range(len(scns))]
        for i in range(len(eff) - 1):
            if eff[i + 1] < eff[i]:
                raise ValueError(
                    f"ladder {self.name!r} rungs not in rising spectral-"
                    f"efficiency order: rung {self.rungs[i]!r} "
                    f"({eff[i]} info bits/slot) is followed by rung "
                    f"{self.rungs[i + 1]!r} ({eff[i + 1]} info bits/slot)"
                )

    def scenarios(self) -> list:
        return [get_scenario(n) for n in self.rungs]

    def efficiency(self, idx: int) -> int:
        """Payload (post-CRC) bits per slot of rung ``idx``."""
        from repro_torch.phy import coding

        return coding.info_bits_per_slot(get_scenario(self.rungs[idx]))

    def __len__(self) -> int:
        return len(self.rungs)


_LADDERS: dict = {}


def register_ladder(ladder: MCSLadder, overwrite: bool = False) -> MCSLadder:
    if ladder.name in _LADDERS and not overwrite:
        raise ValueError(f"ladder {ladder.name!r} already registered")
    _LADDERS[ladder.name] = ladder
    return ladder


def get_ladder(name: str) -> MCSLadder:
    if name not in _LADDERS:
        raise KeyError(f"unknown ladder {name!r}; have {sorted(_LADDERS)}")
    return _LADDERS[name]


def ladder_names() -> list:
    return sorted(_LADDERS)


@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """One captured step a serving frontend needs: pure data, enumerable
    before any pipeline is built or captured (the reference's, field for
    field).  ``lanes == 0`` names a single-cell step, ``lanes > 0`` a mesh
    step over that lane bucket; ``harq`` selects the closed-loop slot
    schema (``rv`` + ``prior_llr`` riding along) over the open-loop one."""
    scenario: str
    receiver: str = "classical"
    options: tuple = ()
    batch: int = 4
    lanes: int = 0
    harq: bool = True


def ladder_exec_specs(ladder, *, receiver: str = "classical",
                      options: Optional[dict] = None, batch: int = 4,
                      lane_buckets=(0,), harq: bool = True) -> list:
    """The step set a frontend serving ``ladder`` needs: one
    :class:`ExecSpec` per (rung, lane bucket).  ``ladder`` is an
    :class:`MCSLadder`, a registered ladder name, or a single coded
    scenario or its name (a one-rung ladder), resolved as the closed-loop
    schedulers resolve it."""
    if isinstance(ladder, str):
        try:
            ladder = get_ladder(ladder)
        except KeyError:
            ladder = get_scenario(ladder)
    if isinstance(ladder, LinkScenario):
        rung_names = [ladder.name]
    else:
        rung_names = list(ladder.rungs)
    opts = tuple(sorted((options or {}).items()))
    return [
        ExecSpec(scenario=name, receiver=receiver, options=opts,
                 batch=batch, lanes=int(lanes), harq=harq)
        for name in rung_names
        for lanes in lane_buckets
    ]


_REGISTRY: dict = {}


def register_scenario(s: LinkScenario, overwrite: bool = False):
    if s.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {s.name!r} already registered")
    _REGISTRY[s.name] = s
    return s


def get_scenario(name: str) -> LinkScenario:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def scenario_names() -> list:
    return sorted(_REGISTRY)


def all_scenarios() -> list:
    return [_REGISTRY[n] for n in scenario_names()]


_SISO = ofdm.GridConfig(n_subcarriers=256, fft_size=256)
_MIMO2X2 = ofdm.GridConfig(n_subcarriers=256, fft_size=256, n_tx=2, n_rx=2)
_MIMO4X4 = ofdm.GridConfig(n_subcarriers=256, fft_size=256, n_tx=4, n_rx=4)
_MIMO4X8 = ofdm.GridConfig(n_subcarriers=256, fft_size=256, n_tx=4, n_rx=8)

for _s in [
    LinkScenario(
        "siso-qpsk-snr5", _SISO, "qpsk", 5.0,
        description="coverage-limited SISO voice/control traffic",
    ),
    LinkScenario(
        "siso-qam16-snr12", _SISO, "qam16", 12.0,
        description="mid-cell SISO data traffic",
    ),
    LinkScenario(
        "siso-qam64-snr24", _SISO, "qam64", 24.0,
        description="cell-center SISO peak-rate traffic",
    ),
    LinkScenario(
        "siso-qam16-doppler", _SISO, "qam16", 12.0, doppler_rho=0.95,
        description="high-mobility SISO (time-varying TDL, AR(1) taps)",
    ),
    LinkScenario(
        "mimo2x2-qpsk-snr8", _MIMO2X2, "qpsk", 8.0,
        description="2x2 spatial multiplexing, robust modulation",
    ),
    LinkScenario(
        "mimo2x2-qam16-snr16", _MIMO2X2, "qam16", 16.0,
        description="2x2 spatial multiplexing, mid-rate",
    ),
    LinkScenario(
        "mimo4x8-qam16-snr12", _MIMO4X8, "qam16", 12.0,
        description="paper-scale 4x8 massive-MIMO uplink",
    ),
    LinkScenario(
        "mimo4x8-qam64-snr24", _MIMO4X8, "qam64", 24.0,
        description="4x8 massive-MIMO uplink at peak spectral efficiency",
    ),
    # -- coded links (CRC + base-graph-lite LDPC, BLER-scored) -------------
    LinkScenario(
        "siso-qpsk-r12-snr8", _SISO, "qpsk", 8.0, code=make_code("r12"),
        description="coverage-limited coded SISO control/voice, rate-1/2",
    ),
    LinkScenario(
        "siso-qam16-r12-snr15", _SISO, "qam16", 15.0, code=make_code("r12"),
        description="mid-cell coded SISO data, 16-QAM rate-1/2",
    ),
    LinkScenario(
        "siso-qam16-r34-snr18", _SISO, "qam16", 18.0, code=make_code("r34"),
        description="cell-center coded SISO data, 16-QAM rate-3/4",
    ),
    LinkScenario(
        "mimo2x2-qam16-r12-snr17", _MIMO2X2, "qam16", 17.0,
        code=make_code("r12"),
        description="2x2 coded spatial multiplexing, 16-QAM rate-1/2",
    ),
    LinkScenario(
        "mimo2x2-qam16-r34-snr20", _MIMO2X2, "qam16", 20.0,
        code=make_code("r34"),
        description="2x2 coded spatial multiplexing, 16-QAM rate-3/4",
    ),
    # -- multi-user / interference / 256-QAM / channel aging ---------------
    LinkScenario(
        "siso-qam256-r34-snr28", _SISO, "qam256", 28.0,
        code=make_code("r34"),
        description="cell-center coded SISO peak rate, 256-QAM rate-3/4",
    ),
    LinkScenario(
        "mimo4x4-qam16-mu-snr18", _MIMO4X4, "qam16", 18.0,
        code=make_code("r12"),
        user_power_db=(6.0, 3.0, 0.0, -3.0),
        description="4-user MU-MIMO uplink with a near-far power profile "
                    "(streams ordered strongest-first for SIC)",
    ),
    LinkScenario(
        "mimo2x2-qam16-r12-intf-snr20", _MIMO2X2, "qam16", 20.0,
        code=make_code("r12"), interferer_db=(-6.0,),
        description="interference-limited 2x2 coded link with one "
                    "co-channel neighbor at -6 dB",
    ),
    LinkScenario(
        "siso-qam16-r12-aging-snr18", _SISO, "qam16", 18.0,
        code=make_code("r12"), doppler_rho=0.92,
        description="high-Doppler coded SISO: channel ages between the "
                    "DMRS symbols (AR(1) taps, rho=0.92)",
    ),
]:
    register_scenario(_s)


# MCS ladders: same grid, rising spectral efficiency
for _l in [
    MCSLadder("siso-coded", (
        "siso-qpsk-r12-snr8",
        "siso-qam16-r12-snr15",
        "siso-qam16-r34-snr18",
    )),
    MCSLadder("mimo2x2-coded", (
        "mimo2x2-qam16-r12-snr17",
        "mimo2x2-qam16-r34-snr20",
    )),
    MCSLadder("siso-coded-wide", (
        "siso-qpsk-r12-snr8",
        "siso-qam16-r12-snr15",
        "siso-qam16-r34-snr18",
        "siso-qam256-r34-snr28",
    )),
]:
    register_ladder(_l)
