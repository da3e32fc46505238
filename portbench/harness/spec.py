"""A cell as the benchmark sees it: ``BENCHMARK.json``'s workload, its
configuration file and its traffic mix, read into plain objects.

Nothing here imports the program.  The link geometry, the modems and the
QC-LDPC protographs are rebuilt from the configuration file's numbers
with a frozen copy of the port's construction, so the traffic generator
and the plain reference agree with the program only through the data.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "portbench"


@dataclasses.dataclass(frozen=True)
class Grid:
    n_subcarriers: int
    n_symbols: int
    pilot_stride: int
    pilot_symbols: tuple
    n_tx: int
    n_rx: int
    fft_size: int
    n_taps: int
    delay_spread: float


@dataclasses.dataclass(frozen=True)
class Modem:
    name: str
    bits_per_symbol: int
    levels: tuple  # per-axis amplitude of each axis-bit integer, MSB first
    norm: float

    @property
    def bits_per_axis(self) -> int:
        return self.bits_per_symbol // 2


@dataclasses.dataclass(frozen=True)
class Code:
    """One rate point of the base-graph-lite QC-LDPC code (dual-diagonal
    parity part, CRC-16 appended to the payload)."""
    z: int
    k_b: int
    m_b: int
    p_tx_b: int
    info_edges: tuple
    crc_bits: int

    @property
    def n_b(self) -> int:
        return self.k_b + self.m_b

    @property
    def k(self) -> int:
        return self.k_b * self.z

    @property
    def k_info(self) -> int:
        return self.k - self.crc_bits

    @property
    def n_mother(self) -> int:
        return self.n_b * self.z

    @property
    def e_bits(self) -> int:
        return (self.k_b + self.p_tx_b) * self.z

    def layers(self) -> tuple:
        out = []
        for j in range(self.m_b):
            edges = list(self.info_edges[j])
            if j > 0:
                edges.append((self.k_b + j - 1, 0))
            edges.append((self.k_b + j, 0))
            out.append(tuple(edges))
        return tuple(out)

    @property
    def n_edges(self) -> int:
        return sum(len(e) for e in self.layers())


@dataclasses.dataclass(frozen=True)
class Rung:
    name: str
    grid: Grid
    modem: Modem
    snr_db: float
    doppler_rho: float
    interferer_db: tuple
    user_power_db: object  # None or a tuple, one entry per tx stream
    code: Code

    def replace(self, **kw) -> "Rung":
        return dataclasses.replace(self, **kw)

    @functools.cached_property
    def data_bits_per_slot(self) -> int:
        union = pilot_masks_np(self.grid).any(axis=0)
        return int((union.size - union.sum()) * self.grid.n_tx
                   * self.modem.bits_per_symbol)

    @property
    def codewords_per_slot(self) -> int:
        return self.data_bits_per_slot // self.code.e_bits


def make_info_edges(k_b: int, m_b: int, z: int, col_degree: int,
                    seed: int) -> tuple:
    """The systematic part's protograph: balanced row degrees, no
    repeated (row, col) pair, drawn from ``seed`` (a frozen copy of the
    port's construction)."""
    rng = np.random.default_rng(seed)
    rows_of = [[] for _ in range(m_b)]
    for c in range(k_b):
        order = sorted(range(m_b),
                       key=lambda r: (len(rows_of[r]), rng.random()))
        for r in order[:col_degree]:
            rows_of[r].append((c, int(rng.integers(z))))
    return tuple(tuple(sorted(edges)) for edges in rows_of)


def pilot_masks_np(g: Grid) -> np.ndarray:
    """(n_tx, n_symbols, n_subcarriers) bool: staggered per-tx DMRS
    combs on the pilot symbols."""
    spacing = g.pilot_stride * g.n_tx
    sc = np.arange(g.n_subcarriers)
    masks = np.zeros((g.n_tx, g.n_symbols, g.n_subcarriers), bool)
    for t in range(g.n_tx):
        comb = sc % spacing == t * g.pilot_stride
        for sym in g.pilot_symbols:
            masks[t, sym] = comb
    return masks


def pilot_sequence_np(g: Grid) -> np.ndarray:
    """(n_sc,) complex64 unit-power QPSK DMRS sequence."""
    k = np.arange(g.n_subcarriers, dtype=np.int32) % 4
    theta = (np.float32(np.pi / 4)
             + np.float32(np.pi / 2) * k.astype(np.float32))
    return np.exp(1j * theta.astype(np.float32)).astype(np.complex64)


def data_re_index(g: Grid) -> tuple:
    """(sym_idx, sc_idx) of the data REs, symbol-major."""
    return np.nonzero(~pilot_masks_np(g).any(axis=0))


def rung_from_dict(d: dict, grid: Grid) -> Rung:
    c = d["code"]
    code = Code(z=c["z"], k_b=c["k_b"], m_b=c["m_b"], p_tx_b=c["p_tx_b"],
                info_edges=make_info_edges(c["k_b"], c["m_b"], c["z"],
                                           c["col_degree"],
                                           c["protograph_seed"]),
                crc_bits=c["crc_bits"])
    m = d["modem"]
    upd = d.get("user_power_db")
    return Rung(name=d["name"], grid=grid,
                modem=Modem(m["name"], m["bits_per_symbol"],
                            tuple(float(v) for v in m["levels"]),
                            float(m["norm"])),
                snr_db=float(d["snr_db"]),
                doppler_rho=float(d.get("doppler_rho", 1.0)),
                interferer_db=tuple(d.get("interferer_db", ())),
                user_power_db=None if upd is None else tuple(upd),
                code=code)


@dataclasses.dataclass
class Cell:
    """One workload: its configuration and traffic mix as read."""
    name: str
    chips: int
    config: dict
    mix: dict
    rungs: list  # Rung per MCS rung, lowest first

    @property
    def receiver(self) -> str:
        return self.config["receiver"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The workload named in ``BENCHMARK.json`` with its configuration
    (``configs``' ``file``) and its mix (``mixes/<traffic>.json``)."""
    bench = read_json(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = read_json(root / conf["file"])
    mix = read_json(root / "portbench" / "mixes" / f"{w['traffic']}.json")
    return make_cell(w["name"], int(w["chips"]), config, mix)


def make_cell(name: str, chips: int, config: dict, mix: dict) -> Cell:
    grid = Grid(**{**config["grid"],
                   "pilot_symbols": tuple(config["grid"]["pilot_symbols"])})
    rungs = [rung_from_dict(r, grid) for r in config["rungs"]]
    return Cell(name, chips, config, mix, rungs)
