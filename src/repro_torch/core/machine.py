"""Machine model of the paper's processor (port of
:mod:`repro.core.machine`, the TensorPool entry only): the PHY cycle model
and the energy model price receiver stages against it."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Machine:
    name: str
    peak_flops: float  # FLOP/s at the benchmark precision
    hbm_bw: float  # bytes/s main-memory bandwidth per chip
    link_bw: float  # bytes/s per interconnect link
    fast_mem_bytes: int  # near-compute scratchpad (L1)
    freq_hz: float = 0.0

    @property
    def critical_intensity(self) -> float:
        """FLOP/byte needed to be compute-bound against main memory."""
        return self.peak_flops / self.hbm_bw


# The paper's processor: 16 TEs x 256 MACs/cycle x 2 FLOP @ 1 GHz (+PEs)
# = 8.4 TFLOPS FP16 peak; beta_L2 = 1024 B/cycle; per-TE local L1 bandwidth
# 64 B/cycle (512-bit port); 4 MiB shared L1.
TENSORPOOL_N7 = Machine(
    name="tensorpool-n7",
    peak_flops=8.4e12,
    hbm_bw=1024e9,  # L2 link: 1024 B/cycle @ 1 GHz
    link_bw=64e9,  # one TE's 512-bit L1 port @ 1 GHz
    fast_mem_bytes=4 * 1024 * 1024,
    freq_hz=1e9,
)
