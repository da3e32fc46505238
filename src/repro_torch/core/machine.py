"""Machine models (port of :mod:`repro.core.machine`): the paper's
processor, which the PHY cycle model and the energy model price receiver
stages against, its TeraPool baseline (paper Table II), and the H100 the
port runs on, which the balance model (:mod:`repro_torch.core.balance`),
the kernel tuner and ``chip_smoke.py``'s bounds read.  The reference's
TPU entry has no counterpart here."""
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

# TeraPool baseline (paper Table II): 1024 PEs x 2 FP16 MACs/cycle @ 0.9 GHz.
TERAPOOL_12N = Machine(
    name="terapool-12n",
    peak_flops=3.7e12,
    hbm_bw=1024e9,
    link_bw=64e9,
    fast_mem_bytes=4 * 1024 * 1024,
    freq_hz=0.9e9,
)

# The card the port runs on: an NVIDIA H100 SXM (NVIDIA's data sheet; the
# port's numbers were taken on one that reports "NVIDIA H100 80GB HBM3" at
# a 700.00 W power limit).  67 TFLOP/s fp32 outside the tensor cores, 80 GB
# of HBM3 at 3.35 TB/s, NVLink 450 GB/s each way to each other card of the
# host, 228 KiB of shared memory an SM (of which a block takes at most
# 227 KiB; ``csrc/te_gemm.cu``'s SMEM_PER_SM), 1.98 GHz boost clock.
H100_SXM = Machine(
    name="h100-sxm",
    peak_flops=67e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    fast_mem_bytes=228 * 1024,
    freq_hz=1.98e9,
)

# The H100 SXM's dense tensor-core peaks by operand type (NVIDIA's data
# sheet, at the 700 W limit), beside H100_SXM's fp32 rate
H100_SXM_TENSOR_FLOPS = {
    "tf32": 495e12,
    "bf16": 989e12,
    "fp16": 989e12,
    "int8": 1979e12,
    "fp8": 1979e12,
}
