"""Per-dtype energy model of the paper's processor (port of the PHY part
of :mod:`repro.analysis.costmodel`): every serve report prices its
receiver pipeline's cycle budget in joules, GOPS/W and L1 residency.

The reference module's LM traffic model is not ported (it reads the LM
configs, ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import pool
from repro_torch.kernels import quant

PJ_PER_MAC = {
    "fp32": 2.0,
    "fp16": 0.5,
    "bf16": 0.5,
    "int8": 0.15,
    "fp8": 0.14,
}
PJ_PER_FLOP_PE = 1.2  # RV32IMAF FPU op incl. regfile/issue overhead
PJ_PER_BYTE_L1 = 0.1  # 4 MiB shared L1 SRAM access
PJ_PER_BYTE_DMA = 0.4  # L2<->L1 DMA burst (1024 B/cycle fabric)
STATIC_W = 0.6  # leakage + clock tree at 1 GHz
CLOCK_HZ = 1.0e9
L1_REUSE = 8.0  # operand reuse in the TE register file / X-W buffers
_BASE_BYTES = 4  # stage DMA models price fp32/complex-split traffic


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Modeled energy for one block of PHY work at one precision."""
    precision: str
    macs: float        # TE MAC count
    pe_flops: float    # PE (VPU) flop count
    l1_bytes: float    # TE + PE operand traffic through L1
    dma_bytes: float   # L2<->L1 DMA traffic
    time_s: float      # modeled concurrent-schedule runtime

    @property
    def te_j(self) -> float:
        return self.macs * PJ_PER_MAC[self.precision] * 1e-12

    @property
    def pe_j(self) -> float:
        return self.pe_flops * PJ_PER_FLOP_PE * 1e-12

    @property
    def l1_j(self) -> float:
        return self.l1_bytes * PJ_PER_BYTE_L1 * 1e-12

    @property
    def dma_j(self) -> float:
        return self.dma_bytes * PJ_PER_BYTE_DMA * 1e-12

    @property
    def static_j(self) -> float:
        return STATIC_W * self.time_s

    @property
    def dynamic_j(self) -> float:
        return self.te_j + self.pe_j + self.l1_j + self.dma_j

    @property
    def total_j(self) -> float:
        return self.dynamic_j + self.static_j

    @property
    def ops(self) -> float:
        """Total arithmetic ops (2 flops per MAC + PE flops)."""
        return 2.0 * self.macs + self.pe_flops

    @property
    def gops_per_watt(self) -> float:
        return self.ops / max(self.total_j, 1e-30) * 1e-9

    @property
    def l1_residency(self) -> float:
        """Fraction of operand traffic served from L1 (vs DMA'd)."""
        tot = self.l1_bytes + self.dma_bytes
        return self.l1_bytes / tot if tot > 0 else 0.0

    @property
    def avg_power_w(self) -> float:
        return self.total_j / max(self.time_s, 1e-30)

    def scaled(self, factor: float) -> "EnergyReport":
        """The same work repeated ``factor`` times."""
        return dataclasses.replace(
            self, macs=self.macs * factor, pe_flops=self.pe_flops * factor,
            l1_bytes=self.l1_bytes * factor,
            dma_bytes=self.dma_bytes * factor,
            time_s=self.time_s * factor,
        )


def _precision_bytes(precision: str) -> int:
    return quant.itemsize(precision)


def block_energy(cycles: pool.BlockCycles, precision: str = "fp32",
                 clock_hz: float = CLOCK_HZ) -> EnergyReport:
    """Price a :class:`pool.BlockCycles` at a precision by inverting the
    cycle model's fixed rates back into MACs, flops and bytes."""
    precision = quant.resolve_precision(precision)
    macs = cycles.te_cycles * pool.N_TES * pool.TE_MACS_PER_CYCLE * 0.89
    pe_flops = cycles.pe_cycles * pool.N_PES * 2 * pool.PE_MACS_PER_CYCLE * 0.6
    bscale = _precision_bytes(precision) / _BASE_BYTES
    dma_bytes = cycles.dma_cycles * 1024.0 * bscale
    l1_bytes = (2.0 * macs * _precision_bytes(precision)
                + pe_flops * 4.0) / L1_REUSE
    return EnergyReport(
        precision=precision, macs=macs, pe_flops=pe_flops,
        l1_bytes=l1_bytes, dma_bytes=dma_bytes,
        time_s=cycles.concurrent() / clock_hz,
    )


def pipeline_energy(pipeline, precision: Optional[str] = None,
                    clock_hz: float = CLOCK_HZ) -> EnergyReport:
    """Per-slot modeled energy for a ReceiverPipeline (sums the per-stage
    BlockCycles models) at the pipeline's precision unless overridden."""
    if precision is None:
        precision = getattr(pipeline, "precision", "fp32") or "fp32"
    return block_energy(pipeline.total_cycles(), precision,
                        clock_hz=clock_hz)
