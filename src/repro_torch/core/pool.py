"""TensorPool cycle model (port of the arithmetic of
:mod:`repro.core.pool`): the paper's engine constants and the per-engine
cycle estimators the receiver stages report their TTI budget with
(including :func:`mha_block_cycles`, which prices CE-ViT's layers).  The
reference module's execution plans run Pallas kernels; only the pure
arithmetic is needed here."""
from __future__ import annotations

import dataclasses

N_TES = 16
TE_MACS_PER_CYCLE = 256  # per TE
N_PES = 256
PE_MACS_PER_CYCLE = 2  # per PE (two FP16 MACs on the 32-bit FPU)


@dataclasses.dataclass(frozen=True)
class BlockCycles:
    te_cycles: float  # GEMM work on the tensor engines
    pe_cycles: float  # softmax/LN/ReLU/depthwise on the PEs
    dma_cycles: float  # L2<->L1 transfers

    @property
    def sequential(self) -> float:
        return self.te_cycles + self.pe_cycles + self.dma_cycles

    def concurrent(self, contention: float = 1.5) -> float:
        """Double-buffered overlap with an L1 bank-conflict ``contention``
        factor, capped just below the sequential schedule (the paper's
        Fig. 10 shapes)."""
        overlapped = max(
            self.te_cycles, self.pe_cycles, self.dma_cycles
        ) * contention
        return min(overlapped, 0.987 * self.sequential)

    @property
    def te_utilization_concurrent(self) -> float:
        return self.te_cycles / max(self.concurrent(), 1e-9)


def te_cycles(macs: float, utilization: float = 0.89) -> float:
    return macs / (N_TES * TE_MACS_PER_CYCLE * utilization)


# per-element PE instruction costs on an RV32IMAF core (paper Fig. 8)
PE_ELEM_CYCLES = {
    "relu": 2.0,
    "softmax": 29.0,
    "layernorm": 9.0,
    "batchnorm": 9.0,
    "depthwise3x3": 25.0,
    "mac": 1.0,
}


def pe_cycles(flops: float, ipc: float = 0.6) -> float:
    """Generic PE work from flops; ipc from paper Fig. 8 (0.59-0.77)."""
    return flops / (N_PES * 2 * PE_MACS_PER_CYCLE * ipc)


def pe_elem_cycles(n_elems: float, kind: str) -> float:
    return n_elems * PE_ELEM_CYCLES[kind] / N_PES


def dma_cycles(bytes_moved: float, bw_bytes_per_cycle: float = 1024) -> float:
    return bytes_moved / bw_bytes_per_cycle


def mha_block_cycles(heads: int, s: int, d: int, dtype_bytes: int = 2
                     ) -> BlockCycles:
    """One transformer attention block over ``s`` tokens of width ``d``."""
    qkv_macs = 4.0 * s * d * d  # Q,K,V,O projections
    attn_macs = heads * 2.0 * s * s * (d / heads)
    return BlockCycles(
        te_cycles=te_cycles(qkv_macs + attn_macs),
        pe_cycles=pe_elem_cycles(heads * s * s, "softmax"),
        dma_cycles=dma_cycles(dtype_bytes * 4 * s * d),
    )
