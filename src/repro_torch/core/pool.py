"""TensorPool execution plans and cycle model (port of
:mod:`repro.core.pool`, paper Sec. V-C, Fig. 9/10).

For each of the paper's three AI-PHY compute blocks (FC + softmax, the
depthwise-separable conv block, MHA):

* a *sequential* plan: TE work (GEMM) and PE work (softmax / LayerNorm /
  ReLU / depthwise) as separate ops, each intermediate through device
  memory, in plain PyTorch as the reference's are plain jnp
  (``fc_softmax_sequential`` runs its GEMM on :func:`ops.te_gemm`, as
  the reference does);
* a *concurrent* plan: the fused kernel through :mod:`repro_torch.kernels.ops`
  (``csrc/fc_softmax.cu``, ``csrc/dwconv_block.cu``, ``csrc/mha.cu``);
* the paper's engine constants and the per-engine cycle estimators, which
  the receiver stages also report their TTI budget with.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# execution plans
# ---------------------------------------------------------------------------

def fc_softmax_sequential(x, w, b):
    """TE then PE, distinct ops (the logits round-trip device memory)."""
    z = kops.te_gemm(x, w, b, epilogue="none")
    return torch.softmax(z.to(torch.float32), dim=-1).to(x.dtype)


def fc_softmax_concurrent(x, w, b):
    return kops.fc_softmax(x, w, b)


def mha_sequential(q, k, v, causal=True):
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k).to(torch.float32) * (d ** -0.5)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)  # PE pass, scores in memory
    return torch.einsum("bqk,bkd->bqd", p, v)


def mha_concurrent(q, k, v, causal=True):
    return kops.mha(q, k, v, causal=causal)


def dwconv_sequential(x_padded, dw, pw, gamma, beta):
    b, hp, wp, c = x_padded.shape
    h, w = hp - 2, wp - 2
    y = torch.zeros((b, h, w, c), dtype=x_padded.dtype,
                    device=x_padded.device)
    for di in range(3):
        for dj in range(3):
            y = y + x_padded[:, di: di + h, dj: dj + w, :] * dw[di, dj]
    z = torch.einsum("bhwc,cf->bhwf", y, pw)  # TE
    zf = z.to(torch.float32)
    mu = torch.mean(zf, dim=-1, keepdim=True)
    var = torch.var(zf, dim=-1, keepdim=True, unbiased=False)
    zf = (zf - mu) * torch.rsqrt(var + 1e-5) * gamma + beta  # PE
    return torch.clamp_min(zf, 0.0).to(x_padded.dtype)


def dwconv_concurrent(x_padded, dw, pw, gamma, beta):
    return kops.dwconv_block(x_padded, dw, pw, gamma, beta)


# ---------------------------------------------------------------------------
# TensorPool cycle model (paper constants)
# ---------------------------------------------------------------------------

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


def fc_block_cycles(m: int, k: int, n: int, dtype_bytes: int = 2
                    ) -> BlockCycles:
    """FC layer (m, k) @ (k, n) + row softmax (paper: 512 x 512)."""
    return BlockCycles(
        te_cycles=te_cycles(m * k * n),
        pe_cycles=pe_elem_cycles(m * n, "softmax"),
        dma_cycles=dma_cycles(dtype_bytes * (m * k + k * n + 2 * m * n)),
    )


def dwconv_block_cycles(h: int, w: int, c: int, f: int,
                        dtype_bytes: int = 2) -> BlockCycles:
    pw_macs = h * w * c * f
    return BlockCycles(
        te_cycles=te_cycles(pw_macs),
        pe_cycles=(pe_elem_cycles(h * w * c, "depthwise3x3")
                   + pe_elem_cycles(h * w * f, "layernorm")
                   + pe_elem_cycles(h * w * f, "relu")),
        dma_cycles=dma_cycles(dtype_bytes * (h * w * c + c * f + h * w * f)),
    )


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
