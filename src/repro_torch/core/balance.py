"""Kung's-principle memory-balance analysis (paper §IV, Eq. 1-6; port of
:mod:`repro.core.balance`) on the H100's memory hierarchy.

The paper proves, level by level, that compute time >= transfer time so the
tensor engines are never starved:
  Eq. 1  L2 -> L1 (double-buffered GEMM)        here: HBM -> shared memory
  Eq. 2-3  TE <-> local Tile L1                 here: wgmma <-> shared
                                                memory tile
  Eq. 4-6  TE <-> remote Tile L1 via burst port here: card <-> card NVLink

Pure functions of a :class:`~repro_torch.core.machine.Machine`
(:data:`~repro_torch.core.machine.H100_SXM` for the card): they classify a
GEMM or a tile as compute- or memory-bound, size its shared-memory
footprint, and count the in-flight transfers that hide a latency.  The
kernel tuner (:mod:`repro_torch.kernels.tune`) sizes its GEMM candidates
with :func:`tile_vmem_bytes`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.machine import Machine


@dataclasses.dataclass(frozen=True)
class BalanceReport:
    compute_time_s: float
    transfer_time_s: float
    arithmetic_intensity: float  # FLOP per byte moved
    critical_intensity: float  # machine's FLOP/byte break-even
    balanced: bool  # compute_time >= transfer_time  (Kung's inequality)

    @property
    def bound(self) -> str:
        return "compute" if self.balanced else "memory"


def kung(flops: float, bytes_moved: float, machine: Machine,
         bw: Optional[float] = None) -> BalanceReport:
    bw = bw if bw is not None else machine.hbm_bw
    t_c = flops / machine.peak_flops
    t_m = bytes_moved / bw
    ai = flops / max(bytes_moved, 1e-30)
    return BalanceReport(
        compute_time_s=t_c,
        transfer_time_s=t_m,
        arithmetic_intensity=ai,
        critical_intensity=machine.peak_flops / bw,
        balanced=t_c >= t_m,
    )


def gemm_hbm_balance(n: int, dtype_bytes: int, machine: Machine,
                     double_buffered: bool = True) -> BalanceReport:
    """Paper Eq. 1: square (n,n,n) GEMM streamed from main memory.

    Wk = n^3 MACs = 2 n^3 FLOP; Qm = dtype_bytes * (X + W + 2Z) = 4 n^2 words.
    """
    flops = 2.0 * n**3
    bytes_moved = dtype_bytes * 4.0 * n * n
    return kung(flops, bytes_moved, machine)


def gemm_tile_balance(bm: int, bn: int, bk: int, dtype_bytes: int,
                      machine: Machine, vmem_bw: Optional[float] = None
                      ) -> BalanceReport:
    """Paper Eq. 2-3 analogue: one (bm, bn, bk) output tile resident in
    shared memory.

    The tensor cores compute 2*bm*bn*bk FLOP while the next X (bm,bk) and
    W (bk,bn) tiles stream in and the Y tile (bm,bn) streams out once per
    K-loop; ``vmem_bw`` is the rate of that stream (HBM's by default).
    """
    flops = 2.0 * bm * bn * bk
    bytes_moved = dtype_bytes * (bm * bk + bk * bn) + 2.0 * dtype_bytes * bm * bn
    bw = vmem_bw if vmem_bw is not None else machine.hbm_bw
    return kung(flops, bytes_moved, machine, bw=bw)


def tile_vmem_bytes(bm: int, bn: int, bk: int, dtype_bytes: int,
                    acc_bytes: int = 4, n_buffers: int = 2) -> int:
    """Shared-memory footprint of a double-buffered (bm,bn,bk) GEMM tile.

    n_buffers copies of the streamed X and W tiles (the latency-tolerance
    analogue of the paper's ROB/streamer buffers: the stages of a TMA ring)
    + one fp32 accumulator (registers on the card, counted as the
    reference counts it).
    """
    stream = n_buffers * dtype_bytes * (bm * bk + bk * bn)
    acc = acc_bytes * bm * bn
    return int(stream + acc)


def outstanding_buffers_needed(latency_s: float, tile_compute_s: float) -> int:
    """Paper §III-B: how many in-flight tile transfers hide memory latency.

    The RedMulE ROB holds 16 outstanding transactions because the Tile-to-Tile
    interconnect takes up to 9 cycles; on the card the same role is played
    by the stages of a kernel's TMA / cp.async ring in shared memory.
    """
    return max(2, 1 + math.ceil(latency_s / max(tile_compute_s, 1e-30)))


def sharded_gemm_ici_balance(
    m: int, n: int, k: int, dtype_bytes: int, machine: Machine,
    shards: int, gathered: str = "rhs",
) -> BalanceReport:
    """Paper Eq. 4-6 analogue: a tensor-parallel GEMM where each card must
    gather the remote operand shards over its links (NVLink on the card)
    while computing.

    With the RHS (k, n/shards) sharded and all-gathered ring-style, each card
    moves (shards-1)/shards of the RHS while computing its 2 m n k / shards
    FLOP share — Kung's inequality tells us whether the collective hides.
    """
    flops = 2.0 * m * n * k / shards
    if gathered == "rhs":
        moved = dtype_bytes * k * n * (shards - 1) / shards
    else:
        moved = dtype_bytes * m * k * (shards - 1) / shards
    return kung(flops, moved, machine, bw=machine.link_bw)
