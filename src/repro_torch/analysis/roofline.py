"""Three-term roofline of a traced step (port of
:mod:`repro.analysis.roofline`).

  compute_s    = executed FLOPs per device / peak FLOP/s
  memory_s     = HBM bytes per device / HBM bandwidth
  collective_s = wire bytes per device / link bandwidth

FLOPs and collective bytes come from :mod:`repro_torch.analysis.
opprofile` (the per-rank local ops and collectives of the step itself,
run on DTensors); bytes from the kernel-aware model
(:func:`repro_torch.analysis.costmodel.hbm_traffic`) where the caller
passes it.  The footprint record (:class:`MemStats`) replaces the
reference's ``memory_analysis()``.

The machine defaults to :data:`H100_SXM_BF16`: ``core/machine.py``'s
``H100_SXM`` with its dense bf16 tensor-core peak
(``H100_SXM_TENSOR_FLOPS["bf16"]``, 989e12 FLOP/s) as the compute rate,
since the LM configs compute in bf16, with the H100's 3.35e12 B/s HBM and
450e9 B/s NVLink; ``hbm_capacity`` defaults to the card's 80e9 bytes.  No
TPU number is a default.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.analysis import costmodel as _cm
from repro_torch.analysis.opprofile import OpProfile
from repro_torch.core.machine import H100_SXM, H100_SXM_TENSOR_FLOPS, Machine
from repro_torch.kernels import quant as _q

H100_SXM_BF16 = dataclasses.replace(
    H100_SXM, name="h100-sxm-bf16", peak_flops=H100_SXM_TENSOR_FLOPS["bf16"])
H100_HBM_BYTES = 80e9


@dataclasses.dataclass(frozen=True)
class MemStats:
    """The port's ``memory_analysis()`` record, per rank:
    ``argument_size_in_bytes`` the placed state + batch (+ cache) exactly,
    ``temp_size_in_bytes`` the step's peak beyond them, and
    ``output_size_in_bytes`` what it returns (see :mod:`repro_torch.
    launch.dryrun` for how each is taken)."""
    argument_size_in_bytes: int
    temp_size_in_bytes: int
    output_size_in_bytes: int


@dataclasses.dataclass
class RooflineReport:
    cell: str
    mesh: str
    chips: int
    # per-device quantities
    flops: float
    hbm_bytes: float
    collective_wire_bytes: float
    collective_operand_bytes: float
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    # step-time estimates
    t_overlap_s: float  # perfect overlap: max(terms)
    t_serial_s: float  # no overlap: sum(terms)
    # usefulness
    model_flops_global: float  # 6*N*D ideal
    model_flops_ratio: float  # model / executed(global)
    mfu_overlap: float  # model-flops utilization at perfect overlap
    # memory footprint (from MemStats)
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    fits_hbm: Optional[bool] = None
    collective_counts: dict = dataclasses.field(default_factory=dict)
    xla_flops_raw: float = 0.0  # the reference's cost_analysis(); 0 here
    hbm_bytes_unfused: float = 0.0  # traced boundary bytes (upper bound)
    # modeled energy (per-dtype pJ/MAC + pJ/byte; see costmodel)
    precision: str = "bf16"
    energy_j: float = 0.0  # per device per step
    gops_per_watt: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def row(self) -> str:
        return (
            f"{self.cell:40s} {self.mesh:9s} "
            f"c={self.compute_s*1e3:9.3f}ms m={self.memory_s*1e3:9.3f}ms "
            f"n={self.collective_s*1e3:9.3f}ms -> {self.bottleneck:10s} "
            f"MFU={self.mfu_overlap*100:5.1f}% useful={self.model_flops_ratio*100:5.1f}%"
        )


def build_report(
    cell: str,
    mesh_name: str,
    chips: int,
    prof: OpProfile,
    model_flops_global: float,
    machine: Machine = H100_SXM_BF16,
    mem_stats=None,
    xla_flops_raw: float = 0.0,
    hbm_capacity: float = H100_HBM_BYTES,
    hbm_bytes_model: Optional[float] = None,
    precision: str = "bf16",
) -> RooflineReport:
    """FLOPs/collectives come from the traced step (opprofile); the memory
    term uses the kernel-aware cost model when provided (hbm_bytes_model),
    falling back to the traced unfused upper bound.  ``mem_stats`` is a
    :class:`MemStats` (or any record with its three fields)."""
    hbm_bytes = (
        hbm_bytes_model if hbm_bytes_model is not None else prof.boundary_bytes
    )
    compute_s = prof.flops / machine.peak_flops
    memory_s = hbm_bytes / machine.hbm_bw
    # the wire bytes in the payloads' own dtypes (see opprofile)
    collective_s = prof.collective_wire_bytes_bf16corr / machine.link_bw
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    bottleneck = max(terms, key=terms.get)
    t_overlap = max(terms.values())
    t_serial = sum(terms.values())
    executed_global = prof.flops * chips
    ratio = model_flops_global / executed_global if executed_global else 0.0
    mfu = (
        (model_flops_global / chips / machine.peak_flops) / t_overlap
        if t_overlap > 0 else 0.0
    )
    rep = RooflineReport(
        cell=cell,
        mesh=mesh_name,
        chips=chips,
        flops=prof.flops,
        hbm_bytes=hbm_bytes,
        collective_wire_bytes=prof.collective_wire_bytes_bf16corr,
        collective_operand_bytes=prof.collective_operand_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        t_overlap_s=t_overlap,
        t_serial_s=t_serial,
        model_flops_global=model_flops_global,
        model_flops_ratio=min(ratio, 1.0) if executed_global else 0.0,
        mfu_overlap=mfu,
        collective_counts=dict(prof.collective_counts),
        xla_flops_raw=xla_flops_raw,
        hbm_bytes_unfused=prof.boundary_bytes,
    )
    if mem_stats is not None:
        rep.arg_bytes = int(mem_stats.argument_size_in_bytes)
        rep.temp_bytes = int(mem_stats.temp_size_in_bytes)
        rep.out_bytes = int(mem_stats.output_size_in_bytes)
        rep.fits_hbm = (
            rep.arg_bytes + rep.temp_bytes + rep.out_bytes
        ) < hbm_capacity
    rep.precision = precision
    rep.energy_j = step_energy_j(
        prof.flops, hbm_bytes, t_overlap, precision
    )
    rep.gops_per_watt = (
        prof.flops / rep.energy_j * 1e-9 if rep.energy_j > 0 else 0.0
    )
    return rep


def step_energy_j(flops: float, hbm_bytes: float, step_s: float,
                  precision: str = "bf16") -> float:
    """Modeled joules per device-step: executed FLOPs at the precision's
    pJ/MAC (2 flops/MAC), HBM traffic at the DMA pJ/byte, plus static
    power over the step — the same per-dtype constants the PHY serve
    reports use (costmodel), applied to the traced step's counts."""
    p = _q.resolve_precision(precision)
    dyn_pj = (flops / 2.0 * _cm.PJ_PER_MAC[p]
              + hbm_bytes * _cm.PJ_PER_BYTE_DMA)
    return dyn_pj * 1e-12 + _cm.STATIC_W * step_s


# -- ideal model FLOPs --------------------------------------------------------

def model_flops_ideal(cfg, shape, n_params_active: float) -> float:
    """6 * N_active * D tokens (train) / 2 * N * D (fwd-only) per step."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch


def active_params(cfg, n_params_total: int) -> float:
    """Active parameter count for MoE (routed experts count top_k/E)."""
    if cfg.family != "moe":
        return float(n_params_total)
    # expert weights: 3 matrices per expert
    expert_params = (
        cfg.num_experts * 3 * cfg.d_model * cfg.d_ff * cfg.num_layers
    )
    active_expert = expert_params * cfg.top_k / cfg.num_experts
    return float(n_params_total - expert_params + active_expert)
