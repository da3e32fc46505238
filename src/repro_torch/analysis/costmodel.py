"""Kernel-aware per-device HBM traffic model of an LM step, and the
per-dtype energy model of the paper's processor (port of
:mod:`repro.analysis.costmodel`, line for line).

**LM traffic** (:func:`hbm_traffic`).  Why analytic: a traced or compiled
artifact reflects its host's fusion decisions; the flash-attention score
chains and SSD intra-chunk buffers of the reference's kernels stay in
on-chip memory.  FLOPs and collective bytes are taken from the step
itself (:mod:`repro_torch.analysis.opprofile`); bytes use this model.
All results are bytes **per device per step**, under the reference's
assumptions:

  A1. Weights stream from HBM once per use; with FSDP the gathered copy is
      also written+read once (gather buffer round-trip).
  A2. remat="full": forward activations are recomputed once in bwd
      => weight reads x3 (fwd, recompute, bwd-transpose GEMMs read weights).
  A3. Residual-stream activations make c_act ~ 12 HBM round-trips per layer
      (fwd x4: block in/out, attn out, mlp out; recompute x4; bwd grads x4).
  A4. Flash/SSD/WKV interiors stay on chip; their I/O (q,k,v / x,B,C /
      r,k,v,w + state) is counted.
  A5. Optimizer: fp32 params+mu+nu read and write => 24 B/param on the
      device's FSDP x TP shard.

**PHY energy.**  Every serve report prices its receiver pipeline's cycle
budget in joules, GOPS/W and L1 residency.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import pool
from repro_torch.kernels import quant

@dataclasses.dataclass(frozen=True)
class MeshShape:
    pod: int
    data: int
    model: int

    @property
    def dp(self) -> int:
        return self.pod * self.data

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @classmethod
    def from_multipod(cls, multi_pod: bool) -> "MeshShape":
        return cls(2, 16, 16) if multi_pod else cls(1, 16, 16)


def _div(n: int, s: int) -> float:
    """Best-effort sharding: dims that don't divide stay replicated."""
    return n / s if n % s == 0 else float(n)


def _layer_param_bytes_model_shard(cfg: ModelConfig, dtype_bytes: int,
                                   tp: int = 16) -> float:
    """One layer's weights on a single model-parallel shard (TP/EP)."""
    d, f = cfg.d_model, cfg.d_ff
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * _div(h, tp) * hd + 2 * d * _div(kh, tp) * hd + _div(h, tp) * hd * d
    if cfg.family in ("dense", "vlm", "audio"):
        mlp = 3 * d * _div(f, tp) if cfg.mlp_gated else 2 * d * _div(f, tp)
        return (attn + mlp) * dtype_bytes
    if cfg.family == "moe":
        e_loc = _div(cfg.num_experts, tp)
        mlp = e_loc * 3 * d * f + d * cfg.num_experts  # experts EP-sharded
        if cfg.num_shared_experts:
            mlp += 3 * d * cfg.num_shared_experts * f
        return (attn + mlp) * dtype_bytes
    if cfg.family == "hybrid":  # mamba layer (attn added separately)
        di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        proj = d * _div(2 * di + 2 * g * n + cfg.ssm_heads, tp)
        conv = cfg.conv_width * _div(di + 2 * g * n, tp)
        out = _div(di, tp) * d
        return (proj + conv + out) * dtype_bytes
    if cfg.family == "ssm":  # rwkv6
        tm = 5 * d * _div(d, tp) + d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * d
        cm = 2 * d * _div(f, tp) + d * d
        return (tm + cm) * dtype_bytes
    raise ValueError(cfg.family)


def _embed_bytes_shard(cfg: ModelConfig, dtype_bytes: int, tp: int = 16
                       ) -> float:
    n = cfg.vocab_size * cfg.d_model
    out = _div(n, tp) * dtype_bytes
    if not cfg.tie_embeddings and cfg.family != "audio":
        out *= 2
    return out


def hbm_traffic(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape) -> dict:
    """Per-device HBM bytes for one step of the given shape cell."""
    act_b = 2  # bf16 activations
    w_b = 2 if shape.kind != "train" else 4  # serving bf16 / training fp32
    d = cfg.d_model
    L = cfg.num_layers
    tp = mesh.model

    if shape.kind == "decode":
        tokens_loc = max(shape.global_batch // mesh.dp, 1)
        seq_ctx = shape.seq_len
    else:
        tokens_loc = shape.global_batch * shape.seq_len / mesh.dp
        seq_ctx = shape.seq_len

    act = tokens_loc * d * act_b  # one residual-stream buffer

    w_layer = _layer_param_bytes_model_shard(cfg, w_b, tp)
    w_embed = _embed_bytes_shard(cfg, w_b, tp)

    if shape.kind == "train":
        # A1+A2: weight reads x3 + FSDP gathered-copy round-trip x2
        # (per fwd/recompute/bwd) ; grads written once (model shard)
        weights = L * w_layer * (3 + 2) + w_embed * 3 + L * w_layer
        # A5 optimizer on the fsdp x tp shard
        n_params_shard = (L * w_layer / w_b) / mesh.data + w_embed / w_b
        optim = 24 * n_params_shard
        # A3 activations
        acts = L * 12 * act
        # mlp/attention internal activations (fwd + recompute + bwd)
        if cfg.family == "moe":
            cap = cfg.top_k * cfg.capacity_factor
            inner = 3 * (2 * tokens_loc * cap * d * act_b  # dispatch+combine
                         + 2 * tokens_loc * cap * _div(cfg.d_ff, tp) * act_b)
        elif cfg.family in ("dense", "vlm", "audio"):
            inner = 3 * 2 * tokens_loc * _div(cfg.d_ff, tp) * act_b
        elif cfg.family == "hybrid":
            inner = 3 * 4 * tokens_loc * _div(cfg.d_inner, tp) * act_b
        else:  # rwkv: 5 projections + wkv state spills per chunk
            state = (tokens_loc / cfg.rwkv_chunk) * _div(
                cfg.num_heads, tp) * cfg.head_dim**2 * 4
            inner = 3 * (6 * tokens_loc * _div(d, tp) * act_b + 2 * state)
        inner *= L
        # loss: logits chunks written fwd, read bwd, recomputed
        logits = 3 * tokens_loc * _div(cfg.vocab_size, tp) * act_b
        total = weights + optim + acts + inner + logits
        parts = dict(weights=weights, optimizer=optim, activations=acts,
                     inner=inner, logits=logits)
    elif shape.kind == "prefill":
        weights = L * w_layer + w_embed
        acts = L * 4 * act
        if cfg.family == "moe":
            cap = cfg.top_k * 2.0
            inner = (2 * tokens_loc * cap * d * act_b
                     + 2 * tokens_loc * cap * _div(cfg.d_ff, tp) * act_b) * L
        else:
            inner = 2 * tokens_loc * _div(cfg.d_ff, tp) * act_b * L
        # KV cache written once (seq sharded over model)
        kv = _kv_cache_bytes(cfg, shape, mesh)
        total = weights + acts + inner + kv
        parts = dict(weights=weights, activations=acts, inner=inner, kv=kv)
    else:  # decode
        weights = L * w_layer + w_embed  # every weight read once per token
        kv = _kv_cache_bytes(cfg, shape, mesh)  # full local cache read
        acts = L * 8 * act
        total = weights + kv + acts
        parts = dict(weights=weights, kv=kv, activations=acts)

    parts["total"] = total
    return parts


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


def calibration_point() -> EnergyReport:
    """The paper's full-rate fp16 operating point (for tests/docs): one
    second of saturated TEs+PEs+DMA — should land at ~4.3 W and
    ~1900 GOPS/W."""
    full = pool.BlockCycles(
        te_cycles=CLOCK_HZ, pe_cycles=CLOCK_HZ, dma_cycles=CLOCK_HZ
    )
    macs = CLOCK_HZ * pool.N_TES * pool.TE_MACS_PER_CYCLE * 0.89
    pe_flops = 1.1e12  # paper: PEs contribute ~1.1 of the 8.4 TFLOPS
    return EnergyReport(
        precision="fp16", macs=macs, pe_flops=pe_flops,
        l1_bytes=(2.0 * macs * 2 + pe_flops * 4.0) / L1_REUSE,
        dma_bytes=1024.0 * CLOCK_HZ, time_s=1.0,
    )


def _kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshShape
                    ) -> float:
    """Local KV-cache (or SSM state) bytes touched per step."""
    b_loc = max(_div(shape.global_batch, mesh.dp), 1)
    if cfg.family == "ssm":
        return (cfg.num_layers * b_loc
                * _div(cfg.num_heads, mesh.model) * cfg.head_dim**2 * 4)
    kv_layers = cfg.num_layers
    if cfg.family == "hybrid":
        kv_layers = cfg.num_layers // max(cfg.attn_every, 1)
        ssm = (cfg.num_layers - kv_layers) * b_loc * _div(
            cfg.ssm_heads, mesh.model) * cfg.ssm_state * cfg.ssm_head_dim * 4
    else:
        ssm = 0.0
    kv = (2 * kv_layers * b_loc * _div(shape.seq_len, mesh.model)
          * cfg.num_kv_heads * cfg.head_dim * 2)
    return kv + ssm
