"""Config system (port of :mod:`repro.configs.base`): model / shape / mesh /
train configs as frozen dataclasses, field for field the reference's.

Every assigned architecture provides a module
``repro_torch.configs.<arch_id>`` with ``CONFIG`` (the exact published
configuration) and ``smoke()`` (a reduced same-family config for CPU
tests).  ``repro_torch.configs.registry`` maps ids.  ``DTYPES`` maps the
reference's dtype names to torch dtypes, so ``cfg.dtype()`` and
``cfg.pdtype()`` return torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # dense-transformer options
    qkv_bias: bool = False
    parallel_block: bool = False  # attn & mlp in parallel (command-r style)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    pos_embed: str = "rope"  # rope | learned | none
    mlp_gated: bool = True  # SwiGLU when True, GeLU-MLP when False
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (Mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    attn_every: int = 0  # hybrid: one shared attention block every N layers
    # rwkv6
    rwkv_chunk: int = 64
    # encoder-decoder (whisper): decoder uses the main fields above
    enc_layers: int = 0
    enc_ctx: int = 0  # number of (stub) audio frame embeddings
    # vlm (pixtral): stub patch embeddings prepended to the text sequence
    num_image_tokens: int = 0
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots_saveable
    scan_layers: bool = True
    attn_chunk: int = 1024  # KV-chunked (flash-semantics) attention block size
    # carried for field parity with the reference; read by nothing here or
    # in the reference's models
    use_pallas: bool = False

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def dtype(self):
        return DTYPES[self.compute_dtype]

    def pdtype(self):
        return DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def replace(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)


# The four assigned LM shape cells.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1  # gradient accumulation
    seed: int = 0
    # checkpointing / fault tolerance
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    # distributed-optimization extras
    grad_compression: str = "none"  # none | int8 | topk
    topk_fraction: float = 0.05

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells applicable to an architecture: the 500k-token decode
    cell only for the subquadratic families (ssm, hybrid)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return names
