"""rwkv6-1.6b — Finch: attention-free, data-dependent decay. [arXiv:2404.05892]

The WKV token-mixing core is an elementwise recurrence with no GEMM inside
it; the projections and the channel mix are plain ``torch`` products in
the port (:mod:`repro_torch.models.rwkv6`).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # head_size 64
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    pos_embed="none",
    norm_type="layernorm",
    mlp_gated=False,
    rwkv_chunk=64,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, param_dtype="float32",
        compute_dtype="float32", remat="none", rwkv_chunk=16,
    )
