"""dbrx-132b — MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,  # per-expert FF width
    vocab_size=100352,
    num_experts=16,
    top_k=4,
    rope_theta=500_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, num_experts=4, top_k=2,
        param_dtype="float32", compute_dtype="float32", remat="none",
        attn_chunk=64,
    )
