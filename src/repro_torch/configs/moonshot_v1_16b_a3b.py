"""moonshot-v1-16b-a3b — fine-grained MoE, 64 routed experts top-6 (+2 shared,
DeepSeek-V3-style as in the HF release). [hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per-expert FF width (fine-grained experts)
    vocab_size=163840,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    rope_theta=50_000.0,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=256, num_experts=8, top_k=2, num_shared_experts=1,
        param_dtype="float32", compute_dtype="float32", remat="none",
        attn_chunk=64,
    )
