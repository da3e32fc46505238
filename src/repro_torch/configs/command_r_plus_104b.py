"""command-r-plus-104b — dense GQA, no-bias, parallel attn+mlp block.

[hf:CohereForAI/c4ai-command-r-plus]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    parallel_block=True,  # Cohere parallel residual block
    norm_type="layernorm",
    rope_theta=75_000_000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, param_dtype="float32",
        compute_dtype="float32", remat="none", attn_chunk=64,
    )
