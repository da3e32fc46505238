"""smollm-360m — llama-arch small. [hf:HuggingFaceTB/SmolLM-360M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=48, num_heads=3, num_kv_heads=1, head_dim=16,
        d_ff=96, vocab_size=256, param_dtype="float32",
        compute_dtype="float32", remat="none", attn_chunk=64,
    )
