"""pixtral-12b — pixtral-ViT frontend (STUB: precomputed patch embeddings)
+ mistral-nemo backbone. [hf:mistralai/Pixtral-12B-2409]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    num_image_tokens=1024,  # stub patch embeddings prepended to the sequence
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, num_image_tokens=8, param_dtype="float32",
        compute_dtype="float32", remat="none", attn_chunk=64,
    )
