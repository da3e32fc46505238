"""zamba2-7b — hybrid: Mamba2 backbone + shared attention block every 6 layers.

[arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=2,
    conv_width=4,
    attn_every=6,  # one shared-weights attention block every 6 layers
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_groups=1,
        attn_every=2, param_dtype="float32", compute_dtype="float32",
        remat="none", attn_chunk=64,
    )
