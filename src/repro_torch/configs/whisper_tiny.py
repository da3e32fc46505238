"""whisper-tiny — encoder-decoder; conv frontend is a STUB per assignment
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    enc_layers=4,
    enc_ctx=1500,  # stub audio frame embeddings
    norm_type="layernorm",
    pos_embed="learned",
    mlp_gated=False,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, enc_layers=2, enc_ctx=32,
        param_dtype="float32", compute_dtype="float32", remat="none",
        attn_chunk=64,
    )
