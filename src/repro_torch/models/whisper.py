"""Whisper-style encoder-decoder backbone; port of
:mod:`repro.models.whisper`. [arXiv:2212.04356]

The conv/mel frontend is a STUB, as in the reference: ``input_specs``
provides precomputed frame embeddings (B, enc_ctx, d_model).  The encoder
is bidirectional; the decoder is causal with cross-attention and learned
positions.  Embeddings are tied (whisper ties the token embedding and the
unembedding).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.params import Param, stack_schemas
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L

Params = Any


def enc_block_schema(cfg: ModelConfig):
    return {
        "ln1": L.norm_schema(cfg),
        "attn": L.attention_schema(cfg),
        "ln2": L.norm_schema(cfg),
        "mlp": L.mlp_schema(cfg),
    }


def dec_block_schema(cfg: ModelConfig):
    return {
        "ln1": L.norm_schema(cfg),
        "self_attn": L.attention_schema(cfg),
        "ln2": L.norm_schema(cfg),
        "cross_attn": L.attention_schema(cfg),
        "ln3": L.norm_schema(cfg),
        "mlp": L.mlp_schema(cfg),
    }


def schema(cfg: ModelConfig):
    pd = cfg.pdtype()
    return {
        "embed": {
            "tok": Param((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                         init="normal", scale=0.02, dtype=pd),
            "pos": Param((32768, cfg.d_model), (None, "embed"),
                         init="normal", scale=0.01, dtype=pd),
        },
        "enc_pos": Param((cfg.enc_ctx, cfg.d_model), (None, "embed"),
                         init="normal", scale=0.01, dtype=pd),
        "enc_layers": stack_schemas(enc_block_schema(cfg), cfg.enc_layers),
        "ln_enc": L.norm_schema(cfg),
        "dec_layers": stack_schemas(dec_block_schema(cfg), cfg.num_layers),
        "ln_f": L.norm_schema(cfg),
    }


def encode(params, cfg: ModelConfig, audio_embeds: torch.Tensor
           ) -> torch.Tensor:
    """audio_embeds: (B, enc_ctx, d_model) stub frame embeddings."""
    dt = cfg.dtype()
    x = audio_embeds.to(dt) + params["enc_pos"].to(dt)[None]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)

    def layer_fn(h, lp):
        h = constrain(h, ("batch", "seq", "embed"))
        a = L.apply_norm(lp["ln1"], h, cfg)
        attn_out, _ = L.attention_layer(
            lp["attn"], a, cfg, positions=positions, causal=False
        )
        h = h + attn_out
        m = L.apply_norm(lp["ln2"], h, cfg)
        return h + L.mlp_layer(lp["mlp"], m, cfg)

    layer_fn = L.remat_wrap(layer_fn, cfg)
    for i in range(cfg.enc_layers):
        x = layer_fn(x, L.layer(params["enc_layers"], i))
    return L.apply_norm(params["ln_enc"], x, cfg)


def _dec_block(lp, x, cfg, positions, memory, cache_kv=None, cache_pos=None):
    x = constrain(x, ("batch", "seq", "embed"))
    h = L.apply_norm(lp["ln1"], x, cfg)
    cache = None if cache_kv is None else {"k": cache_kv[0], "v": cache_kv[1]}
    sa, new_cache = L.attention_layer(
        lp["self_attn"], h, cfg, positions=positions, causal=True,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + sa
    h2 = L.apply_norm(lp["ln2"], x, cfg)
    ca, _ = L.attention_layer(
        lp["cross_attn"], h2, cfg, positions=positions, causal=False,
        memory=memory,
    )
    x = x + ca
    h3 = L.apply_norm(lp["ln3"], x, cfg)
    x = x + L.mlp_layer(lp["mlp"], h3, cfg)
    new_kv = None if new_cache is None else (new_cache["k"], new_cache["v"])
    return x, new_kv


def _embed_dec(params, cfg, tokens, positions):
    dt = cfg.dtype()
    x = L.take_rows(params["embed"]["tok"], tokens, dt)
    return x + L.take_rows(params["embed"]["pos"], positions, dt)[None]


def forward(params, cfg: ModelConfig, batch, return_hidden: bool = False):
    tokens = batch["tokens"]
    memory = encode(params, cfg, batch["audio_embeds"])
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = _embed_dec(params, cfg, tokens, positions)

    def layer_fn(h, lp):
        return _dec_block(lp, h, cfg, positions, memory)[0]

    layer_fn = L.remat_wrap(layer_fn, cfg)
    for i in range(cfg.num_layers):
        x = layer_fn(x, L.layer(params["dec_layers"], i))
    x = L.apply_norm(params["ln_f"], x, cfg)
    if return_hidden:
        return x, {}
    return unembed(params, x, cfg), {}


def unembed(params, x, cfg: ModelConfig):
    return torch.einsum(
        "bsd,vd->bsv", x, params["embed"]["tok"].to(cfg.dtype()))


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: torch.device):
    kv = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=cfg.dtype(), device=device),
        "v": torch.zeros(kv, dtype=cfg.dtype(), device=device),
        "memory": torch.zeros((batch_size, cfg.enc_ctx, cfg.d_model),
                              dtype=cfg.dtype(), device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def _dec_layers_cached(params, cfg, x, positions, memory, cache, cache_pos):
    for i in range(cfg.num_layers):
        x, _ = _dec_block(L.layer(params["dec_layers"], i), x, cfg,
                          positions, memory,
                          cache_kv=(cache["k"][i], cache["v"][i]),
                          cache_pos=cache_pos)
    return x


def prefill(params, cfg: ModelConfig, batch, cache):
    tokens = batch["tokens"]
    memory = encode(params, cfg, batch["audio_embeds"])
    seq = tokens.shape[1]
    positions = torch.arange(seq, dtype=torch.int32, device=tokens.device)
    x = _embed_dec(params, cfg, tokens, positions)
    x = _dec_layers_cached(params, cfg, x, positions, memory, cache, 0)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = unembed(params, x[:, -1:, :], cfg)
    L.assign(cache["memory"], memory)
    cache["pos"].fill_(seq)
    return logits, cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache):
    pos = cache["pos"]
    positions = pos[None]
    x = _embed_dec(params, cfg, token, positions)
    x = _dec_layers_cached(params, cfg, x, positions, cache["memory"], cache,
                           pos)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = unembed(params, x, cfg)
    pos.add_(1)
    return logits, cache
