"""Dense decoder-only transformer (qwen / llama3 / smollm / command-r-plus)
and the pixtral VLM backbone (stub patch embeddings prepended); port of
:mod:`repro.models.transformer`.

Parameters are stacked along a leading ``layers`` dim, as the reference's
scan-over-layers lays them out; the port loops over that dim, and the
remat policy wraps each layer.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.common.params import Param, stack_schemas
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L

Params = Any


def block_schema(cfg: ModelConfig):
    sch = {
        "ln1": L.norm_schema(cfg),
        "attn": L.attention_schema(cfg),
        "mlp": L.mlp_schema(cfg),
    }
    if not cfg.parallel_block:
        sch["ln2"] = L.norm_schema(cfg)
    return sch


def schema(cfg: ModelConfig):
    sch = {
        "embed": L.embedding_schema(cfg),
        "layers": stack_schemas(block_schema(cfg), cfg.num_layers),
        "ln_f": L.norm_schema(cfg),
    }
    if cfg.family == "vlm":
        sch["img_proj"] = Param(
            (1024, cfg.d_model), (None, "embed"), init="scaled",
            dtype=cfg.pdtype(),
        )
    return sch


def _block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor, cache_kv: Optional[tuple] = None,
           cache_pos=None):
    """One transformer block. Returns (x, new_kv or None)."""
    x = constrain(x, ("batch", "seq", "embed"))
    h = L.apply_norm(lp["ln1"], x, cfg)
    cache = None
    if cache_kv is not None:
        cache = {"k": cache_kv[0], "v": cache_kv[1]}
    attn_out, new_cache = L.attention_layer(
        lp["attn"], h, cfg, positions=positions, causal=True,
        cache=cache, cache_pos=cache_pos,
    )
    if cfg.parallel_block:
        # command-r style: attn and mlp read the same normed input
        mlp_out = L.mlp_layer(lp["mlp"], h, cfg)
        x = x + attn_out + mlp_out
    else:
        x = x + attn_out
        h2 = L.apply_norm(lp["ln2"], x, cfg)
        x = x + L.mlp_layer(lp["mlp"], h2, cfg)
    new_kv = None if new_cache is None else (new_cache["k"], new_cache["v"])
    return x, new_kv


def _n_img(cfg: ModelConfig, batch) -> int:
    if cfg.family == "vlm" and batch.get("image_embeds") is not None:
        return batch["image_embeds"].shape[1]
    return 0


def _embed_inputs(params, cfg: ModelConfig, batch, positions):
    x = L.embed_tokens(params["embed"], batch["tokens"], cfg, positions)
    if _n_img(cfg, batch):
        img = torch.einsum(
            "bnv,vd->bnd", batch["image_embeds"].to(cfg.dtype()),
            params["img_proj"].to(cfg.dtype()),
        )
        x = torch.cat([img, x], dim=1)
    return x


def forward(params, cfg: ModelConfig, batch, return_hidden: bool = False):
    """Full-sequence causal forward. Returns (logits | hidden, aux)."""
    n_img = _n_img(cfg, batch)
    seq = batch["tokens"].shape[1] + n_img
    positions = torch.arange(seq, dtype=torch.int32,
                             device=batch["tokens"].device)
    x = _embed_inputs(params, cfg, batch, positions[n_img:])

    def layer_fn(h, lp):
        return _block(lp, h, cfg, positions)[0]

    layer_fn = L.remat_wrap(layer_fn, cfg)
    for i in range(cfg.num_layers):
        x = layer_fn(x, L.layer(params["layers"], i))
    x = L.apply_norm(params["ln_f"], x, cfg)
    x = x[:, n_img:, :]
    if return_hidden:
        return x, {}
    return L.unembed(params["embed"], x, cfg), {}


def unembed(params, x, cfg: ModelConfig):
    return L.unembed(params["embed"], x, cfg)


# -- serving ----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: torch.device):
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype(), device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype(), device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def _layers_with_cache(params, cfg, x, positions, cache, cache_pos):
    for i in range(cfg.num_layers):
        x, _ = _block(L.layer(params["layers"], i), x, cfg, positions,
                      cache_kv=(cache["k"][i], cache["v"][i]),
                      cache_pos=cache_pos)
    return x


def prefill(params, cfg: ModelConfig, batch, cache):
    """Process the full prompt, filling the cache in place. Returns
    (last_logits, cache)."""
    n_img = _n_img(cfg, batch)
    seq = batch["tokens"].shape[1] + n_img
    positions = torch.arange(seq, dtype=torch.int32,
                             device=batch["tokens"].device)
    x = _embed_inputs(params, cfg, batch, positions[n_img:])
    x = _layers_with_cache(params, cfg, x, positions, cache, 0)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg)
    cache["pos"].fill_(seq)
    return logits, cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache):
    """One decode step, the cache updated in place. token: (B, 1) int.
    Returns (logits, cache)."""
    pos = cache["pos"]
    positions = pos[None]
    x = L.embed_tokens(params["embed"], token, cfg, positions)
    x = _layers_with_cache(params, cfg, x, positions, cache, pos)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    pos.add_(1)
    return logits, cache
