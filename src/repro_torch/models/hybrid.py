"""Zamba2-style hybrid: Mamba2 backbone with a *shared-weights* attention
block applied every ``attn_every`` layers; port of
:mod:`repro.models.hybrid`. [arXiv:2411.15242]

Layer layout for num_layers=L, attn_every=k:
  repeat n_super = L // k times:  [k x mamba block] + shared attention block
  then n_tail = L % k trailing mamba blocks.

The mamba parameters are stacked two levels deep, ``super`` as
(n_super, k, ...) and ``tail`` as (n_tail, ...), the reference's layout;
the port loops over both levels.  The shared attention block's parameters
are the same at every super-block, which is the weight sharing of the
paper; each super-block has its own KV cache.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.params import stack_schemas
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

Params = Any


def _counts(cfg: ModelConfig):
    n_super = cfg.num_layers // cfg.attn_every
    n_tail = cfg.num_layers % cfg.attn_every
    return n_super, cfg.attn_every, n_tail


def shared_attn_schema(cfg: ModelConfig):
    return {
        "ln1": L.norm_schema(cfg),
        "attn": L.attention_schema(cfg),
        "ln2": L.norm_schema(cfg),
        "mlp": L.mlp_schema(cfg),
    }


def schema(cfg: ModelConfig):
    n_super, per, n_tail = _counts(cfg)
    sch = {
        "embed": L.embedding_schema(cfg),
        "shared_attn": shared_attn_schema(cfg),
        "ln_f": L.norm_schema(cfg),
    }
    if n_super:
        sch["super"] = stack_schemas(
            stack_schemas(M.mamba_schema(cfg), per, "layers_inner"),
            n_super,
        )
    if n_tail:
        sch["tail"] = stack_schemas(M.mamba_schema(cfg), n_tail)
    return sch


def _attn_block(ap, x, cfg, positions, cache_kv=None, cache_pos=None):
    x = constrain(x, ("batch", "seq", "embed"))
    h = L.apply_norm(ap["ln1"], x, cfg)
    cache = None if cache_kv is None else {"k": cache_kv[0], "v": cache_kv[1]}
    attn_out, new_cache = L.attention_layer(
        ap["attn"], h, cfg, positions=positions, causal=True,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + attn_out
    h2 = L.apply_norm(ap["ln2"], x, cfg)
    x = x + L.mlp_layer(ap["mlp"], h2, cfg)
    new_kv = None if new_cache is None else (new_cache["k"], new_cache["v"])
    return x, new_kv


def _mamba_residual(mp, x, cfg, conv_state=None, ssm_state=None,
                    decode=False):
    x = constrain(x, ("batch", "seq", "embed"))
    y, states = M.mamba_block(
        mp, x, cfg, conv_state=conv_state, ssm_state=ssm_state, decode=decode
    )
    return x + y, states


def forward(params, cfg: ModelConfig, batch, return_hidden: bool = False):
    tokens = batch["tokens"]
    seq = tokens.shape[1]
    positions = torch.arange(seq, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg, positions)
    n_super, per, n_tail = _counts(cfg)
    sa = params["shared_attn"]

    def inner_fn(h, mp):
        return _mamba_residual(mp, h, cfg)[0]

    inner_fn = L.remat_wrap(inner_fn, cfg)
    for i in range(n_super):
        sp = L.layer(params["super"], i)
        for j in range(per):
            x = inner_fn(x, L.layer(sp, j))
        x, _ = _attn_block(sa, x, cfg, positions)
    for j in range(n_tail):
        x = inner_fn(x, L.layer(params["tail"], j))
    x = L.apply_norm(params["ln_f"], x, cfg)
    if return_hidden:
        return x, {}
    return L.unembed(params["embed"], x, cfg), {}


def unembed(params, x, cfg: ModelConfig):
    return L.unembed(params["embed"], x, cfg)


# -- serving -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: torch.device):
    n_super, per, n_tail = _counts(cfg)
    conv, ssm = M.init_mamba_state(cfg, batch_size, device)

    def stack(t, *ns):
        return t.expand(tuple(ns) + t.shape).clone()

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if n_super:
        kv_shape = (n_super, batch_size, max_len, cfg.num_kv_heads,
                    cfg.head_dim)
        cache["k"] = torch.zeros(kv_shape, dtype=cfg.dtype(), device=device)
        cache["v"] = torch.zeros(kv_shape, dtype=cfg.dtype(), device=device)
        cache["super_conv"] = stack(conv, n_super, per)
        cache["super_ssm"] = stack(ssm, n_super, per)
    if n_tail:
        cache["tail_conv"] = stack(conv, n_tail)
        cache["tail_ssm"] = stack(ssm, n_tail)
    return cache


def _run_cached(params, cfg, x, positions, cache, cache_pos, decode):
    """Every layer over ``x``, each state of ``cache`` written in place."""
    n_super, per, n_tail = _counts(cfg)
    sa = params["shared_attn"]

    def mamba(mp, h, conv, ssm):
        h, (ncs, nss) = _mamba_residual(
            mp, h, cfg, conv_state=conv, ssm_state=ssm, decode=decode)
        L.assign(conv, ncs)
        L.assign(ssm, nss)
        return h

    for i in range(n_super):
        sp = L.layer(params["super"], i)
        for j in range(per):
            x = mamba(L.layer(sp, j), x, cache["super_conv"][i, j],
                      cache["super_ssm"][i, j])
        x, _ = _attn_block(sa, x, cfg, positions,
                           cache_kv=(cache["k"][i], cache["v"][i]),
                           cache_pos=cache_pos)
    for j in range(n_tail):
        x = mamba(L.layer(params["tail"], j), x, cache["tail_conv"][j],
                  cache["tail_ssm"][j])
    return x


def prefill(params, cfg: ModelConfig, batch, cache):
    tokens = batch["tokens"]
    seq = tokens.shape[1]
    positions = torch.arange(seq, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg, positions)
    x = _run_cached(params, cfg, x, positions, cache, 0, decode=False)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg)
    cache["pos"].fill_(seq)
    return logits, cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache):
    pos = cache["pos"]
    positions = pos[None]
    x = L.embed_tokens(params["embed"], token, cfg, positions)
    x = _run_cached(params, cfg, x, positions, cache, pos, decode=True)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    pos.add_(1)
    return logits, cache
