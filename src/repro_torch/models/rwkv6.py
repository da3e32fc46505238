"""RWKV6 ("Finch"): attention-free token mixing with data-dependent
per-channel decay; port of :mod:`repro.models.rwkv6`. [arXiv:2404.05892]

The WKV recurrence is elementwise state work with no GEMM inside it.  It
runs as a chunked scan: an outer loop over chunks of ``cfg.rwkv_chunk``
steps, each chunk rematerialized under grad (``torch.utils.checkpoint``),
bounding the backward's state storage to T/chunk state snapshots.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Param, stack_schemas
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L

Params = Any

LORA_MIX = 32
LORA_DECAY = 64
F32 = torch.float32
STATE_KEYS = ("tm_x", "wkv", "cm_x")


def time_mix_schema(cfg: ModelConfig):
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    pd = cfg.pdtype()
    return {
        "maa_x": Param((d,), ("embed",), init="zeros", dtype=pd),
        # interpolation anchors for w,k,v,r,g
        "maa_wkvrg": Param((5, d), (None, "embed"), init="zeros", dtype=pd),
        "mix_w1": Param((d, 5 * LORA_MIX), ("embed", None), init="scaled", dtype=pd),
        "mix_w2": Param((5, LORA_MIX, d), (None, None, "embed"), init="scaled", dtype=pd),
        "decay_base": Param((d,), ("embed",), init="zeros", dtype=F32),
        "decay_w1": Param((d, LORA_DECAY), ("embed", None), init="scaled", dtype=pd),
        "decay_w2": Param((LORA_DECAY, d), (None, "embed"), init="scaled", dtype=pd),
        "bonus": Param((h, hd), ("heads", "head_dim"), init="normal", scale=0.5, dtype=F32),
        "wr": Param((d, d), ("embed", "mlp"), init="scaled", dtype=pd),
        "wk": Param((d, d), ("embed", "mlp"), init="scaled", dtype=pd),
        "wv": Param((d, d), ("embed", "mlp"), init="scaled", dtype=pd),
        "wg": Param((d, d), ("embed", "mlp"), init="scaled", dtype=pd),
        "wo": Param((d, d), ("mlp", "embed"), init="scaled", dtype=pd),
        "ln_x_scale": Param((d,), ("embed",), init="ones", dtype=pd),
        "ln_x_bias": Param((d,), ("embed",), init="zeros", dtype=pd),
    }


def channel_mix_schema(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    pd = cfg.pdtype()
    return {
        "maa_k": Param((d,), ("embed",), init="zeros", dtype=pd),
        "maa_r": Param((d,), ("embed",), init="zeros", dtype=pd),
        "wk": Param((d, f), ("embed", "mlp"), init="scaled", dtype=pd),
        "wv": Param((f, d), ("mlp", "embed"), init="scaled", dtype=pd),
        "wr": Param((d, d), ("embed", "embed"), init="scaled", dtype=pd),
    }


def block_schema(cfg: ModelConfig):
    return {
        "ln1": L.norm_schema(cfg),
        "time_mix": time_mix_schema(cfg),
        "ln2": L.norm_schema(cfg),
        "channel_mix": channel_mix_schema(cfg),
    }


def schema(cfg: ModelConfig):
    return {
        "embed": L.embedding_schema(cfg),
        "ln_emb": L.norm_schema(cfg),
        "layers": stack_schemas(block_schema(cfg), cfg.num_layers),
        "ln_f": L.norm_schema(cfg),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); last: (B,1,D), the previous token's x (state)."""
    return torch.cat([last, x[:, :-1, :]], dim=1)


def _wkv_chunk(st, u, rc, kc, vc, wc):
    """The recurrence over one chunk's steps. Returns (state, outs)."""
    outs = []
    for t in range(rc.shape[1]):
        rt, kt, vt, wt = rc[:, t], kc[:, t], vc[:, t], wc[:, t]  # (B,H,*)
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt,
                                 u[None, :, :, None] * kv + st))
        st = wt[..., None] * st + kv
    return st, torch.stack(outs, dim=1)  # (B,Q,H,V)


def wkv_scan(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    w: torch.Tensor,  # (B, S, H, K) decay in (0,1)
    u: torch.Tensor,  # (H, K) bonus
    state: torch.Tensor,  # (B, H, K, V)
    chunk: int,
):
    """Chunked recurrent WKV. Returns (out (B,S,H,V), final_state)."""
    s = r.shape[1]
    r, k, v, w = (t.to(F32) for t in (r, k, v, w))
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:  # pad with identity steps: k=v=r=0, decay w=1
        pad = chunk - s % chunk
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        s = s + pad

    st, ys = state.to(F32), []
    for i in range(s // chunk):
        cut = slice(i * chunk, (i + 1) * chunk)
        args = (st, u, r[:, cut], k[:, cut], v[:, cut], w[:, cut])
        if torch.is_grad_enabled():
            st, out = checkpoint(_wkv_chunk, *args, use_reentrant=False)
        else:
            st, out = _wkv_chunk(*args)
        ys.append(out)
    return torch.cat(ys, dim=1)[:, :s_orig], st


def time_mix(
    p: Params, x: torch.Tensor, cfg: ModelConfig,
    last_x: torch.Tensor, state: torch.Tensor, chunk: int,
):
    """RWKV6 time mixing. Returns (out, (new_last_x, new_state))."""
    dt = cfg.dtype()
    b, s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    xprev = _token_shift(x, last_x)
    xx = xprev - x
    xxx = x + xx * p["maa_x"].to(dt)
    # data-dependent interpolation (ddlerp): (B,S,5,D)
    mix = torch.tanh(torch.einsum("bsd,de->bse", xxx, p["mix_w1"].to(dt)))
    # under a mesh: the 5 x LORA_MIX columns whole before the split (DTensor
    # cannot split a model-sharded dim into 5 groups)
    mix = constrain(mix, ("batch", "seq", None))
    mix = mix.reshape(b, s, 5, LORA_MIX)
    mix = torch.einsum("bsme,med->bsmd", mix, p["mix_w2"].to(dt))
    anchors = p["maa_wkvrg"].to(dt)[None, None]  # (1,1,5,D)
    xi = x[:, :, None, :] + xx[:, :, None, :] * (anchors + mix)
    xw, xk, xv, xr, xg = (xi[:, :, i, :] for i in range(5))

    rv = torch.einsum("bsd,de->bse", xr, p["wr"].to(dt))
    kv_ = torch.einsum("bsd,de->bse", xk, p["wk"].to(dt))
    vv = torch.einsum("bsd,de->bse", xv, p["wv"].to(dt))
    gv = F.silu(torch.einsum("bsd,de->bse", xg, p["wg"].to(dt)))

    dlora = torch.einsum(
        "bsd,de->bse",
        torch.tanh(torch.einsum("bsd,de->bse", xw, p["decay_w1"].to(dt))),
        p["decay_w2"].to(dt),
    )
    logw = p["decay_base"][None, None, :] + dlora.to(F32)
    w = torch.exp(-torch.exp(logw.clamp(-6.0, 2.0)))  # (B,S,D) in (0,1)

    def heads(t):
        return t.reshape(b, s, h, hd)

    out, new_state = wkv_scan(
        heads(rv), heads(kv_), heads(vv), heads(w), p["bonus"], state, chunk
    )
    # per-head group norm (jnp.var: the mean of the squared deviations)
    oh = out.reshape(b, s, h, hd)
    mu = torch.mean(oh, dim=-1, keepdim=True)
    var = torch.mean(torch.square(oh - mu), dim=-1, keepdim=True)
    oh = (oh - mu) * torch.rsqrt(var + 64e-5)
    out = oh.reshape(b, s, d).to(dt)
    out = out * p["ln_x_scale"].to(dt) + p["ln_x_bias"].to(dt)
    out = out * gv
    out = torch.einsum("bse,ed->bsd", out, p["wo"].to(dt))
    return out, (x[:, -1:, :], new_state)


def channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                last_x: torch.Tensor):
    dt = cfg.dtype()
    xprev = _token_shift(x, last_x)
    xx = xprev - x
    xk = x + xx * p["maa_k"].to(dt)
    xr = x + xx * p["maa_r"].to(dt)
    kv_ = torch.square(
        F.relu(torch.einsum("bsd,df->bsf", xk, p["wk"].to(dt))))
    out = torch.sigmoid(
        torch.einsum("bsd,de->bse", xr, p["wr"].to(dt))
    ) * torch.einsum("bsf,fd->bsd", kv_, p["wv"].to(dt))
    return out, x[:, -1:, :]


def _block(lp, x, cfg, states, chunk):
    """states: dict(tm_x (B,1,D), wkv (B,H,K,V), cm_x (B,1,D))."""
    x = constrain(x, ("batch", "seq", "embed"))
    h1 = L.apply_norm(lp["ln1"], x, cfg)
    tm_out, (tm_x, wkv) = time_mix(
        lp["time_mix"], h1, cfg, states["tm_x"], states["wkv"], chunk
    )
    x = x + tm_out
    h2 = L.apply_norm(lp["ln2"], x, cfg)
    cm_out, cm_x = channel_mix(lp["channel_mix"], h2, cfg, states["cm_x"])
    x = x + cm_out
    return x, {"tm_x": tm_x, "wkv": wkv, "cm_x": cm_x}


def init_states(cfg: ModelConfig, batch_size: int, device: torch.device):
    d, h, hd, n = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_layers
    return {
        "tm_x": torch.zeros((n, batch_size, 1, d), dtype=cfg.dtype(),
                            device=device),
        "wkv": torch.zeros((n, batch_size, h, hd, hd), dtype=F32,
                           device=device),
        "cm_x": torch.zeros((n, batch_size, 1, d), dtype=cfg.dtype(),
                            device=device),
    }


def _run(params, cfg: ModelConfig, x, states, chunk, write: bool):
    """Every layer over ``x`` from ``states``; with ``write`` each layer's
    new states are written into ``states`` in place."""
    def layer_fn(h, lp, st):
        h, new = _block(lp, h, cfg, st, chunk)
        return h, new

    layer_fn = L.remat_wrap(layer_fn, cfg)
    for i in range(cfg.num_layers):
        st = L.layer(states, i)
        x, new = layer_fn(x, L.layer(params["layers"], i), st)
        if write:
            for key in STATE_KEYS:
                L.assign(st[key], new[key])
    return x


def forward(params, cfg: ModelConfig, batch, return_hidden: bool = False):
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = L.apply_norm(params["ln_emb"], x, cfg)
    states = init_states(cfg, tokens.shape[0], tokens.device)
    x = _run(params, cfg, x, states, cfg.rwkv_chunk, write=False)
    x = L.apply_norm(params["ln_f"], x, cfg)
    if return_hidden:
        return x, {}
    return L.unembed(params["embed"], x, cfg), {}


def unembed(params, x, cfg: ModelConfig):
    return L.unembed(params["embed"], x, cfg)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               device: torch.device):
    cache = init_states(cfg, batch_size, device)
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    return cache


def prefill(params, cfg: ModelConfig, batch, cache):
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    x = L.apply_norm(params["ln_emb"], x, cfg)
    states = {k: cache[k] for k in STATE_KEYS}
    x = _run(params, cfg, x, states, cfg.rwkv_chunk, write=True)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg)
    cache["pos"].fill_(tokens.shape[1])
    return logits, cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache):
    x = L.embed_tokens(params["embed"], token, cfg)
    x = L.apply_norm(params["ln_emb"], x, cfg)
    states = {k: cache[k] for k in STATE_KEYS}
    x = _run(params, cfg, x, states, 1, write=True)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    cache["pos"].add_(1)
    return logits, cache
