"""Shared model layers (port of :mod:`repro.models.layers`): norms, RoPE,
chunked attention (flash semantics), gated MLPs, embeddings.

All functions are pure apart from the serving cache, whose K/V tensors
:func:`attention_layer` writes in place at a device index (so a decode
step reads nothing back to the host).  Parameters are nested dicts built
from :mod:`repro_torch.common.params` schemas with the reference's logical
axes:

  batch, seq, kv_seq  — activation dims
  embed               — model width (residual stream)
  heads / kv_heads    — attention heads (tensor parallel)
  head_dim            — per-head width
  mlp                 — FFN hidden (tensor parallel)
  vocab               — embedding rows (tensor parallel)
  layers              — stacked-layer leading dim (the models loop over it)

Attention is a KV-chunked running-softmax loop, the online-softmax
semantics of FlashAttention, so the score matrix never materializes
beyond (q_len, chunk).  Products and attention are plain ``torch`` ops,
as the reference computes them in ``jnp`` outside any Pallas kernel.  The
reference's activation-sharding hooks (``constrain``, ``sp_active``) are
identities without an activation mesh, so the port has none.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.common.params import Param, tree_map
from repro_torch.configs.base import ModelConfig

Params = Any
Pos = Union[int, torch.Tensor]

NEG_INF = -1e30
F32 = torch.float32


def layer(stacked: Params, i) -> Params:
    """Layer ``i`` of a stacked-layer parameter (or state) tree: views of
    the leading dim."""
    return tree_map(lambda t: t[i], stacked)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_schema(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {
            "scale": Param((d,), ("embed",), init="ones"),
            "bias": Param((d,), ("embed",), init="zeros"),
        }
    return {"scale": Param((d,), ("embed",), init="ones")}


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(F32)
    if cfg.norm_type == "layernorm":
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(F32) + p["bias"].to(F32)
    else:  # rmsnorm
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + cfg.norm_eps)
        y = y * p["scale"].to(F32)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=F32, device=device) \
        / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(F32) * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked attention (online softmax: FlashAttention semantics in torch ops)
# ---------------------------------------------------------------------------

def _gqa_reshape(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv_heads, h // num_kv_heads, d)


def chunked_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KH, D)
    v: torch.Tensor,  # (B, Sk, KH, D)
    *,
    causal: bool,
    chunk_size: int,
    q_positions: torch.Tensor,  # (Sq,) absolute positions of queries
    kv_valid_len: Optional[Pos] = None,  # mask kv positions >= this
) -> torch.Tensor:
    """Online-softmax attention over KV chunks; scores in fp32.

    Peak memory per step is O(Sq * chunk) instead of O(Sq * Sk).  A KV
    length that is not a chunk multiple is zero-padded and the tail
    masked.
    """
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d**-0.5
    qr = _gqa_reshape(q, kh).to(F32) * scale  # (B,Sq,KH,G,D)

    chunk_size = min(chunk_size, sk)
    if sk % chunk_size:  # pad KV to a chunk multiple; padded tail is masked
        pad = chunk_size - sk % chunk_size
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid_len is None:
            kv_valid_len = sk
        sk = sk + pad
    n_chunks = sk // chunk_size
    kpos = torch.arange(sk, dtype=torch.int32, device=q.device)

    m = torch.full((b, sq, kh, g), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((b, sq, kh, g), dtype=F32, device=q.device)
    acc = torch.zeros((b, sq, kh, g, d), dtype=F32, device=q.device)
    for i in range(n_chunks):
        cut = slice(i * chunk_size, (i + 1) * chunk_size)
        kc, vc, kp = k[:, cut].to(F32), v[:, cut].to(F32), kpos[cut]
        s = torch.einsum("bqhgd,bchd->bqhgc", qr, kc)  # (B,Sq,KH,G,C)
        mask = torch.ones((sq, chunk_size), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (q_positions[:, None] >= kp[None, :])
        if kv_valid_len is not None:
            mask = mask & (kp[None, :] < kv_valid_len)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgc,bchd->bqhgd", p, vc)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KH, D)
    v_cache: torch.Tensor,
    pos: Pos,  # current position (0-based); a device scalar when decoding
) -> torch.Tensor:
    """Single-token attention against the whole KV cache, positions past
    ``pos`` masked (no host read of ``pos``)."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    scale = d**-0.5
    qr = _gqa_reshape(q, kh).to(F32) * scale  # (B,1,KH,G,D)
    scores = torch.einsum("bqhgd,bshd->bqhgs", qr, k_cache.to(F32))
    kpos = torch.arange(s, dtype=torch.int32, device=q.device)
    scores = torch.where(kpos <= pos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqhgs,bshd->bqhgd", probs, v_cache.to(F32))
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention layer (QKV proj + rope + attention + out proj, KV cache aware)
# ---------------------------------------------------------------------------

def attention_schema(cfg: ModelConfig, d_model: Optional[int] = None):
    d = d_model or cfg.d_model
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = cfg.pdtype()
    sch = {
        "wq": Param((d, h, hd), ("embed", "heads", "head_dim"), init="scaled", dtype=pd),
        "wk": Param((d, kh, hd), ("embed", "kv_heads", "head_dim"), init="scaled", dtype=pd),
        "wv": Param((d, kh, hd), ("embed", "kv_heads", "head_dim"), init="scaled", dtype=pd),
        "wo": Param((h, hd, d), ("heads", "head_dim", "embed"), init="scaled", dtype=pd),
    }
    if cfg.qkv_bias:
        sch["bq"] = Param((h, hd), ("heads", "head_dim"), init="zeros", dtype=pd)
        sch["bk"] = Param((kh, hd), ("kv_heads", "head_dim"), init="zeros", dtype=pd)
        sch["bv"] = Param((kh, hd), ("kv_heads", "head_dim"), init="zeros", dtype=pd)
    return sch


def write_cache(buf: torch.Tensor, new: torch.Tensor, pos: Pos) -> None:
    """Write ``new`` (B, s, ...) into ``buf`` (B, S, ...) at sequence
    offset ``pos``, in place, with ``lax.dynamic_update_slice``'s clamp
    (the start moves back so the update fits).  A device ``pos`` is used
    as a device index (``index_copy_``), so nothing is read to the host."""
    s, cap = new.shape[1], buf.shape[1]
    if s > cap:
        raise ValueError(f"{s} positions do not fit a cache of {cap}")
    new = new.to(buf.dtype)
    if isinstance(pos, torch.Tensor):
        start = torch.clamp(pos, 0, cap - s)
        idx = start + torch.arange(s, device=buf.device)
        buf.index_copy_(1, idx, new)
    else:
        start = min(max(int(pos), 0), cap - s)
        buf[:, start:start + s].copy_(new)


def attention_layer(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (S,) absolute positions
    causal: bool = True,
    cache: Optional[dict] = None,  # {"k": (B,Smax,KH,hd), "v": ...} or None
    cache_pos: Optional[Pos] = None,  # write offset in the cache
    memory: Optional[torch.Tensor] = None,  # (B, Sm, D) for cross-attention
):
    """Returns (out, new_cache); ``new_cache`` holds the cache's own K/V
    tensors, written in place at ``cache_pos``."""
    dt = cfg.dtype()
    x = x.to(dt)
    kv_src = memory if memory is not None else x
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", kv_src, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_src, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.pos_embed == "rope" and memory is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None and memory is None:
        write_cache(cache["k"], k, cache_pos)
        write_cache(cache["v"], v, cache_pos)
        new_cache = {"k": cache["k"], "v": cache["v"]}
        if x.shape[1] == 1:  # decode step
            out = decode_attention(q, cache["k"], cache["v"], cache_pos)
        else:  # prefill: attend within the freshly written prefix
            out = chunked_attention(
                q, k, v, causal=causal, chunk_size=cfg.attn_chunk,
                q_positions=positions,
            )
    else:
        out = chunked_attention(
            q, k, v, causal=causal and memory is None,
            chunk_size=cfg.attn_chunk, q_positions=positions,
        )
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = cfg.pdtype()
    if cfg.mlp_gated:
        return {
            "wi_gate": Param((d, f), ("embed", "mlp"), init="scaled", dtype=pd),
            "wi_up": Param((d, f), ("embed", "mlp"), init="scaled", dtype=pd),
            "wo": Param((f, d), ("mlp", "embed"), init="scaled", dtype=pd),
        }
    return {
        "wi": Param((d, f), ("embed", "mlp"), init="scaled", dtype=pd),
        "bi": Param((f,), ("mlp",), init="zeros", dtype=pd),
        "wo": Param((f, d), ("mlp", "embed"), init="scaled", dtype=pd),
        "bo": Param((d,), ("embed",), init="zeros", dtype=pd),
    }


def mlp_layer(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.dtype()
    x = x.to(dt)
    if cfg.mlp_gated:
        g = torch.einsum("bsd,df->bsf", x, p["wi_gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, p["wi_up"].to(dt))
        h = F.silu(g) * u
        return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt)) + p["bi"].to(dt)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt)) + p["bo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_schema(cfg: ModelConfig):
    pd = cfg.pdtype()
    sch = {
        "tok": Param(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
            init="normal", scale=0.02, dtype=pd,
        )
    }
    if not cfg.tie_embeddings:
        sch["unembed"] = Param(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
            init="scaled", dtype=pd,
        )
    if cfg.pos_embed == "learned":
        # sized for the largest assigned shape cell
        sch["pos"] = Param(
            (32768, cfg.d_model), (None, "embed"),
            init="normal", scale=0.01, dtype=pd,
        )
    return sch


def take_rows(table: torch.Tensor, idx: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """``jnp.take(table.astype(dt), idx, axis=0)``: the rows are gathered
    first and then cast, the same values without casting the table."""
    return F.embedding(idx.long(), table).to(dt)


def embed_tokens(p: Params, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = cfg.dtype()
    x = take_rows(p["tok"], tokens, dt)
    if cfg.pos_embed == "learned" and positions is not None:
        x = x + take_rows(p["pos"], positions, dt)[None, :, :]
    return x


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.dtype()
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["tok"].to(dt))
    return torch.einsum("bsd,dv->bsv", x, p["unembed"].to(dt))


# ---------------------------------------------------------------------------
# Remat policies
# ---------------------------------------------------------------------------

# the products whose outputs ``dots_saveable`` keeps for the backward
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_wrap(fn, cfg: ModelConfig):
    """``none``: ``fn``; ``full``: ``torch.utils.checkpoint`` (non-reentrant)
    saving nothing but the inputs; ``dots_saveable``: a selective
    checkpoint that saves the products' outputs and recomputes the rest.
    Outside grad mode ``fn`` runs as is (there is no backward to feed)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots_saveable":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"unknown remat policy {cfg.remat}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped
