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
activation-sharding hooks (``constrain``, ``sp_active`` of
:mod:`repro_torch.distributed.sharding`) sit where the reference's do; they
are identities without an activation mesh.
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
from repro_torch.distributed.sharding import (
    _ACT_RULES_BY_MODE, carry_mesh, constrain, get_activation_mesh,
    mesh_axes, mesh_shape, placements, sharding_mode, sp_active, spec_for,
)

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

def _divides_model_axis(n: int) -> bool:
    """Whether ``n`` heads split evenly over the activation mesh's
    ``model`` axis (True without a mesh)."""
    mesh = get_activation_mesh()
    if mesh is None:
        return True
    return n % dict(zip(mesh_axes(mesh), mesh_shape(mesh))).get("model", 1) == 0


def _gqa_reshape(q: torch.Tensor, num_kv_heads: int) -> torch.Tensor:
    b, s, h, d = q.shape
    if not _divides_model_axis(num_kv_heads):
        # DTensor cannot split a model-sharded head dim into kv groups
        # that do not divide the axis: gather the heads first
        q = constrain(q, ("batch", "seq", None, None))
    return q.reshape(b, s, num_kv_heads, h // num_kv_heads, d)


def _heads_whole(b: int, *ts: torch.Tensor) -> tuple:
    """``ts`` (B, S, heads, D) with their heads whole on every rank where
    the activation mesh's ``model`` axis does not divide the batch ``b``
    (else as they are).  The attention einsums flatten batch x heads, and
    DTensor cannot unflatten a model-sharded product whose leading batch
    the axis does not divide; the other placements are kept."""
    if _divides_model_axis(b):
        return ts
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def whole(t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p
              for p in t.placements]
        return t.redistribute(t.device_mesh, pl)

    return tuple(whole(t) for t in ts)


def _merge_heads(out: torch.Tensor, b: int, s: int, h: int, d: int,
                 kh: int) -> torch.Tensor:
    """(B, S, KH, G, D) -> (B, S, H, D).  Where :func:`_gqa_reshape`
    gathered the heads, the merged heads are held replicated too: the
    backward splits this merge again, and a gradient that arrives sharded
    over the heads could not be split into the kv groups."""
    out = out.reshape(b, s, h, d)
    if not _divides_model_axis(kh):
        out = constrain(out, ("batch", "seq", None, None))
    return out


def head_projection(eq: str, x: torch.Tensor, w: torch.Tensor,
                    n_heads: int) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of a (B, S, D) input and a (D, heads,
    head_dim) weight.  Under an activation mesh whose model axis does not
    divide ``n_heads``, DTensor would shard the flattened heads x head_dim
    columns over ``model`` and then fail to unflatten them, so there the
    product runs in ``local_map`` on the rows' shard with the weight
    gathered (the heads replicated, as the reference's rules leave them)."""
    if _divides_model_axis(n_heads):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor.experimental import local_map

    mesh = get_activation_mesh()
    x = constrain(x, ("batch", "seq", None))
    w = constrain(w, (None,) * w.ndim)
    out_axes = ("batch", "seq", None, None)
    out = placements(spec_for((x.shape[0], x.shape[1], w.shape[1],
                               w.shape[2]), out_axes,
                              _ACT_RULES_BY_MODE[sharding_mode()], mesh),
                     mesh)
    return local_map(lambda a, b: torch.einsum(eq, a, b),
                     out_placements=(out,),
                     in_placements=(x.placements, w.placements),
                     device_mesh=mesh)(x, w)


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
    q, k, v = _heads_whole(b, q, k, v)
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
    return _merge_heads(out, b, sq, h, d, kh).to(q.dtype)


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
    q, k_cache, v_cache = _heads_whole(b, q, k_cache, v_cache)
    qr = _gqa_reshape(q, kh).to(F32) * scale  # (B,1,KH,G,D)
    scores = torch.einsum("bqhgd,bshd->bqhgs", qr, k_cache.to(F32))
    kpos = torch.arange(s, dtype=torch.int32, device=q.device)
    scores = torch.where(kpos <= pos, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqhgs,bshd->bqhgd", probs, v_cache.to(F32))
    # under a mesh: a kv_seq-sharded cache leaves partial sums over its
    # shards; reduce them before the head merge (DTensor mis-sizes the
    # merge of a pending reduction)
    out = constrain(out, ("batch", None, None, None, None))
    return _merge_heads(out, b, 1, h, d, kh).to(q.dtype)


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


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` for a cache entry.  A DTensor entry keeps its
    placements: ``src`` is resharded to them and each rank writes its own
    shard (DTensor's in-place copy may re-place ``dst`` instead); a plain
    entry takes a DTensor ``src`` whole."""
    if _is_dtensor(dst):
        if not _is_dtensor(src):
            src = _replicated_on(src, dst.device_mesh)
        src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src.full_tensor() if _is_dtensor(src) else src)


def _replicated_on(x: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _write_sharded(buf, new: torch.Tensor, pos: Pos) -> None:
    """:func:`write_cache` into a DTensor cache whose seq dim (1) may be
    sharded (``kv_seq``): ``new`` is laid out as ``buf`` with its seq dim
    whole, and each rank writes the positions that fall in its own seq
    range.  A device ``pos`` touches ``min(s, cap_l)`` rows of the local
    shard (``cap_l`` its seq length), never the whole shard for ``s``
    new rows."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    pl = list(buf.placements)
    seq_dims = [i for i, q in enumerate(pl) if isinstance(q, Shard)
                and q.dim == 1]
    want = [Replicate() if i in seq_dims else q for i, q in enumerate(pl)]
    if not _is_dtensor(new):
        new = _replicated_on(new, mesh)
    new_l = new.redistribute(mesh, want).to_local().to(buf.dtype)
    buf_l = buf.to_local()
    coord = mesh.get_coordinate()
    lin = 0
    for i in seq_dims:  # the rank's seq block, mesh dims major to minor
        lin = lin * mesh.size(i) + coord[i]
    cap, cap_l, s = buf.shape[1], buf_l.shape[1], new.shape[1]
    off = lin * cap_l
    if isinstance(pos, torch.Tensor):
        if _is_dtensor(pos):
            pos = pos.to_local()
        start = torch.clamp(pos, 0, cap - s)
        if not seq_dims:  # the seq dim whole on every rank
            idx = start + torch.arange(s, device=buf_l.device)
            buf_l.index_copy_(1, idx, new_l)
        elif s < cap_l:
            # the s rows' indices in this shard; a row outside it writes
            # back the value at its index mod cap_l, which no row inside
            # writes (s < cap_l consecutive indices stay distinct mod
            # cap_l)
            idx = start - off + torch.arange(s, device=buf_l.device)
            tgt = torch.remainder(idx, cap_l)
            ok = ((idx >= 0) & (idx < cap_l)).reshape(
                (1, s) + (1,) * (buf_l.ndim - 2))
            rows = torch.where(ok, new_l, buf_l.index_select(1, tgt))
            buf_l.index_copy_(1, tgt, rows)
        else:  # s >= cap_l: each shard row takes its source row, if any
            src = torch.arange(cap_l, device=buf_l.device) + off - start
            ok = (src >= 0) & (src < s)
            rows = new_l.index_select(1, torch.clamp(src, 0, s - 1))
            ok = ok.reshape((1, cap_l) + (1,) * (buf_l.ndim - 2))
            buf_l.copy_(torch.where(ok, rows, buf_l))
    else:
        start = min(max(int(pos), 0), cap - s)
        a, b = max(start, off), min(start + s, off + cap_l)
        if a < b:
            buf_l[:, a - off:b - off].copy_(new_l[:, a - start:b - start])


def write_cache(buf: torch.Tensor, new: torch.Tensor, pos: Pos) -> None:
    """Write ``new`` (B, s, ...) into ``buf`` (B, S, ...) at sequence
    offset ``pos``, in place, with ``lax.dynamic_update_slice``'s clamp
    (the start moves back so the update fits).  A device ``pos`` is used
    as a device index (``index_copy_``), so nothing is read to the host.
    A DTensor ``buf`` is written shard by shard (:func:`_write_sharded`);
    a plain ``buf`` takes a DTensor ``new`` whole."""
    s, cap = new.shape[1], buf.shape[1]
    if s > cap:
        raise ValueError(f"{s} positions do not fit a cache of {cap}")
    if _is_dtensor(buf):
        _write_sharded(buf, new, pos)
        return
    if _is_dtensor(new):
        new = new.full_tensor()
    if _is_dtensor(pos):
        pos = pos.full_tensor()
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
    h, kh = cfg.num_heads, cfg.num_kv_heads
    q = head_projection("bsd,dhk->bshk", x, p["wq"].to(dt), h)
    k = head_projection("bsd,dhk->bshk", kv_src, p["wk"].to(dt), kh)
    v = head_projection("bsd,dhk->bshk", kv_src, p["wv"].to(dt), kh)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.pos_embed == "rope" and memory is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if sp_active() and x.shape[1] > 1:
        # sequence-parallel attention: queries stay seq-sharded over the
        # model axis; K/V are all-gathered
        q = constrain(q, ("batch", "seq", None, None))
        k = constrain(k, ("batch", "full_seq", None, None))
        v = constrain(v, ("batch", "full_seq", None, None))

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
    first and then cast, the same values without casting the table.

    Under an activation mesh the table's embed dim is gathered first (the
    FSDP weight gather; rows stay vocab-sharded), and the rows are reduced
    over the vocab shards at once: DTensor's embedding strategy mis-sizes
    its vocab mask when the table's embed dim and the indices' batch dim
    share a mesh axis, and its pending vocab reduction can be applied only
    once."""
    table = constrain(table, ("vocab", None))
    rows = F.embedding(idx.long(), table)
    if _is_dtensor(rows):  # the vocab reduction first, then the layout
        from torch.distributed.tensor import Replicate

        rows = rows.redistribute(rows.device_mesh, [
            Replicate() if q.is_partial() else q for q in rows.placements])
        rows = constrain(rows, ("batch", "seq", "embed")[-rows.ndim:])
    return rows.to(dt)


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
        return checkpoint(carry_mesh(fn), *args, use_reentrant=False, **kw)

    return wrapped
