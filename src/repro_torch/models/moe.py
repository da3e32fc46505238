"""Mixture-of-Experts transformer (moonshot-v1-16b-a3b, dbrx-132b); port of
:mod:`repro.models.moe`.

Expert dispatch is sort-based with a capacity bound (GShard-style dropping,
MegaBlocks-style sorted grouping): assignments are sorted by expert id,
ranked within their expert group, and placed into an (E, C) slot grid.  The
two large data movements are pure gathers (dispatch: slot -> token row;
combine: assignment -> slot row).

Under an activation mesh with several data shards that divide the tokens,
dispatch and combine run per data shard with a per-shard capacity, as
the reference's ``shard_map`` branch: DTensor's ``local_map`` hands each
rank its token rows, each model rank keeps the block of experts it owns
(``mesh.get_local_rank("model")``, the reference's ``axis_index``), and
the combine's per-shard partial sums leave ``local_map`` as a ``Partial``
placement over ``model``, which the next constraint all-reduces (the
reference's ``psum``).  The index work (sort, ``scatter_add_``) has no
DTensor sharding strategy, so under a mesh the local path runs it in
``local_map`` on replicated tokens as well.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.common.params import Param, stack_schemas
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L

Params = Any


def moe_mlp_schema(cfg: ModelConfig):
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    pd = cfg.pdtype()
    sch = {
        "router": Param((d, e), ("embed", None), init="scaled", dtype=torch.float32),
        "wi_gate": Param((e, d, f), ("expert", "embed", "mlp"), init="scaled", dtype=pd),
        "wi_up": Param((e, d, f), ("expert", "embed", "mlp"), init="scaled", dtype=pd),
        "wo": Param((e, f, d), ("expert", "mlp", "embed"), init="scaled", dtype=pd),
    }
    if cfg.num_shared_experts > 0:
        sch["shared"] = L.mlp_schema(cfg, cfg.num_shared_experts * cfg.d_ff)
    return sch


def expert_capacity(
    cfg: ModelConfig, num_tokens: int, factor: float | None = None
) -> int:
    cf = cfg.capacity_factor if factor is None else factor
    cap = int(math.ceil(num_tokens * cfg.top_k / cfg.num_experts * cf))
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8


def _capacity(cfg: ModelConfig, t: int, serving: bool) -> int:
    if serving:
        # decode-sized batches get exact no-drop dispatch; large prefills use
        # a generous 2x capacity (drops rare; standard serving trade-off)
        if t * cfg.top_k <= 8192:
            return t * cfg.top_k
        return min(t * cfg.top_k, expert_capacity(cfg, t, factor=2.0))
    return expert_capacity(cfg, t)


def top_k(probs: torch.Tensor, k: int) -> tuple:
    """``jax.lax.top_k``: the ``k`` largest values of the last dim and
    their indices, ties to the lower index.  ``torch.topk`` documents no
    order among equal values on either device, so this is a stable
    descending sort, which keeps the lower index first on the CPU and on
    CUDA alike."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(idx: torch.Tensor, t: int, k: int, e: int, c: int):
    """Sort-based slot assignment for t tokens (pure index work, local).

    Returns (slot_token (E*C,), slot_of_assign (t*k,)), int64;
    sentinel = t / E*C.  An assignment ranked past its expert's capacity
    is dropped (the reference's ``mode="drop"`` scatter): it writes to a
    spare slot that is cut off.
    """
    flat_e = idx.reshape(-1).long()  # (t*k,)
    dev = flat_e.device
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    # a fixed e-length count (torch.bincount sizes its output from the data)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    group_start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(t * k, device=dev) - group_start[sorted_e]
    valid = rank < c
    slot = torch.where(valid, sorted_e * c + rank, e * c)
    token_of_assign = sort_idx // k
    slot_token = torch.full((e * c + 1,), t, dtype=torch.int64, device=dev)
    slot_token = slot_token.scatter(0, slot, token_of_assign)[: e * c]
    slot_of_assign = torch.full((t * k,), e * c, dtype=torch.int64,
                                device=dev)
    slot_of_assign = slot_of_assign.scatter(0, sort_idx, slot)
    return slot_token, slot_of_assign


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shd.mesh_axes(mesh))


def moe_mlp_layer(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  serving: bool = False, mesh=None):
    """x: (B, S, D). Returns (y, aux) with router load-balance loss.

    Dispatch and combine are local per data shard (per-shard capacity)
    when the mesh (``mesh``, else the activation mesh) has several data
    shards dividing the tokens (:func:`_sharded_dispatch`); otherwise the
    tokens form one shard.
    """
    dt = cfg.dtype()
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xt = x.reshape(t, d)

    # --- routing (fp32) ---
    # a bf16 router (serving params cast whole) promotes to fp32, as jnp's
    logits = torch.einsum("td,de->te", xt.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    gate, idx = top_k(probs, k)  # (T, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=0)
    # one-hot by comparison (F.one_hot validates its input on the host)
    one_hot = idx[..., None] == torch.arange(e, device=idx.device)
    ce = torch.mean(torch.sum(one_hot.to(torch.float32), dim=1), dim=0)
    aux_loss = e * torch.sum(me * ce) / k

    mesh = shd.get_activation_mesh() if mesh is None else mesh
    if mesh is not None:
        sizes = dict(zip(shd.mesh_axes(mesh), shd.mesh_shape(mesh)))
        dp_axes = _dp_axes(mesh)
        dp = math.prod(sizes[a] for a in dp_axes)
        if not (dp > 1 and t % dp == 0):  # the tokens form one shard
            dp_axes = ()
        y = _sharded_dispatch(p, xt, idx, gate, cfg, serving, mesh, dp_axes)
        if dp_axes and b % dp:
            # the tokens split over the data shards but the rows do not:
            # gather them, as DTensor cannot unflatten the rows
            y = _tokens_whole(y)
    else:
        x_disp, soa = _dispatch_local(cfg, xt, idx, t, e, k, serving)
        y_e = _expert_ffn(p, x_disp.to(dt), cfg)
        y = _combine_local(y_e, soa, gate, t, e, k, d)

    if cfg.num_shared_experts > 0:
        y = y + L.mlp_layer(p["shared"], xt[None], cfg).reshape(t, d)

    return y.reshape(b, s, d).to(dt), aux_loss


def _tokens_whole(y):
    """``y`` (T, D) with its tokens whole on every rank (its other
    placements kept)."""
    from torch.distributed.tensor import Replicate, Shard

    pl = [Replicate() if isinstance(q, Shard) and q.dim == 0 else q
          for q in y.placements]
    return y.redistribute(y.device_mesh, pl)


def _placements_on(mesh, dims: dict) -> tuple:
    """Placements from {mesh axis: placement}; Replicate elsewhere."""
    from torch.distributed.tensor import Replicate

    return tuple(dims.get(a, Replicate()) for a in shd.mesh_axes(mesh))


def _sharded_dispatch(p, xt, idx, gate, cfg, serving, mesh, dp_axes):
    """The reference's ``shard_map`` branch: per-data-shard dispatch with
    per-shard capacity, expert-parallel FFN, per-shard combine summed over
    the model axis.  With no ``dp_axes`` (data shards that do not divide
    the tokens) the rows stay whole on every rank: the slots and capacity
    of the local path, the FFN still expert-parallel."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    dt = cfg.dtype()
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.top_k
    sizes = dict(zip(shd.mesh_axes(mesh), shd.mesh_shape(mesh)))
    t_loc = t // math.prod(sizes[a] for a in dp_axes)
    c_loc = _capacity(cfg, t_loc, serving)
    tp = sizes.get("model", 1)
    ep = tp if (tp > 1 and e % tp == 0) else 1
    e_loc = e // ep
    disp_ax = "dispatch" if dp_axes else None

    def on(tensor_dim_of_dp, model=None):
        dims = {a: Shard(tensor_dim_of_dp) for a in dp_axes}
        if model is not None:
            dims["model"] = model
        return _placements_on(mesh, dims)

    rows = on(0)  # (t, ...) rows over the data shards, replicated on model
    xt = constrain(xt, (disp_ax, None))
    idx = constrain(idx, (disp_ax, None))
    gate = constrain(gate, (disp_ax, None))

    def disp(xt_l, idx_l):
        # local slot assignment + gather; each model shard slices the block
        # of experts it owns (no communication at all)
        st, soa_l = _dispatch_indices(idx_l, t_loc, k, e, c_loc)
        x_pad = torch.cat([xt_l, xt_l.new_zeros((1, d))], dim=0)
        x_disp_full = x_pad[st].reshape(e, c_loc, d)
        if ep > 1:
            me = mesh.get_local_rank("model")
            x_disp_full = x_disp_full[me * e_loc:(me + 1) * e_loc]
        return x_disp_full, soa_l

    disp_out = on(1, Shard(0) if ep > 1 else None)
    x_disp, soa = local_map(
        disp, out_placements=(disp_out, rows), in_placements=(rows, rows),
        device_mesh=mesh)(xt, idx)
    # expert-parallel grouped GEMMs: weights are EP-sharded over model, so
    # each shard runs a local grouped GEMM
    x_disp = constrain(x_disp.to(dt), ("expert", disp_ax, "embed"))
    y_e = _expert_ffn(p, x_disp, cfg)
    y_e = constrain(y_e, ("expert", disp_ax, "embed"))

    def comb(y_l, soa_l, gate_l):
        # per-model-shard partial combine: each shard sums the
        # contributions of its own experts
        n_loc = y_l.shape[0] * c_loc
        offset = mesh.get_local_rank("model") * n_loc if ep > 1 else 0
        local = soa_l - offset
        ok = (local >= 0) & (local < n_loc)
        y_pad = torch.cat([y_l.reshape(n_loc, d), y_l.new_zeros((1, d))],
                          dim=0)
        y_flat = y_pad[torch.where(ok, local, n_loc)]  # (t_loc*k, d)
        return torch.sum(
            y_flat.reshape(t_loc, k, d) * gate_l[..., None].to(y_flat.dtype),
            dim=1)

    y = local_map(
        comb, out_placements=(on(0, Partial() if ep > 1 else None),),
        in_placements=(y_e.placements, rows, rows), device_mesh=mesh,
    )(y_e, soa, gate)
    # the partial sums of the model shards, all-reduced (the reference's
    # psum over "model")
    return constrain(y, (disp_ax, None))


def _expert_ffn(p: Params, x_disp: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.dtype()
    g = torch.einsum("ecd,edf->ecf", x_disp, p["wi_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", x_disp, p["wi_up"].to(dt))
    h = F.silu(g) * u
    return torch.einsum("ecf,efd->ecd", h, p["wo"].to(dt))


def _dispatch_local(cfg, xt, idx, t, e, k, serving):
    c = _capacity(cfg, t, serving)
    st, soa = _dispatch_indices(idx, t, k, e, c)
    x_pad = torch.cat([xt, xt.new_zeros((1, xt.shape[1]))], dim=0)
    x_disp = x_pad[st].reshape(e, c, xt.shape[1])
    return x_disp, soa


def _combine_local(y_e, soa, gate, t, e, k, d):
    y_pad = torch.cat([y_e.reshape(-1, d), y_e.new_zeros((1, d))], dim=0)
    y_flat = y_pad[soa]
    return torch.sum(
        y_flat.reshape(t, k, d) * gate[..., None].to(y_flat.dtype), dim=1)


# --- full model (same block layout as the dense transformer) ---------------

def block_schema(cfg: ModelConfig):
    return {
        "ln1": L.norm_schema(cfg),
        "attn": L.attention_schema(cfg),
        "ln2": L.norm_schema(cfg),
        "moe": moe_mlp_schema(cfg),
    }


def schema(cfg: ModelConfig):
    return {
        "embed": L.embedding_schema(cfg),
        "layers": stack_schemas(block_schema(cfg), cfg.num_layers),
        "ln_f": L.norm_schema(cfg),
    }


def _block(lp, x, cfg, positions, cache_kv=None, cache_pos=None,
           serving=False):
    x = constrain(x, ("batch", "seq", "embed"))
    h = L.apply_norm(lp["ln1"], x, cfg)
    cache = None if cache_kv is None else {"k": cache_kv[0], "v": cache_kv[1]}
    attn_out, new_cache = L.attention_layer(
        lp["attn"], h, cfg, positions=positions, causal=True,
        cache=cache, cache_pos=cache_pos,
    )
    x = x + attn_out
    h2 = L.apply_norm(lp["ln2"], x, cfg)
    mlp_out, aux = moe_mlp_layer(lp["moe"], h2, cfg, serving=serving)
    x = x + mlp_out
    new_kv = None if new_cache is None else (new_cache["k"], new_cache["v"])
    return x, new_kv, aux


def forward(params, cfg: ModelConfig, batch, return_hidden: bool = False):
    tokens = batch["tokens"]
    seq = tokens.shape[1]
    positions = torch.arange(seq, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg, positions)

    def layer_fn(h, lp):
        h, _, aux = _block(lp, h, cfg, positions)
        return h, aux

    layer_fn = L.remat_wrap(layer_fn, cfg)
    auxes = []
    for i in range(cfg.num_layers):
        x, aux = layer_fn(x, L.layer(params["layers"], i))
        auxes.append(aux)
    x = L.apply_norm(params["ln_f"], x, cfg)
    aux = {"router_loss": torch.mean(torch.stack(auxes))
           * cfg.router_aux_coef}
    if return_hidden:
        return x, aux
    return L.unembed(params["embed"], x, cfg), aux


def unembed(params, x, cfg: ModelConfig):
    return L.unembed(params["embed"], x, cfg)


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
        x, _, _ = _block(L.layer(params["layers"], i), x, cfg, positions,
                         cache_kv=(cache["k"][i], cache["v"][i]),
                         cache_pos=cache_pos, serving=True)
    return x


def prefill(params, cfg: ModelConfig, batch, cache):
    tokens = batch["tokens"]
    seq = tokens.shape[1]
    positions = torch.arange(seq, dtype=torch.int32, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens, cfg, positions)
    x = _layers_with_cache(params, cfg, x, positions, cache, 0)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:, :], cfg)
    cache["pos"].fill_(seq)
    return logits, cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache):
    pos = cache["pos"]
    positions = pos[None]
    x = L.embed_tokens(params["embed"], token, cfg, positions)
    x = _layers_with_cache(params, cfg, x, positions, cache, pos)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)
    pos.add_(1)
    return logits, cache
