"""Mamba2 (SSD: state-space duality) block: chunked-parallel training form +
recurrent decode form; port of :mod:`repro.models.mamba2`.
[arXiv:2405.21060]

The chunked form is GEMM-dominated (intra-chunk (Q x Q) score matmuls and
chunk-state outer products); the recurrent decode form is an elementwise
state update.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.common.params import Param
from repro_torch.configs.base import ModelConfig

Params = Any

SSM_CHUNK = 256
F32 = torch.float32


def mamba_schema(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.d_inner
    h = cfg.ssm_heads
    g, n, w = cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    conv_ch = di + 2 * g * n
    pd = cfg.pdtype()
    d_in_proj = 2 * di + 2 * g * n + h
    return {
        "in_proj": Param((d, d_in_proj), ("embed", "mlp"), init="scaled", dtype=pd),
        "conv_w": Param((w, conv_ch), (None, "mlp"), init="scaled", dtype=pd),
        "conv_b": Param((conv_ch,), ("mlp",), init="zeros", dtype=pd),
        "dt_bias": Param((h,), ("heads",), init="zeros", dtype=F32),
        "a_log": Param((h,), ("heads",), init="zeros", dtype=F32),
        "d_skip": Param((h,), ("heads",), init="ones", dtype=F32),
        "norm": Param((di,), ("mlp",), init="ones", dtype=pd),
        "out_proj": Param((di, d), ("mlp", "embed"), init="scaled", dtype=pd),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over seq. u: (B,S,C); w: (W,C); b: (C,).

    Returns (y, new_state) where state holds the last W-1 inputs.
    """
    width = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], width - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)  # (B, S+W-1, C)
    y = 0
    for i in range(width):  # Python's sum(): 0 + tap 0 + tap 1 + ...
        y = y + up[:, i: i + u.shape[1], :] * w[i][None, None, :]
    y = y + b[None, None, :]
    new_state = up[:, -(width - 1):, :]
    return F.silu(y), new_state


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z, xbc, dt = torch.split(proj, [di, di + 2 * g * n, cfg.ssm_heads],
                             dim=-1)
    return z, xbc, dt  # xbc: conv channels (x | B | C), dt: (…, H)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    x, bmat, cmat = torch.split(xbc, [di, g * n, g * n], dim=-1)
    return x, bmat, cmat


def _repeat_groups(t: torch.Tensor, hg: int) -> torch.Tensor:
    """``jnp.repeat(t, hg, axis=-2)``: each group's row once per head of
    the group (a broadcast, where ``torch.repeat_interleave`` may read its
    output size back to the host)."""
    *lead, g, n = t.shape
    return t[..., None, :].expand(*lead, g, hg, n).reshape(*lead, g * hg, n)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) — dt-scaled inputs NOT applied yet
    dt: torch.Tensor,  # (B, S, H) post-softplus
    a: torch.Tensor,  # (H,) negative
    bmat: torch.Tensor,  # (B, S, G, N)
    cmat: torch.Tensor,  # (B, S, G, N)
    *,
    chunk: int = SSM_CHUNK,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
):
    """Chunked SSD scan. Returns (y, final_state)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk:  # pad with identity steps (dt=0 -> decay 1, zero input)
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc = s // chunk

    xb = x.to(F32) * dt[..., None].to(F32)  # input-scaled
    # expand groups to heads
    bh = _repeat_groups(bmat.to(F32), hg)  # (B,S,H,N)
    ch = _repeat_groups(cmat.to(F32), hg)
    dtf = dt.to(F32)
    state = (initial_state.to(F32) if initial_state is not None
             else torch.zeros((b, h, n, p), dtype=F32, device=x.device))

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    ys = []
    for i in range(nc):
        cut = slice(i * chunk, (i + 1) * chunk)
        xck, dtk, bk, ck = xb[:, cut], dtf[:, cut], bh[:, cut], ch[:, cut]
        dlog = dtk * a[None, None, :]  # (B,Q,H) negative
        cum = torch.cumsum(dlog, dim=1)  # inclusive
        # intra-chunk: mask the exponent (not the product) so the upper
        # triangle never sees exp(+large) -> inf * 0 = NaN
        cb = torch.einsum("bqhn,bkhn->bhqk", ck, bk)
        cum_h = cum.transpose(1, 2)  # (B,H,Q)
        diff = cum_h[:, :, :, None] - cum_h[:, :, None, :]  # (B,H,Q,K)
        diff = torch.where(mask[None, None, :, :], diff, -torch.inf)
        m = cb * torch.exp(diff)
        y = torch.einsum("bhqk,bkhp->bqhp", m, xck)
        # inter-chunk contribution from carried state
        cdecay = torch.exp(cum)  # (B,Q,H)
        y = y + torch.einsum("bqhn,bhnp->bqhp", ck * cdecay[..., None], state)
        # state update
        end = cum[:, -1:, :]  # (B,1,H)
        sdecay = torch.exp(end - cum)  # (B,Q,H)
        s_chunk = torch.einsum("bqhn,bqhp->bhnp", bk * sdecay[..., None], xck)
        state = torch.exp(end[:, 0, :])[:, :, None, None] * state + s_chunk
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s_orig]
    return y, state


def ssd_decode_step(
    x: torch.Tensor,  # (B, 1, H, P)
    dt: torch.Tensor,  # (B, 1, H)
    a: torch.Tensor,  # (H,)
    bmat: torch.Tensor,  # (B, 1, G, N)
    cmat: torch.Tensor,  # (B, 1, G, N)
    state: torch.Tensor,  # (B, H, N, P)
):
    h = x.shape[2]
    hg = h // bmat.shape[2]
    xb = x[:, 0].to(F32) * dt[:, 0, :, None].to(F32)  # (B,H,P)
    bh = _repeat_groups(bmat[:, 0].to(F32), hg)  # (B,H,N)
    ch = _repeat_groups(cmat[:, 0].to(F32), hg)
    decay = torch.exp(dt[:, 0].to(F32) * a[None, :])  # (B,H)
    state = decay[:, :, None, None] * state + torch.einsum(
        "bhn,bhp->bhnp", bh, xb)
    y = torch.einsum("bhn,bhnp->bhp", ch, state)  # (B,H,P)
    return y[:, None], state


def mamba_block(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    conv_state: Optional[torch.Tensor] = None,
    ssm_state: Optional[torch.Tensor] = None,
    decode: bool = False,
):
    """Returns (y, (new_conv_state, new_ssm_state))."""
    dt_ = cfg.dtype()
    b, s, _ = x.shape
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state

    proj = torch.einsum("bsd,de->bse", x.to(dt_), p["in_proj"].to(dt_))
    z, xbc, dtr = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(
        xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_),
        state=conv_state if decode else None,
    )
    xs, bmat, cmat = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, s, h, pdim)
    bmat = bmat.reshape(b, s, g, n)
    cmat = cmat.reshape(b, s, g, n)
    dtv = F.softplus(dtr.to(F32) + p["dt_bias"][None, None, :])  # (B,S,H)
    a = -torch.exp(p["a_log"])  # (H,) negative

    if decode:
        y, new_ssm = ssd_decode_step(xs, dtv, a, bmat, cmat, ssm_state)
    else:
        y, new_ssm = ssd_chunked(
            xs, dtv, a, bmat, cmat, initial_state=ssm_state,
            chunk=min(SSM_CHUNK, s),
        )
    y = y + p["d_skip"][None, None, :, None] * xs.to(F32)
    y = y.reshape(b, s, cfg.d_inner).to(dt_)
    # gated RMSNorm (mamba2 style)
    y = y * F.silu(z)
    ms = torch.mean(torch.square(y.to(F32)), dim=-1, keepdim=True)
    y = (y.to(F32) * torch.rsqrt(ms + cfg.norm_eps)).to(dt_)
    y = y * p["norm"].to(dt_)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt_))
    return out, (new_conv, new_ssm)


def init_mamba_state(cfg: ModelConfig, batch_size: int,
                     device: torch.device):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return (
        torch.zeros((batch_size, cfg.conv_width - 1, conv_ch),
                    dtype=cfg.dtype(), device=device),
        torch.zeros(
            (batch_size, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
            dtype=F32, device=device),
    )
