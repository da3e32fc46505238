"""Plain PyTorch oracles of the kernels on the paper's compute-block path
(port of :mod:`repro.kernels.ref`: ``te_gemm_ref``, ``mha_ref``,
``fc_softmax_ref`` and ``dwconv_block_ref``).  Each computes the whole
function in fp32 with no tiling and casts once to the input's dtype; the
tests hold the kernels' twins and the execution plans to them."""
from __future__ import annotations

import torch


def te_gemm_ref(x, w, bias=None, epilogue: str = "none"):
    z = x.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        z = z + bias.to(torch.float32)
    if epilogue == "relu":
        z = torch.clamp_min(z, 0.0)
    elif epilogue == "silu":
        z = z * torch.sigmoid(z)
    elif epilogue == "softmax":
        z = torch.softmax(z, dim=-1)
    return z.to(x.dtype)


def mha_ref(q, k, v, causal: bool = True):
    """q, k, v: (BH, S, D)."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * (d ** -0.5)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)


def fc_softmax_ref(x, w, bias=None):
    z = x.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        z = z + bias.to(torch.float32)
    return torch.softmax(z, dim=-1).to(x.dtype)


def dwconv_block_ref(x_padded, dw, pw, gamma, beta, eps: float = 1e-5):
    """x_padded: (B, H+2, W+2, C); returns (B, H, W, F)."""
    b, hp, wp, c = x_padded.shape
    h, w = hp - 2, wp - 2
    xf = x_padded.to(torch.float32)
    dwf = dw.to(torch.float32)
    y = torch.zeros((b, h, w, c), dtype=torch.float32,
                    device=x_padded.device)
    for di in range(3):
        for dj in range(3):
            y = y + xf[:, di: di + h, dj: dj + w, :] * dwf[di, dj]
    z = torch.einsum("bhwc,cf->bhwf", y, pw.to(torch.float32))
    mu = torch.mean(z, dim=-1, keepdim=True)
    var = torch.mean(torch.square(z - mu), dim=-1, keepdim=True)
    z = (z - mu) * torch.rsqrt(var + eps)
    z = z * gamma.to(torch.float32) + beta.to(torch.float32)
    return torch.clamp_min(z, 0.0).to(x_padded.dtype)
