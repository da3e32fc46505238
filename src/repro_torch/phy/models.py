"""Neural AI-PHY models (port of :mod:`repro.phy.models`):

  DeepRxLite: a fully-convolutional residual receiver (the DeepRx family):
    input feature grid (Y, pilot LS estimates, pilot flag, noise) -> bit
    LLRs for the whole slot.
  CEViT: an attention-based channel estimator (the CE-ViT / MAT family):
    refines comb LS estimates into a full-grid channel estimate.

The public functions keep the reference's layouts: NHWC feature grids,
HWIO conv weights, and parameters as the reference's nested dicts (built
from the same schemas by :mod:`repro_torch.common.params`).

Every conv (as im2col, columns in (kh, kw, cin) order, cin fastest, which
is ``w.reshape(kh*kw*cin, cout)``) and every linear goes through
:func:`repro_torch.kernels.te_gemm.te_gemm`, and attention through
:func:`repro_torch.kernels.mha.mha`, at every shape: on a CUDA tensor
these are the hand-written kernels, which mask their own edges, so the
reference's 128-divisibility fallback and K padding (TPU tiling) have no
counterpart here; on a CPU tensor they are the plain twins.  Both carry a
gradient (``te_gemm.TeGemmFunction``, ``mha.MhaFunction``: the kernel
forward, a plain torch backward), so CE-ViT and DeepRx train on the card
through their kernels (:mod:`repro_torch.train.neural_receiver`); the
reference trains on its jnp path, which has no kernel.  Serving runs under
``torch.no_grad()`` and takes the kernels alone.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.common.params import Param, init_params, params_from_numpy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.mha import mha
from repro_torch.kernels.rx_fused import noise_var_rows
from repro_torch.kernels.te_gemm import te_gemm


# ---------------------------------------------------------------------------
# DeepRxLite: conv ResNet over the (symbols, subcarriers) grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeepRxConfig:
    channels: int = 64
    blocks: int = 4
    bits_per_re: int = 4  # 16-QAM
    in_features: int = 6  # Re/Im of Y, Re/Im of H_ls, pilot flag, noise


def _conv_schema(cin, cout, k=3):
    return {
        "w": Param((k, k, cin, cout), (None, None, None, "mlp"), init="scaled"),
        "b": Param((cout,), ("mlp",), init="zeros"),
    }


def deeprx_schema(cfg: DeepRxConfig):
    c = cfg.channels
    return {
        "conv_in": _conv_schema(cfg.in_features, c),
        "blocks": [
            {"conv1": _conv_schema(c, c), "conv2": _conv_schema(c, c)}
            for _ in range(cfg.blocks)
        ],
        "conv_out": _conv_schema(c, cfg.bits_per_re, k=1),
    }


def im2col(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, kh*kw*C) SAME-padded patches, columns in
    (kh, kw, cin) order with cin fastest (``F.unfold`` orders them
    (cin, kh, kw) instead)."""
    b, h, w, c = x.shape
    if kh == 1 and kw == 1:
        return x.reshape(b * h * w, c)
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1).reshape(b * h * w, kh * kw * c)


def conv2d(p, x: torch.Tensor, epilogue: str = "none") -> torch.Tensor:
    """SAME stride-1 NHWC conv with an HWIO weight as one TE GEMM over the
    im2col patches; bias and ``epilogue`` are fused into the GEMM."""
    w = p["w"]
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    out = te_gemm(im2col(x, kh, kw), w.reshape(kh * kw * cin, cout), p["b"],
                  epilogue=epilogue)
    return out.reshape(b, h, wd, cout)


def deeprx_apply(params, cfg: DeepRxConfig, feats: torch.Tensor
                 ) -> torch.Tensor:
    """feats: (B, n_sym, n_sc, in_features) -> LLRs (B, n_sym, n_sc, bits)."""
    x = conv2d(params["conv_in"], feats, "relu")
    for bp in params["blocks"]:
        h = conv2d(bp["conv1"], x, "relu")
        h = conv2d(bp["conv2"], h)
        x = torch.relu(x + h)
    return conv2d(params["conv_out"], x)


def deeprx_features(slot: dict, h_ls: torch.Tensor) -> torch.Tensor:
    """Assemble the SISO input feature grid from a slot with ``y``
    (B, n_sym, n_sc), ``pilot_mask`` (n_sym, n_sc) and ``noise_var`` (a
    scalar or one per slot) and an LS estimate (B, n_sc)."""
    y = slot["y"]
    shape = y.shape
    hls = h_ls[:, None, :].expand(shape)
    pm = slot["pilot_mask"][None].expand(shape).to(torch.float32)
    nv = torch.as_tensor(slot["noise_var"], dtype=torch.float32,
                         device=y.device)
    nv = (nv.reshape(-1, 1, 1) if nv.ndim else nv).expand(shape)
    return torch.stack([y.real, y.imag, hls.real, hls.imag, pm, nv],
                       dim=-1)


# ---------------------------------------------------------------------------
# CEViT: MHA-based channel estimator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CEViTConfig:
    d_model: int = 128
    heads: int = 4
    layers: int = 4
    d_ff: int = 256
    patch: int = 4  # subcarriers per token
    in_features: int = 4  # Re/Im of H_ls, pilot flag, noise


def cevit_schema(cfg: CEViTConfig):
    d, f = cfg.d_model, cfg.d_ff
    pin = cfg.patch * cfg.in_features
    blocks = []
    for _ in range(cfg.layers):
        blocks.append({
            "ln1": {"g": Param((d,), ("embed",), init="ones"),
                    "b": Param((d,), ("embed",), init="zeros")},
            "wqkv": Param((d, 3 * d), ("embed", "mlp"), init="scaled"),
            "wo": Param((d, d), ("mlp", "embed"), init="scaled"),
            "ln2": {"g": Param((d,), ("embed",), init="ones"),
                    "b": Param((d,), ("embed",), init="zeros")},
            "w1": Param((d, f), ("embed", "mlp"), init="scaled"),
            "b1": Param((f,), ("mlp",), init="zeros"),
            "w2": Param((f, d), ("mlp", "embed"), init="scaled"),
            "b2": Param((d,), ("embed",), init="zeros"),
        })
    return {
        "embed": Param((pin, d), (None, "embed"), init="scaled"),
        "pos": Param((1024, d), (None, "embed"), init="normal", scale=0.02),
        "blocks": blocks,
        "head": Param((d, cfg.patch * 2), ("embed", None), init="scaled"),
    }


def _ln(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with the population variance, eps inside the rsqrt."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def cevit_apply(params, cfg: CEViTConfig, feats: torch.Tensor
                ) -> torch.Tensor:
    """feats: (B, n_sc, in_features) -> H_hat (B, n_sc) complex64."""
    b, n_sc, fin = feats.shape
    if n_sc % cfg.patch:
        raise ValueError(f"n_sc={n_sc} is not a multiple of the patch "
                         f"{cfg.patch}")
    n_tok = n_sc // cfg.patch
    heads, d = cfg.heads, cfg.d_model
    dh = d // heads

    def linear(x3d, w, bias=None):
        out = te_gemm(x3d.reshape(b * n_tok, -1), w, bias)
        return out.reshape(b, n_tok, -1)

    def to_bh(t):
        return t.reshape(b, n_tok, heads, dh).permute(0, 2, 1, 3).reshape(
            b * heads, n_tok, dh)

    x = linear(feats.reshape(b, n_tok, cfg.patch * fin), params["embed"])
    x = x + params["pos"][:n_tok][None]
    for bp in params["blocks"]:
        hn = _ln(bp["ln1"], x)
        # one (d, 3d) GEMM: columns [q | k | v], as the reference splits
        q, k, v = torch.split(linear(hn, bp["wqkv"]), d, dim=-1)
        o = mha(to_bh(q), to_bh(k), to_bh(v), causal=False)
        o = o.reshape(b, heads, n_tok, dh).permute(0, 2, 1, 3).reshape(
            b, n_tok, d)
        x = x + linear(o, bp["wo"])
        hn = _ln(bp["ln2"], x)
        # jax.nn.gelu defaults to the tanh approximation
        hn = F.gelu(linear(hn, bp["w1"], bp["b1"]), approximate="tanh")
        x = x + linear(hn, bp["w2"], bp["b2"])
    out = linear(x, params["head"]).reshape(b, n_sc, 2)
    return torch.complex(out[..., 0], out[..., 1])


def cevit_features(h_ls: torch.Tensor, pilot_sc: torch.Tensor,
                   noise_var) -> torch.Tensor:
    """(B, n_sc) LS estimate -> (B, n_sc, 4) input features; ``noise_var``
    one value or one per lane of rows (``rx_fused.noise_var_rows``)."""
    b, n_sc = h_ls.shape
    pm = pilot_sc[None].expand(b, n_sc).to(torch.float32)
    nv = noise_var_rows(torch.as_tensor(noise_var, dtype=torch.float32,
                                        device=h_ls.device), b)
    nv = nv.reshape(-1, 1).expand(b, n_sc)
    return torch.stack([h_ls.real, h_ls.imag, pm, nv], dim=-1).to(
        torch.float32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_deeprx(gen: torch.Generator, cfg: DeepRxConfig):
    return init_params(deeprx_schema(cfg), gen)


def init_cevit(gen: torch.Generator, cfg: CEViTConfig):
    return init_params(cevit_schema(cfg), gen)


def deeprx_params_from_numpy(tree, device: DeviceLike = None):
    """The reference's DeepRx params (nested dict of arrays) as the port's
    tensors on ``device``; the config is read off the weights' shapes."""
    w_in = tree["conv_in"]["w"]
    cfg = DeepRxConfig(channels=w_in.shape[3], blocks=len(tree["blocks"]),
                       bits_per_re=tree["conv_out"]["w"].shape[3],
                       in_features=w_in.shape[2])
    return params_from_numpy(deeprx_schema(cfg), tree,
                             resolve_device(device))


def cevit_params_from_numpy(tree, device: DeviceLike = None):
    """The reference's CE-ViT params (nested dict of arrays) as the port's
    tensors on ``device``; the shapes fix every config field but
    ``heads``, which the schema does not see."""
    d = tree["embed"].shape[1]
    patch = tree["head"].shape[1] // 2
    cfg = CEViTConfig(d_model=d, layers=len(tree["blocks"]),
                      d_ff=tree["blocks"][0]["w1"].shape[1] if tree["blocks"]
                      else CEViTConfig.d_ff,
                      patch=patch, in_features=tree["embed"].shape[0] // patch)
    return params_from_numpy(cevit_schema(cfg), tree, resolve_device(device))
