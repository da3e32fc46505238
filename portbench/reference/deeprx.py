"""Plain reference of the ``siso-deeprx`` configuration's receiver:
CFFT, LS estimate, the DeepRx residual convolution network over the grid
(each convolution an im2col and one float32 matrix product, TF32 off),
HARQ combining, layered min-sum decoding and the CRC check.  The weights
are drawn again here from the configuration's weight seed, as the
port's builder draws them (a frozen copy of its schema and draw).  ``lower`` is the
control: the convolutions' products in TF32."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from harness import chain
from harness.spec import pilot_masks_np


def weights(net: dict, in_features: int, bits: int, seed: int,
            device) -> dict:
    """The network's weights as the port's schema draws them: leaves in
    sorted-key order (``blocks``, ``conv_in``, ``conv_out``; in a conv
    ``b`` then ``w``), each ``w`` (kh, kw, cin, cout) ~ N(0, 1) / sqrt(cin)
    from one generator, biases zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    c, k = net["channels"], net["kernel"]

    def conv(cin, cout, kk):
        b = torch.zeros(cout, device=device)
        w = torch.randn((kk, kk, cin, cout), generator=gen,
                        device=device).div_(math.sqrt(cin))
        return {"w": w, "b": b}

    blocks = [{"conv1": conv(c, c, k), "conv2": conv(c, c, k)}
              for _ in range(net["blocks"])]
    return {"blocks": blocks, "conv_in": conv(in_features, c, k),
            "conv_out": conv(c, bits, 1)}


def _conv(p: dict, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """SAME stride-1 NHWC convolution as im2col (columns in (kh, kw, cin)
    order) and one matrix product, bias, optional ReLU."""
    kh, kw, cin, cout = p["w"].shape
    b, h, w, _ = x.shape
    if kh == 1 and kw == 1:
        cols = x.reshape(b * h * w, cin)
    else:
        xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
        cols = torch.cat([xp[:, i:i + h, j:j + w, :] for i in range(kh)
                          for j in range(kw)], dim=-1).reshape(b * h * w, -1)
    z = cols @ p["w"].reshape(kh * kw * cin, cout) + p["b"]
    return (torch.clamp_min(z, 0.0) if relu else z).reshape(b, h, w, cout)


def receive(cell, rung, batch: dict, *, lower: bool = False) -> dict:
    """The contract of :func:`reference.classical.receive`, with the
    weights of the configuration's ``weight_seed``."""
    chain.fp32_only()
    g = rung.grid
    net = cell.config["deeprx"]
    n_in = 2 * g.n_rx + 2 * g.n_rx * g.n_tx + 2
    nb = rung.modem.bits_per_symbol
    dev = batch["y_time"].device
    p = weights(net, n_in, g.n_tx * nb, cell.config["weight_seed"], dev)
    with torch.no_grad():
        torch.backends.cuda.matmul.allow_tf32 = lower
        try:
            y = chain.cfft(batch["y_time"])
            h_ls = chain.ls_estimate(g, y)
            b, n_sym, n_sc, _ = y.shape
            union = torch.from_numpy(pilot_masks_np(g).any(axis=0)).to(dev)
            feats = torch.cat([
                y.real, y.imag,
                h_ls.reshape(b, 1, n_sc, -1).expand(b, n_sym, n_sc, -1).real,
                h_ls.reshape(b, 1, n_sc, -1).expand(b, n_sym, n_sc, -1).imag,
                union[None, :, :, None].float().expand(b, n_sym, n_sc, 1),
                batch["noise_var"].float().reshape(-1, 1, 1, 1).expand(
                    b, n_sym, n_sc, 1),
            ], dim=-1).float()
            x = _conv(p["conv_in"], feats, True)
            for bp in p["blocks"]:
                hdn = _conv(bp["conv1"], x, True)
                x = torch.relu(x + _conv(bp["conv2"], hdn, False))
            llr = _conv(p["conv_out"], x, False).reshape(
                b, n_sym, n_sc, g.n_tx, nb)
        finally:
            chain.fp32_only()
        cw = chain.combine(rung, llr, batch["rv"], batch["prior_llr"])
        return {"cw_llr": cw, **chain.decode(rung, cw, cell.config["decoder"])}
