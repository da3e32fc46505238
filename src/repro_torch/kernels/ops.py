"""Public wrappers of the hand-written kernels (port of
:mod:`repro.kernels.ops`): the kernel-ops entry point beside the
pipelines, which the paper's block plans (:mod:`repro_torch.core.pool`)
and the precision study call.

Every wrapper dispatches by the device of its tensors, by the port's one
rule: a CPU tensor goes to the kernel's plain PyTorch twin, a CUDA tensor
to the CUDA kernel, which raises when it cannot run (no card, no
``nvcc``, a shape it has no instance for); nothing falls back.

Each kernel's launch shape is its own picker's: a winner the autotuner
(:mod:`repro_torch.kernels.tune`) persisted for the op and shape on
``cuda``, else the static heuristic (``te_gemm.pick_block_shape``,
``mha.pick_cluster``, ``rx_fused.pick_subcarrier_tile`` and
``pick_threads_per_output``), as the reference's wrappers consult its
tuner before their heuristics.  The reference's TPU block-shape arguments
(``block_shape``, ``bq``, ``bkv``, ``bm``, ``bk``, ``bc``, ``block_sc``,
``use_pallas``) pick Pallas tiles, which the kernels here do not have:
they mask their own edges, so the wrappers leave them out.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dwconv_block as _dw
from repro_torch.kernels import fc_softmax as _fc
from repro_torch.kernels import mha as _mha
from repro_torch.kernels import rx_fused as _rx
from repro_torch.kernels import te_gemm as _te


def te_gemm(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None,
            epilogue: str = "none") -> torch.Tensor:
    """``epi(x @ w + bias)`` on the TE GEMM (``csrc/te_gemm.cu``)."""
    return _te.te_gemm(x, w, bias, epilogue=epilogue)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        causal: bool = True) -> torch.Tensor:
    """Flash attention over (BH, S, D) operands (``csrc/mha.cu``), its
    key-split cluster through :func:`repro_torch.kernels.mha.pick_cluster`
    (the tuned winner for ("mha", (BH, Sq, Sk, D)), else the heuristic)."""
    return _mha.mha(q, k, v, causal=causal)


def te_gemm_quant(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  precision: str = "int8",
                  epilogue: str = "none") -> torch.Tensor:
    """Quantized GEMM: int8 / e4m3 codes, exact int32 or fp32 accumulate,
    dequant epilogue (``csrc/te_gemm_quant.cu``)."""
    return _te.te_gemm_quant(x, w, bias, precision=precision,
                             epilogue=epilogue)


def mha_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              precision: str = "int8", causal: bool = True) -> torch.Tensor:
    """Quantized flash attention: per-(batch*head) scales, fp32 softmax
    (``csrc/mha_quant.cu``)."""
    return _mha.mha_quant(q, k, v, precision=precision, causal=causal)


def mmse_detect_demap(y, h, noise_var, modem):
    """Fused equalize -> demap: (x_hat, nv_eff, llr)
    (``csrc/detect_demap.cu``)."""
    return _rx.mmse_detect_demap(y, h, noise_var, modem)


def ls_che(y, pilot_symbols: tuple, pilot_stride: int, op):
    """Fused LS CHE against a precomputed interpolation operator
    (``csrc/ls_che.cu``)."""
    return _rx.ls_che(y, pilot_symbols, pilot_stride, op)


def fc_softmax(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax(x @ w + bias)`` over whole rows (``csrc/fc_softmax.cu``)."""
    return _fc.fc_softmax(x, w, bias)


def dwconv_block(x_padded: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor,
                 gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 -> pointwise -> LayerNorm -> ReLU
    (``csrc/dwconv_block.cu``)."""
    return _dw.dwconv_block(x_padded, dw, pw, gamma, beta)


# the reference's alias of the GEMM's launch-shape picker (its TPU tiles
# (bm, bn, bk); here the Hopper kernels' choice, see te_gemm's docstring)
pick_block_shape = _te.pick_block_shape
