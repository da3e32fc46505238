"""Plain reference of the ``siso-classical`` configuration's receiver:
CFFT, LS estimate, Wiener smoothing, unbiased MMSE detection, max-log
demapping, HARQ combining, layered min-sum decoding and the CRC check
(:mod:`harness.chain`), float32 with TF32 off; ``lower`` is the control:
the Wiener operator's and the detector's products with TF32 operands."""
from __future__ import annotations

import torch

from harness import chain


def receive(cell, rung, batch: dict, *, lower: bool = False) -> dict:
    """``batch``: ``y_time`` (B, n_sym, n_sc, n_rx), ``noise_var`` (B,),
    ``rv`` (B,), ``prior_llr`` (B, C, n_mother), the slots of one
    transmission of each job.  Returns ``cw_llr`` (B, C, n_mother) and
    the decoder's ``crc_ok`` and ``iters`` (B, C)."""
    chain.fp32_only()
    operand = chain.tf32 if lower else (lambda t: t)
    cfg = cell.config
    with torch.no_grad():
        y = chain.cfft(batch["y_time"])
        h_ls = chain.ls_estimate(rung.grid, y)
        h = chain.wiener(h_ls, batch["noise_var"], cfg["wiener_corr_len"],
                         operand)
        x_hat, nv_eff = chain.mmse_detect(y, h, batch["noise_var"], operand)
        llr = chain.demap(rung.modem, x_hat, nv_eff)
        cw = chain.combine(rung, llr, batch["rv"], batch["prior_llr"])
        return {"cw_llr": cw, **chain.decode(rung, cw, cfg["decoder"])}
