"""The fused detect + demap kernel (``csrc/detect_demap.cu``,
``detect_demap_kernel``).  Bytes: y and the per-subcarrier channel in
(complex64), one noise value a lane, x_hat (complex64), nv_eff and the
LLRs (float32) out; operations per RE: ``arith.detect_flops``."""
from harness.arith import detect_flops

SYMBOL = "detect_demap_kernel"


def _per_re(rung) -> float:
    g = rung.grid
    return detect_flops(g.n_rx, g.n_tx, rung.modem.bits_per_axis,
                        g.n_symbols)


def launches(cell, rung, bucket) -> list:
    g = rung.grid
    rows = bucket["lanes"] * bucket["batch"]
    n_re = rows * g.n_symbols * g.n_subcarriers
    nb = rung.modem.bits_per_axis
    nbytes = (8 * n_re * g.n_rx + 8 * rows * g.n_subcarriers * g.n_rx
              * g.n_tx + 4 * bucket["lanes"]
              + n_re * g.n_tx * (8 + 4 + 4 * 2 * nb))
    return [(nbytes, n_re * _per_re(rung))]


def step_ops(cell, rung, bucket) -> float:
    g = rung.grid
    return (bucket["real_slots"] * g.n_symbols * g.n_subcarriers
            * _per_re(rung))
