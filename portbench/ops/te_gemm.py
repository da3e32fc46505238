"""DeepRx's convolutions, each one launch of the TE GEMM kernel
(``csrc/te_gemm.cu``, ``te_gemm_kernel``) over the im2col rows: the
input convolution, two a residual block, the 1x1 output convolution.
Bytes: X, W, the bias and the output (float32); operations: 2 M N K and
the bias add."""
SYMBOL = "te_gemm_kernel"


def _shapes(cell, rung) -> list:
    g = rung.grid
    net = cell.config["deeprx"]
    c, k = net["channels"], net["kernel"]
    n_in = 2 * g.n_rx + 2 * g.n_rx * g.n_tx + 2
    bits = g.n_tx * rung.modem.bits_per_symbol
    return ([(k * k * n_in, c)] + [(k * k * c, c)] * (2 * net["blocks"])
            + [(c, bits)])


def _work(cell, rung, slots: int) -> list:
    g = rung.grid
    m = slots * g.n_symbols * g.n_subcarriers
    return [(4 * (m * kk + kk * n + m * n + n), 2.0 * m * n * kk + m * n)
            for kk, n in _shapes(cell, rung)]


def launches(cell, rung, bucket) -> list:
    return _work(cell, rung, bucket["lanes"] * bucket["batch"])


def step_ops(cell, rung, bucket) -> float:
    return sum(f for _, f in _work(cell, rung, bucket["real_slots"]))
