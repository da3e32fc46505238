"""The fused LS estimate kernel (``csrc/ls_che.cu``): each (rx, tx)
comb of pilots, averaged over the pilot symbols, times the (n_p, n_sc)
interpolation operator.  Bytes: the comb's pilot REs read, the operator,
the estimate written (complex64); operations: 8 per complex
multiply-add of the product."""
SYMBOL = "ls_che_kernel"


def _n_p(g) -> int:
    return g.n_subcarriers // (g.pilot_stride * g.n_tx)


def _flops(g, rows: int) -> float:
    return 8.0 * rows * g.n_rx * g.n_tx * _n_p(g) * g.n_subcarriers


def launches(cell, rung, bucket) -> list:
    g = rung.grid
    rows = bucket["lanes"] * bucket["batch"]
    n_p = _n_p(g)
    nbytes = 8 * (rows * len(g.pilot_symbols) * g.n_tx * n_p * g.n_rx
                  + g.n_tx * n_p * g.n_subcarriers
                  + rows * g.n_subcarriers * g.n_rx * g.n_tx)
    return [(nbytes, _flops(g, rows))]


def step_ops(cell, rung, bucket) -> float:
    return _flops(rung.grid, bucket["real_slots"])
