"""CFFT stage (cuFFT inside the replayed graph): 5 N log2 N real
operations per transform of N subcarriers, one per symbol and receive
antenna of each real slot."""
import math

SYMBOL = None


def step_ops(cell, rung, bucket) -> float:
    g = rung.grid
    n = g.n_subcarriers
    return (bucket["real_slots"] * g.n_symbols * g.n_rx
            * 5.0 * n * math.log2(n))
