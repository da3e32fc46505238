"""Wiener smoothing (torch operations in the replayed graph): the
(n_sc, n_sc) operator R (R + s2 I)^-1 depends on the noise value alone,
so what the inputs need is one complex LU (n^3 / 3 multiply-adds) and
its n right-hand sides (n^3) per distinct noise value of a replay, and
the n^2 multiply-adds of its product per antenna pair of a real slot;
8 real operations per complex multiply-add."""
SYMBOL = None


def step_ops(cell, rung, bucket) -> float:
    g = rung.grid
    n = g.n_subcarriers
    solve = 8.0 * (n ** 3 / 3.0 + n ** 3)
    apply = 8.0 * n * n * g.n_rx * g.n_tx
    return bucket["distinct_nv"] * solve + bucket["real_slots"] * apply
