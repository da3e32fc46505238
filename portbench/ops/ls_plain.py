"""The plain LS estimate (torch operations in the replayed graph): per
pilot RE a complex division and the masked average, then the
interpolation onto every subcarrier of each (rx, tx) pair."""
SYMBOL = None


def step_ops(cell, rung, bucket) -> float:
    g = rung.grid
    per_slot = (len(g.pilot_symbols) * g.n_subcarriers * g.n_rx * 10.0
                + g.n_subcarriers * g.n_rx * g.n_tx * 8.0)
    return bucket["real_slots"] * per_slot
