"""Payload bits of every transport block ACKed in the window over the
window's wall time."""


def read(run):
    w = run.window
    return w["good_bits"] / w["wall_s"] / 1e6
