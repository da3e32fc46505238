"""Real slots decoded in the window (new and retransmitted; filler lanes
and padding are not slots) over the window's wall time."""


def read(run):
    w = run.window
    return w["slots"] / w["wall_s"]
