"""Device busy time (the union of CUPTI's records) in the traced slice
over the real slots it served."""


def read(run):
    s = run.slice
    return s["busy_s"] / s["slots"] * 1e6 if s and s["slots"] else None
