"""Share of the traced slice's wall time in which no operation ran on
the device."""


def read(run):
    s = run.slice
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"]) if s else None
