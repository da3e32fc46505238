"""Process start to the first timed tick: imports, the kernels' load (or
build, on a checkout's first run), the slot pools, the captures, the
warm-up ticks."""


def read(run):
    return run.setup_s
