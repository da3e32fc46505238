"""The whole receive step's share of the card's peak: the operations the
traced slice's real slots need (every stage of the configuration,
``portbench/ops``) over the slice's wall time at 495 TFLOP/s."""
from harness import arith


def read(run):
    s = run.slice
    if not s:
        return None
    ops = arith.step_ops(run.cell, s["buckets"])
    return 100.0 * ops / (s["window_s"] * arith.PEAK_FLOPS)
