"""``detect_demap``'s share of its roofline over the traced slice: the least
time of its launches (``portbench/ops/detect_demap.py``) over its CUPTI time."""
from harness import arith


def read(run):
    s = run.slice
    return arith.roofline(run.cell, "detect_demap", s, s["buckets"]) if s else None
