"""``ldpc_decode``'s share of its roofline over the traced slice: the least
time of its launches (``portbench/ops/ldpc_decode.py``) over its CUPTI time."""
from harness import arith


def read(run):
    s = run.slice
    return arith.roofline(run.cell, "ldpc_decode", s, s["buckets"]) if s else None
