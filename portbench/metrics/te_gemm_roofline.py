"""``te_gemm``'s share of its roofline over the traced slice: the least
time of its launches (``portbench/ops/te_gemm.py``) over its CUPTI time."""
from harness import arith


def read(run):
    s = run.slice
    return arith.roofline(run.cell, "te_gemm", s, s["buckets"]) if s else None
