"""``ls_che``'s share of its roofline over the traced slice: the least
time of its launches (``portbench/ops/ls_che.py``) over its CUPTI time."""
from harness import arith


def read(run):
    s = run.slice
    return arith.roofline(run.cell, "ls_che", s, s["buckets"]) if s else None
