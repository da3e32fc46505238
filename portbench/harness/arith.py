"""The yardstick's arithmetic: the card's peaks, the per-launch bytes and
operations of each kernel and the operations of each receive stage
(``portbench/ops/<name>.py``, counted from shapes), and the sums that
turn a traced slice into roofline shares and the step's share of peak.

Peaks: NVIDIA's data sheet for the H100 SXM, dense.  The float32
operations of every kernel are set against the TF32 tensor-core rate,
495 TFLOP/s, the highest rate at which the card runs fp32-operand
arithmetic (``te_gemm``'s 3xTF32 path included), so no kernel's share
can pass 100% by running on tensor cores; bytes against 3.35 TB/s.
"""
from __future__ import annotations

import functools
import importlib.util
import sys

from harness.spec import BENCH

PEAK_FLOPS = 495e12  # TF32 tensor-core dense, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM


def least_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at its bandwidth or
    operations at its peak, whichever is longer."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


@functools.lru_cache(maxsize=None)
def load(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def detect_flops(n_rx: int, n_tx: int, nb: int, n_sym: int) -> float:
    """fp32 operations per RE of the fused joint MMSE detect + demap
    (complex multiply-add 8, multiply 6, pivot reciprocal 6; per level a
    subtract, a square and a compare): the Gram, its elimination and the
    bias columns once per subcarrier and row, spread over its symbols;
    H^H y, its solve and each stream's demap per RE."""
    def factor(m):
        return sum(6 + (m - kd - 1) * (6 + 8 * (m - kd)) for kd in range(m))

    def column(m, down_to=0):
        return 4.0 * m * (m - 1) + sum(8 * (m - kd - 1) + 6
                                       for kd in range(down_to, m))

    n_lv = 2 ** nb
    demap = 6 + 2 * (3 * n_lv + nb * (n_lv + 1))
    gram = 8.0 * n_rx * n_tx * (n_tx + 1) / 2
    per_sc = gram + factor(n_tx) + sum(column(n_tx, u) for u in range(n_tx))
    per_re = 8.0 * n_tx * n_rx + column(n_tx) + n_tx * demap
    return per_re + per_sc / n_sym


def ldpc_flops(iters, n_edges: int, z: int) -> float:
    """Layered min-sum: ~10 fp32 operations per edge and lifted row a
    sweep, 2 per edge and row for each syndrome check (one before the
    first sweep), at the iterations each codeword ran."""
    return float(sum((int(it) * 10 + (int(it) + 1) * 2) * n_edges * z
                     for it in iters))


def kernel_work(cell, name: str, buckets: list) -> list:
    """(bytes, operations) of every launch of kernel ``name`` over the
    traced buckets."""
    op = load("ops", name)
    return [w for b in buckets for w in op.launches(cell, cell.rungs[b["mcs"]],
                                                    b)]


def roofline(cell, name: str, traced: dict, buckets: list):
    """Kernel ``name``'s share of its roofline over a traced slice, in %:
    the least time of the launches the slice served over the CUPTI time of
    its symbol.  Where CUPTI recorded another number of launches than the
    slice made, the means per launch are set against each other.  None
    where the kernel did not run."""
    op = load("ops", name)
    work = kernel_work(cell, name, buckets)
    dev_s, n_traced = traced["by_symbol"].get(op.SYMBOL, (0.0, 0))
    if not work or not n_traced or dev_s <= 0:
        return None
    least = sum(least_s(b, f) for b, f in work)
    if n_traced != len(work):
        return 100.0 * (least / len(work)) / (dev_s / n_traced)
    return 100.0 * least / dev_s


def step_ops(cell, buckets: list) -> float:
    """The operations the traced buckets' real slots need, summed over the
    configuration's stages."""
    return sum(load("ops", st).step_ops(cell, cell.rungs[b["mcs"]], b)
               for b in buckets for st in cell.config["stages"])
