"""The yardstick's arithmetic: the per-launch bytes of the kernel table's
shapes (PERF.md) and the operations of the fused detect + demap equal
``chip_smoke.py``'s, the decoder's count follows the iterations run, and
a roofline share is least time over device time."""
import sys

import pytest

import small
from harness import arith, spec

sys.path.insert(0, str(small.BENCH.parent))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def cells():
    root = small.BENCH / "configs"
    return {n: spec.make_cell(n, 1, spec.read_json(root / f"{n}.json"),
                              {"cells": []})
            for n in ("siso-classical", "siso-deeprx")}


def _bucket(lanes, batch, iters=(), real=None, nv=1):
    return {"mcs": 0, "lanes": lanes, "batch": batch,
            "real_slots": lanes * batch if real is None else real,
            "distinct_nv": nv, "real_iters": list(iters)}


def _bytes_ms(nbytes):
    return chip_smoke.bound(nbytes, 0.0)[0]


# (kernel, rung, bucket, the kernel table's byte bound in ms)
TABLE = (
    ("ls_che", 1, _bucket(1, 8), 0.00005),  # row 1, siso B=8
    ("detect_demap", 1, _bucket(8, 8), 0.00250),  # row 2, 8 lanes x 8
    # row 4, r12 216cw: 24 slots of the QPSK rung's 9 codewords
    ("ldpc_decode", 0, _bucket(1, 24, [3] * 216), 0.00040),
)


@pytest.mark.parametrize("kernel,rung,bucket,table_ms", TABLE)
def test_byte_bounds_are_the_kernel_tables(cells, kernel, rung, bucket,
                                           table_ms):
    cell = cells["siso-classical"]
    (nbytes, _), = arith.load("ops", kernel).launches(
        cell, cell.rungs[rung], bucket)
    assert round(_bytes_ms(nbytes), 5) == table_ms


def test_te_gemm_block_conv_is_the_kernel_tables(cells):
    """Row 6: DeepRx's block conv2 at batch 8, (28672x288)@(288x32) with
    a bias, 0.01097 ms of bytes, and 2 M N K + M N operations."""
    cell = cells["siso-deeprx"]
    work = arith.load("ops", "te_gemm").launches(cell, cell.rungs[0],
                                                 _bucket(1, 8))
    nbytes, flops = work[2]
    assert round(_bytes_ms(nbytes), 5) == 0.01097
    assert flops == 2.0 * 28672 * 32 * 288 + 28672 * 32
    assert len(work) == 6  # conv_in, two blocks of two, conv_out


@pytest.mark.parametrize("shape", [(1, 1, 1, 14), (1, 1, 2, 14),
                                   (2, 2, 2, 14), (8, 4, 3, 14),
                                   (4, 4, 2, 40)])
def test_detect_operations_are_chip_smokes(shape):
    assert arith.detect_flops(*shape) == chip_smoke._detect_flops(*shape)


def test_the_decoder_count_follows_the_iterations_run(cells):
    cell = cells["siso-classical"]
    op = arith.load("ops", "ldpc_decode")
    code = cell.rungs[0].code
    counts = [op.launches(cell, cell.rungs[0], _bucket(1, 1, [it] * 9))[0][1]
              for it in range(13)]
    per = [(it * 10 + (it + 1) * 2) * code.n_edges * code.z * 9
           for it in range(13)]
    assert counts == per
    assert all(b > a for a, b in zip(counts, counts[1:]))
    # bytes count every codeword launched, padding included
    nbytes = [op.launches(cell, cell.rungs[0], _bucket(1, b, [1]))[0][0]
              for b in (1, 2)]
    assert nbytes[1] == 2 * nbytes[0]
    b = _bucket(1, 2, [1], real=1)
    assert op.step_ops(cell, cell.rungs[0], b) == per[1] / 9


def test_a_roofline_share_is_least_time_over_device_time(cells):
    cell = cells["siso-classical"]
    buckets = [_bucket(8, 8), _bucket(4, 8)]
    least = sum(arith.least_s(*w) for w in
                arith.kernel_work(cell, "detect_demap", buckets))
    sym = arith.load("ops", "detect_demap").SYMBOL
    traced = {"by_symbol": {sym: (4 * least, 2)}}
    assert arith.roofline(cell, "detect_demap", traced, buckets) == \
        pytest.approx(25.0)
    # CUPTI dropped a record: the means per launch
    traced = {"by_symbol": {sym: (2 * least, 1)}}
    assert arith.roofline(cell, "detect_demap", traced, buckets) == \
        pytest.approx(100.0 * (least / 2) / (2 * least))
    assert arith.roofline(cell, "ls_che", {"by_symbol": {}}, buckets) is None


def test_step_operations_count_the_wiener_operator_per_noise_value(cells):
    cell = cells["siso-classical"]
    op = arith.load("ops", "wiener")
    one, two = (op.step_ops(cell, cell.rungs[0], _bucket(8, 8, nv=n))
                for n in (1, 2))
    n = cell.rungs[0].grid.n_subcarriers
    assert two - one == 8.0 * (n ** 3 / 3.0 + n ** 3)
