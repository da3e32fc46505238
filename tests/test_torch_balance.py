"""Port vs reference: the Kung's-inequality balance model
(``repro_torch.core.balance`` against ``repro.core.balance``) and the
port's machine entries.

Each balance function is a pure function of a ``Machine``; the two
packages' functions must give equal reports on machines with equal
fields: the paper's processor (both packages have it) and the H100 the
port runs on (built field for field in the reference's ``Machine``)."""
import dataclasses

import pytest

from repro.core import balance as ref_balance
from repro.core import machine as ref_machine
from repro_torch.core import balance, machine
from _port_share import port_share  # noqa: F401

_MACHINES = ["TENSORPOOL_N7", "H100_SXM"]


def _pair(name: str):
    """(reference Machine, port Machine) with equal fields."""
    port = getattr(machine, name)
    ref = ref_machine.Machine(**dataclasses.asdict(port))
    return ref, port


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.bound == b.bound


_CALLS = {
    "kung": lambda mod, m: mod.kung(3.0e9, 1.5e7, m),
    "kung_bw": lambda mod, m: mod.kung(3.0e9, 1.5e7, m, bw=1.0e11),
    "gemm_hbm_balance": lambda mod, m: mod.gemm_hbm_balance(512, 4, m),
    "gemm_hbm_balance_small": lambda mod, m: mod.gemm_hbm_balance(64, 2, m),
    "gemm_tile_balance": lambda mod, m: mod.gemm_tile_balance(
        64, 32, 128, 4, m),
    "gemm_tile_balance_bw": lambda mod, m: mod.gemm_tile_balance(
        128, 128, 128, 2, m, vmem_bw=3.0e13),
    "sharded_gemm_rhs": lambda mod, m: mod.sharded_gemm_ici_balance(
        4096, 4096, 4096, 2, m, shards=4),
    "sharded_gemm_lhs": lambda mod, m: mod.sharded_gemm_ici_balance(
        4096, 1024, 8192, 1, m, shards=8, gathered="lhs"),
}


@pytest.mark.parametrize("call", sorted(_CALLS))
@pytest.mark.parametrize("name", _MACHINES)
def test_balance_reports_equal_reference(name, call):
    ref_m, port_m = _pair(name)
    _same(_CALLS[call](ref_balance, ref_m), _CALLS[call](balance, port_m))


@pytest.mark.parametrize("args", [(64, 32, 288, 4), (128, 256, 64, 2),
                                  (64, 8, 16, 4, 4, 4), (512, 512, 512, 1)])
def test_tile_footprint_and_buffers_equal_reference(args):
    assert balance.tile_vmem_bytes(*args) == ref_balance.tile_vmem_bytes(
        *args)
    for lat, tile in ((1e-6, 2e-7), (5e-7, 1e-6), (0.0, 1e-6), (1e-6, 0.0)):
        assert balance.outstanding_buffers_needed(lat, tile) == \
            ref_balance.outstanding_buffers_needed(lat, tile)


def test_tensorpool_entry_equals_reference():
    assert dataclasses.asdict(machine.TENSORPOOL_N7) == \
        dataclasses.asdict(ref_machine.TENSORPOOL_N7)


def test_terapool_entry_equals_reference():
    assert dataclasses.asdict(machine.TERAPOOL_12N) == \
        dataclasses.asdict(ref_machine.TERAPOOL_12N)


def test_h100_entry_is_the_cards():
    """The card's constants (NVIDIA's data sheet), the figures
    ``chip_smoke.py``'s bounds read: 67 TFLOP/s fp32, 3.35 TB/s of HBM,
    228 KiB of shared memory an SM; no TPU constant."""
    h = machine.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.fast_mem_bytes) == \
        (67e12, 3.35e12, 228 * 1024)
    assert h.critical_intensity == pytest.approx(20.0, rel=1e-3)
    assert machine.H100_SXM_TENSOR_FLOPS["bf16"] == 989e12
    assert machine.H100_SXM_TENSOR_FLOPS["int8"] == \
        machine.H100_SXM_TENSOR_FLOPS["fp8"] == 1979e12
    assert not hasattr(machine, "TPU_V5E")
    # DeepRx's fp32 block conv is bound by bytes on the card
    rep = balance.kung(2.0 * 28672 * 288 * 32,
                       4.0 * (28672 * 288 + 288 * 32 + 28672 * 32), h)
    assert rep.bound == "memory"
