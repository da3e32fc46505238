"""Port vs reference: the static, trace-time builders must give identical
arrays (protograph, CRC matrix, interpolation operator, pilot sequence
and masks, data-RE order), the scenario and ladder registries must agree
field for field, and the port must import neither JAX nor the reference
package."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from repro.kernels import rx_fused as ref_rx
from repro.phy import coding as ref_coding
from repro.phy import ofdm as ref_ofdm
from repro.phy import scenarios as ref_scn
from repro_torch.kernels import rx_fused
from repro_torch.phy import coding, ofdm, scenarios
from _port_share import port_share  # noqa: F401

_GRIDS = sorted({ref_scn.get_scenario(n).grid
                 for n in scenarios.scenario_names()}, key=repr)


def _port_grid(g):
    return ofdm.GridConfig(**{f: getattr(g, f) for f in (
        "n_subcarriers", "n_symbols", "pilot_stride", "pilot_symbols",
        "n_tx", "n_rx", "fft_size", "n_taps", "delay_spread")})


@pytest.mark.parametrize("rate", ["r12", "r34"])
def test_code_protograph_identical(rate):
    a, b = ref_coding.make_code(rate), coding.make_code(rate)
    assert a.info_edges == b.info_edges
    assert a.layers() == b.layers()
    assert (a.name, a.z, a.k_b, a.m_b, a.p_tx_b, a.k, a.n_mother,
            a.e_bits) == (b.name, b.z, b.k_b, b.m_b, b.p_tx_b, b.k,
                          b.n_mother, b.e_bits)


@pytest.mark.parametrize("k_info", [368, 176, 40])
def test_crc_matrix_identical(k_info):
    a, b = ref_coding.crc_matrix(k_info), coding.crc_matrix(k_info)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("grid", _GRIDS, ids=lambda g: f"{g.n_tx}x{g.n_rx}")
def test_pilots_masks_and_operator_identical(grid):
    pg = _port_grid(grid)
    seq_ref = np.asarray(ref_ofdm.pilot_sequence(grid))
    seq = ofdm.pilot_sequence_np(pg)
    assert seq.dtype == seq_ref.dtype and seq.tobytes() == seq_ref.tobytes()
    m_ref = ref_ofdm.link_pilot_masks_np(grid)
    assert m_ref.tobytes() == ofdm.link_pilot_masks_np(pg).tobytes()
    op_ref = np.asarray(ref_rx.make_ls_interp_operator(
        grid.n_subcarriers, grid.n_tx, grid.pilot_stride, seq_ref))
    op = rx_fused.make_ls_interp_operator(
        pg.n_subcarriers, pg.n_tx, pg.pilot_stride, seq)
    assert op.dtype == op_ref.dtype and op.tobytes() == op_ref.tobytes()
    sym_ref, sc_ref = (np.asarray(a) for a in ref_coding._data_re_index(grid))
    sym, sc = coding._data_re_index(pg)
    assert np.array_equal(sym, sym_ref) and np.array_equal(sc, sc_ref)


def test_scenario_and_ladder_registries_agree():
    # other test modules may register extra scenarios into the reference
    # registry in this process, so the port's catalogue is compared name
    # by name against it
    assert len(scenarios.scenario_names()) == 17
    assert set(scenarios.scenario_names()) <= set(ref_scn.scenario_names())
    for name in scenarios.scenario_names():
        a, b = ref_scn.get_scenario(name), scenarios.get_scenario(name)
        for f in ("modulation", "snr_db", "doppler_rho", "interferer_db",
                  "user_power_db", "description", "bits_per_slot",
                  "data_bits_per_slot", "n_users"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        assert _port_grid(a.grid) == b.grid
        assert (a.code is None) == (b.code is None)
        if a.code is not None:
            assert a.code.name == b.code.name
            assert a.code.info_edges == b.code.info_edges
            assert (ref_coding.codewords_per_slot(a)
                    == coding.codewords_per_slot(b))
        ma, mb = a.modem, b.modem
        assert (ma.name, ma.bits_per_symbol, ma.levels, ma.norm) == \
            (mb.name, mb.bits_per_symbol, mb.levels, mb.norm)
    assert scenarios.ladder_names() == [
        "mimo2x2-coded", "siso-coded", "siso-coded-wide"]
    for name in scenarios.ladder_names():
        la, lb = ref_scn.get_ladder(name), scenarios.get_ladder(name)
        assert la.rungs == lb.rungs
        assert [la.efficiency(i) for i in range(len(la))] == \
            [lb.efficiency(i) for i in range(len(lb))]


# modules the walk below must reach (a walk that found nothing would pass)
_SOME_MODULES = {
    "repro_torch.device", "repro_torch.kernels._build",
    "repro_torch.serve.exec_registry", "repro_torch.models.registry",
    "repro_torch.data.pipeline", "repro_torch.optim.compression",
    "repro_torch.train.step", "repro_torch.train.trainer",
    "repro_torch.serve.engine", "repro_torch.launch.train",
    "repro_torch.launch.serve",
}


def test_port_imports_neither_jax_nor_reference():
    """Every module of the package, found by ``pkgutil.walk_packages``
    (a module a slice adds is covered without an edit here), imports in a
    fresh interpreter without pulling in ``jax`` or ``repro``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = sorted(m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.'))\n"
        "for m in names: importlib.import_module(m)\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "for a in ARCH_IDS: get_config(a)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
        "print('clean')\n"
    )
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    names, verdict = out.stdout.strip().splitlines()
    assert verdict == "clean"
    assert _SOME_MODULES <= set(names.split()), \
        sorted(_SOME_MODULES - set(names.split()))


def test_every_cuda_source_is_built_and_checked_on_the_card():
    """Each ``csrc/*.cu`` is built by ``_build`` and held against its twin
    by ``chip_smoke.py``, and every source those name exists."""
    import importlib.util

    from repro_torch.kernels import _build

    root = pathlib.Path(__file__).resolve().parents[1]
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SOURCE_FLAGS)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {src.removesuffix(".cu") for src, _ in smoke.KERNELS.values()} \
        == sources
    assert set(smoke.KERNEL_SYMBOLS) == set(smoke.KERNELS)
    for name, (_, replaces) in smoke.KERNELS.items():
        path, line = replaces.split(":")
        text = (root / path).read_text().splitlines()[int(line) - 1]
        assert text.startswith("def ") and "pallas" in \
            (root / path).read_text(), (name, replaces, text)


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def test_every_kernel_symbol_names_a_global_function():
    """``chip_smoke.device_us`` finds a kernel in the CUPTI trace by the
    substring in ``KERNEL_SYMBOLS`` and reads None when no name holds it,
    so each one must be part of a ``__global__`` function of its source."""
    import importlib.util

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    csrc = root / "src" / "repro_torch" / "csrc"
    for name, symbol in smoke.KERNEL_SYMBOLS.items():
        source = smoke.KERNELS[name][0]
        kernels = _GLOBAL.findall((csrc / source).read_text())
        assert any(symbol in k for k in kernels), (name, symbol, kernels)


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every source that includes it, and only
    those."""
    from repro_torch.kernels import _build

    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    users = [n for n in _build.SOURCES
             if '#include "hopper.cuh"' in (tmp_path / f"{n}.cu").read_text()]
    assert set(users) >= {"te_gemm_quant", "fc_softmax"}
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if after[n] != before[n]} == set(users)


def test_entry_points_default_to_cuda():
    import torch

    from repro_torch import resolve_device
    from repro_torch.phy import link

    from repro_torch.serve import (
        CellMeshEngine, MeshSlotScheduler, cell, closed_cell,
    )

    scn = scenarios.get_scenario("siso-qpsk-r12-snr8")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            link.build_classical(scn, fused=True)
        # the mesh frontends build their default mesh on CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            MeshSlotScheduler([closed_cell("c0", "siso-coded")],
                              prebuild=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            CellMeshEngine([cell("c0", scn)], prebuild=False)
    # the LM zoo: parameters, inputs and caches land on the card
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.models import get_model

    lm = get_model(get_smoke_config("llama3-8b"))
    shape = ShapeConfig("s", 8, 1, "prefill")
    if torch.cuda.is_available():
        assert lm.init()["ln_f"]["scale"].device.type == "cuda"
        assert lm.make_inputs(None, shape)["tokens"].device.type == "cuda"
        assert lm.init_cache(1, 8)["pos"].device.type == "cuda"
    else:
        for call in (lm.init, lambda: lm.make_inputs(None, shape),
                     lambda: lm.init_cache(1, 8)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert lm.init(device="cpu")["ln_f"]["scale"].device.type == "cpu"
    assert lm.make_inputs(None, shape, device="cpu")["tokens"].device.type \
        == "cpu"
    assert lm.init_cache(1, 8, device="cpu")["k"].device.type == "cpu"
    assert MeshSlotScheduler([closed_cell("c0", "siso-coded")],
                             prebuild=False, device="cpu").device.type \
        == "cpu"
    assert link.build_classical(scn, device="cpu").device.type == "cpu"
    # the quantized precisions and SIC build and run on the CPU
    slot = coding.make_coded_slot(ofdm.make_generator(0, "cpu"), scn, 1)
    for kw, name in (
            (dict(precision="int8"), "classical@int8/siso-qpsk-r12-snr8"),
            (dict(sic=True), "classical+sic/siso-qpsk-r12-snr8")):
        rx = link.build_classical(scn, device="cpu", **kw)
        assert rx.name == name and rx.device.type == "cpu"
        assert tuple(rx.run(slot)["crc_ok"].shape) == \
            (1, coding.codewords_per_slot(scn))


@pytest.mark.parametrize("kind", ["deeprx", "cevit"])
def test_neural_builders_default_to_cuda(kind):
    import torch

    from repro_torch.phy import link

    scn = scenarios.get_scenario("siso-qam16-r12-snr15")
    build = link.PIPELINE_BUILDERS[kind]
    if torch.cuda.is_available():
        assert build(scn).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build(scn)
    assert build(scn, device="cpu").device.type == "cpu"
    rx = build(scn, precision="int8", device="cpu")
    assert rx.name == f"{kind}@int8/{scn.name}" and rx.precision == "int8"


def _chip_smoke():
    import importlib.util

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_grad_guard_refuses_operands_that_require_grad():
    """The kernels write fresh tensors through ctypes, which autograd
    cannot see: with grad mode on, an operand that requires grad is
    refused (every CUDA wrapper reaches the guard through
    ``require_cuda``, before any device check)."""
    import torch

    from repro_torch.kernels import _build

    w = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.require_no_grad("k", torch.ones(3), w)
    with pytest.raises(RuntimeError, match="requires grad"):
        _build.require_cuda("k", x=(torch.ones(3), torch.float32),
                            w=(w, torch.float32))
    with torch.no_grad():
        _build.require_no_grad("k", w)
    _build.require_no_grad("k", w.detach(), torch.ones(3))
    with pytest.raises(ValueError, match="CUDA"):  # then the device check
        _build.require_cuda("k", x=(w.detach(), torch.float32))


def _static_initializers(text: str) -> list:
    """The text of every ``static`` variable definition with an
    initializer, up to its ``;`` at bracket depth 0 (so a lambda's body
    is included)."""
    out = []
    for m in re.finditer(r"\bstatic\b[^;{}()]*=", text):
        depth, i = 0, m.start()
        while i < len(text):
            ch = text[i]
            if ch in "([{":
                depth += 1
            elif ch in ")]}":
                depth -= 1
            elif ch == ";" and depth == 0:
                break
            i += 1
        out.append(text[m.start():i])
    return out


def test_no_source_caches_a_device_attribute_process_wide():
    """The SM count and a kernel's dynamic shared-memory limit belong to
    one device: no source keeps them in a function-local ``static``
    initialised once per process; only ``hopper.cuh``'s per-device
    helpers call ``cudaFuncSetAttribute``."""
    from repro_torch.kernels import _build

    setters = set()
    for path in sorted(_build.CSRC.iterdir()):
        if path.suffix not in (".cu", ".cuh"):
            continue
        text = path.read_text()
        if "cudaFuncSetAttribute(" in text:
            setters.add(path.name)
        for init in _static_initializers(text):
            assert "cudaFuncSetAttribute" not in init, (path.name, init)
            assert "MultiProcessorCount" not in init, (path.name, init)
    assert setters == {"hopper.cuh"}


def test_device_us_fails_when_the_trace_misses_the_kernel(monkeypatch):
    """A CUPTI trace without the kernel's events is taken again, up to
    ``TRACE_TRIES`` times, and then fails the case: never a silent None.
    A trace that recorded only some of the calls gives the mean per
    launch; a call's kernels are summed."""
    smoke = _chip_smoke()
    tries = []

    def other_kernel(fn, reps):
        tries.append(reps)
        return [("void other_kernel<float>(float*)", 3.0)] * reps

    monkeypatch.setattr(smoke, "_trace", other_kernel)
    with pytest.raises(RuntimeError, match="no CUPTI event"):
        smoke.device_us(lambda: None, "te_gemm_kernel", reps=4)
    assert tries == [4] * smoke.TRACE_TRIES and smoke.TRACE_TRIES == 3
    traces = iter([[], [("te_gemm_kernel<float, 32>", 2.0)] * 3
                   + [("row_softmax_kernel", 1.0)] * 2])
    monkeypatch.setattr(smoke, "_trace", lambda fn, reps: next(traces))
    assert smoke.device_us(lambda: None, smoke.TE_GEMM_SYMBOLS,
                           reps=4) == 3.0
    monkeypatch.setattr(smoke, "_trace", lambda fn, reps: [])
    with pytest.raises(RuntimeError, match="CUPTI"):
        smoke.device_total_us(lambda: None, reps=4)
    # two launches of b a call, of a once; some calls not recorded
    monkeypatch.setattr(smoke, "_trace", lambda fn, reps:
                        [("a", 1.0)] * 3 + [("b", 2.0)] * 6)
    assert smoke.device_total_us(lambda: None, reps=4) == 5.0
