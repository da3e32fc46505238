"""Port vs reference: the quantized (int8/fp8) LLR + decoder datapath,
served end to end.

* **Pipelines.**  ``build_classical(fused=True, precision=...)`` on the
  ``siso-coded`` rungs and the 2x2 rung, and ``build_deeprx`` /
  ``build_cevit(fused_rx=True)`` at int8 with the reference's weights
  carried across, on JAX-drawn coded slots.  Names, CRC flags, payloads
  and iteration counts equal, TTI / stage-cycle / energy reports and
  total cycles equal.
* **The LLR grid.**  Each package's quantized LLR plane is its own fp32
  LLR plane rounded onto the int8 grid (the port's exactly; the
  reference's up to 2 codes, since XLA under ``jax.jit`` multiplies by the
  reciprocal of the step instead of dividing).  The fp32 planes of the two
  packages agree to rtol 1e-3 / atol 1e-5 of the largest |LLR| (ROADMAP
  port conventions), so wherever they straddle a half step of the grid
  their int8 codes differ by one: every code differs by at most one step,
  and only at such straddling positions (a handful per batch of two
  16-QAM slots, of ~29k LLRs).
* **Closed loop.**  ``SlotScheduler("siso-coded", options={"fused": True,
  "precision": "int8"})`` replays a live reference run field for field,
  fed the reference's own slots.
* **Energy.**  Every ``build_*`` at every precision prices its datapath as
  the reference does.
"""
import dataclasses

import numpy as np
import pytest

from repro.phy import link as ref_link
from repro.phy import scenarios as ref_scn
from repro.serve import runtime as ref_runtime
from repro_torch.kernels import quant
from repro_torch.phy import link, ofdm, scenarios
from repro_torch.serve import runtime
# the reference's jitted one-slot draws, the closed-loop comparison and the
# neural receivers' weight carrier
from test_torch_closed_loop import (_CONFIG, _JaxSlotFactory, _assert_same,
                                    _snapshot)
from test_torch_neural import _port_twin
from test_torch_pipeline import jax_slots
from test_torch_sic import _reports_equal
from _port_share import port_share  # noqa: F401

_STEP = np.float32(quant.llr_scale())


def _grid_codes(llr_q: np.ndarray) -> np.ndarray:
    """The int8 codes of an LLR plane on the grid (checked to be on it)."""
    codes = llr_q / _STEP
    np.testing.assert_allclose(codes, np.rint(codes), rtol=0, atol=1e-3)
    return np.rint(codes)


def _round(llr: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(llr / _STEP), -127, 127)


def _assert_llr_grids(port_q, ref_q, port_fp32, ref_fp32):
    """Both quantized planes are their own fp32 planes on the int8 grid;
    the fp32 planes agree to the port tolerance, so the codes differ by at
    most one step, only where the fp32 planes straddle a half step."""
    np.testing.assert_allclose(port_fp32, ref_fp32, rtol=1e-3,
                               atol=1e-5 * float(np.abs(ref_fp32).max()))
    codes, codes_r = _grid_codes(port_q), _grid_codes(ref_q)
    assert np.array_equal(codes, _round(port_fp32))
    ref_moved = codes_r != _round(ref_fp32)
    assert int(ref_moved.sum()) <= 2
    diff = codes != codes_r
    assert np.abs(codes - codes_r).max() <= 1
    straddle = _round(port_fp32) != _round(ref_fp32)
    assert np.all(straddle[diff] | ref_moved[diff])


def _run(pipe, slot, port: bool) -> dict:
    if port:
        return {k: v.numpy() for k, v in
                pipe.run(ofdm.slot_from_numpy(slot, "cpu")).items()}
    return {k: np.asarray(v) for k, v in pipe.run(slot).items()}


def _assert_decode_equal(got, want):
    for k in ("crc_ok", "info_bits_hat", "decode_iters"):
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("name,precision", [
    ("siso-qpsk-r12-snr8", "int8"), ("siso-qam16-r12-snr15", "int8"),
    ("siso-qam16-r34-snr18", "int8"), ("mimo2x2-qam16-r12-snr17", "fp8"),
])
def test_quantized_classical_pipeline_matches_reference(name, precision):
    slot = jax_slots(name, 2, 51)
    build_ref = lambda p: ref_link.build_classical(
        ref_scn.get_scenario(name), fused=True, precision=p)
    build = lambda p: link.build_classical(
        scenarios.get_scenario(name), fused=True, precision=p,
        device="cpu")
    ref_p, port_p = build_ref(precision), build(precision)
    assert port_p.name == ref_p.name == \
        f"classical+fused@{precision}/{name}"
    assert port_p.precision == ref_p.precision == precision
    want, got = _run(ref_p, slot, False), _run(port_p, slot, True)
    _assert_decode_equal(got, want)
    _assert_llr_grids(got["llr"], want["llr"],
                      _run(build("fp32"), slot, True)["llr"],
                      _run(build_ref("fp32"), slot, False)["llr"])
    _reports_equal(port_p, ref_p)


@pytest.mark.parametrize("kind", ["deeprx", "cevit"])
def test_int8_neural_pipeline_matches_reference(kind):
    name = "siso-qam16-r12-snr15"
    slot = jax_slots(name, 2, 53)
    build_ref = lambda p: ref_link.build_pipeline(
        kind, ref_scn.get_scenario(name), fused=False, fused_rx=True,
        precision=p)
    ref_p = build_ref("int8")
    port_p = _port_twin(ref_p, kind, fused_rx=True, precision="int8")
    assert port_p.name == ref_p.name == f"{kind}@int8/{name}"
    assert [s.name for s in port_p.stages] == [s.name for s in ref_p.stages]
    if kind == "deeprx":
        assert "llr_quant@int8" in [s.name for s in port_p.stages]
    want, got = _run(ref_p, slot, False), _run(port_p, slot, True)
    assert np.array_equal(got["crc_ok"], want["crc_ok"])
    ref_fp32 = build_ref("fp32")
    _assert_llr_grids(
        got["llr"], want["llr"],
        _run(_port_twin(ref_fp32, kind, fused_rx=True), slot, True)["llr"],
        _run(ref_fp32, slot, False)["llr"])
    _reports_equal(port_p, ref_p)


def test_int8_closed_loop_replays_live_reference_run():
    cfg = dict(_CONFIG, options={"fused": True, "precision": "int8"})
    ref_sch = ref_runtime.SlotScheduler("siso-coded", prebuild=False, **cfg)
    want = _snapshot(ref_sch, ref_sch.run(6))
    factory = _JaxSlotFactory()
    sch = runtime.SlotScheduler("siso-coded", device="cpu",
                                slot_factory=factory, **cfg)
    got = _snapshot(sch, sch.run(6))
    assert factory.calls == got["report"]["n_slots"] > 0
    _assert_same(got, want, "closed-loop[int8]")
    assert got["report"]["precision"] == "int8"
    assert got["report"]["mean_harq_rounds"] > 1.0  # HARQ was exercised
    assert [r.pipeline.name for r in sch.runners] == \
        [r.pipeline.name for r in ref_sch.runners]


@pytest.mark.parametrize("precision", quant.PRECISIONS)
def test_energy_and_cycles_match_reference_at_every_precision(precision):
    """No slot runs: the pipelines' cost models and the energy model,
    priced at the precision, for every receiver the port serves."""
    cases = [("classical", "mimo4x4-qam16-mu-snr18",
              dict(fused=True, sic=True)),
             ("classical", "siso-qam16-r34-snr18", dict(fused=True)),
             ("classical", "mimo2x2-qam16-r12-snr17", dict(fused=False)),
             ("deeprx", "siso-qam16-r12-snr15", {}),
             ("cevit", "siso-qam16-r12-snr15", dict(fused_rx=True))]
    for kind, name, kw in cases:
        ref_p = ref_link.build_pipeline(kind, ref_scn.get_scenario(name),
                                        precision=precision, **kw)
        port_p = link.build_pipeline(kind, scenarios.get_scenario(name),
                                     precision=precision, device="cpu",
                                     **kw)
        assert port_p.name == ref_p.name
        assert port_p.precision == ref_p.precision
        _reports_equal(port_p, ref_p)
        assert dataclasses.asdict(port_p.energy_report(clock_hz=1.5e9)) \
            == dataclasses.asdict(ref_p.energy_report(clock_hz=1.5e9))
