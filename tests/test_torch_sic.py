"""Port vs reference: successive interference cancellation (SIC), the
MU-MIMO near-far receiver.

* **Twin.**  ``sic_detect_demap`` on a CPU tensor runs its plain twin; it
  is held to three reference implementations on the same numpy-drawn
  inputs: the jnp twin ``rx_fused.sic_detect_demap_jnp``, the staged
  oracle ``ref.sic_detect_demap_ref`` (``classical.mimo_sic_detect_ext``
  plus the modem's demapper, solved by ``linalg.solve``) and, on a small
  grid, the Pallas kernel in interpret mode.  The port's own staged
  ``classical.mimo_sic_detect_ext`` is a second oracle for the twin.
  Tolerances are the detect+demap ones (x_hat and nv_eff rtol 1e-4 / atol
  1e-5; LLRs rtol 1e-3 / atol 1e-5 of the largest |LLR|).  A hard
  decision sits on a level boundary only by chance, but when it does the
  REs of the later stages differ by a whole cancellation error: at most 2
  such REs are allowed, and they are left out of the value comparison.
* **Pipeline.**  ``build_classical(sic=True)`` on the registered
  ``mimo4x4-qam16-mu-snr18`` grid (256 subcarriers: the 4-stream DMRS
  comb needs the full grid), JAX-drawn slots: CRC flags, payloads and
  iteration counts equal, at most 2 LLR sign flips, LLR values within
  rtol 1e-3 / atol 1e-5 of the largest |LLR|, TTI / stage-cycle / energy
  reports and total cycles equal.
* **Closed loop.**  ``SlotScheduler("mimo4x4-qam16-mu-snr18",
  options={"fused": True, "sic": True})`` replays a live reference run
  field for field, fed the reference's own slots.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_oracle
from repro.kernels import rx_fused as ref_rx
from repro.phy import classical as ref_classical
from repro.phy import link as ref_link
from repro.phy import ofdm as ref_ofdm
from repro.phy import scenarios as ref_scn
from repro.serve import runtime as ref_runtime
from repro_torch.kernels import rx_fused
from repro_torch.phy import classical, link, ofdm, scenarios
from repro_torch.serve import runtime
# the reference's jitted one-slot draws and the closed-loop comparison
from test_torch_closed_loop import _JaxSlotFactory, _assert_same, _snapshot
from test_torch_pipeline import assert_decode_matches_reference, jax_slots
from test_torch_rx_fused import _cgauss, port_modem, ref_modem
from _port_share import port_share  # noqa: F401

_SHAPES = [(1, 1), (2, 2), (4, 4), (8, 4)]
_MODEMS = ["qpsk", "qam16", "qam64", "qam256"]
# every modem at the shapes with compiled kernel instances, one each at
# shapes the kernels take by their runtime-sized route
# shapes the kernels take by their runtime-sized route, and the hand-built
# 1024-QAM modem (5 bits per axis, no compiled instance) at 2x2, 4x4, 3x3
_SIC_CASES = [(r, t, m) for r, t in _SHAPES for m in _MODEMS] + [
    (2, 1, "qpsk"), (4, 2, "qam16"), (3, 3, "qam64"), (8, 6, "qam16"),
    (2, 2, "qam1024"), (4, 4, "qam1024"), (3, 3, "qam1024")]
_MU = "mimo4x4-qam16-mu-snr18"


def _sic_inputs(n_rx, n_tx, modem_name, seed, b=1, n_sc=64, snr_db=18.0):
    """y = H diag(g) x + n with a near-far profile g (+6 dB down to -3 dB
    across the streams, strongest first) on a (b, 14, n_sc) grid."""
    rng = np.random.default_rng(seed)
    modem = ref_modem(modem_name)
    gain = 10.0 ** (np.linspace(6.0, -3.0, n_tx) / 20.0)
    h = (_cgauss(rng, (b, n_sc, n_rx, n_tx)) * gain).astype(np.complex64)
    bits = rng.integers(0, 2, (b, 14, n_sc, n_tx, modem.bits_per_symbol))
    x = np.asarray(modem.mod(jnp.asarray(bits)))
    nv = np.float32(n_tx * 10.0 ** (-snr_db / 10.0))
    y = (np.einsum("bsrt,bmst->bmsr", h, x)
         + np.sqrt(nv) * _cgauss(rng, (b, 14, n_sc, n_rx))).astype(
             np.complex64)
    return y, h, nv


def _port_sic(y, h, nv, modem_name):
    out = rx_fused.sic_detect_demap(
        torch.from_numpy(y), torch.from_numpy(h), torch.tensor(nv),
        port_modem(modem_name))
    return [o.numpy() for o in out]


def _decisions(x_hat, modem_name) -> np.ndarray:
    """(..., n_tx - 1, 2): each cancelled stream's nearest level index per
    axis, the decision its stage subtracts."""
    m = ref_modem(modem_name)
    lv = np.asarray(m.levels, np.float32)
    parts = np.stack([x_hat.real, x_hat.imag], -1)[..., :-1, :]
    d = (parts[..., None] * np.float32(np.sqrt(m.norm)) - lv) ** 2
    return np.argmin(d, axis=-1)


def _assert_sic_close(got, want, modem_name):
    """Values within the detect+demap tolerances on every RE whose
    cancellation decisions agree; at most 2 REs may decide otherwise."""
    x, nve, llr = got
    xr, nver, llrr = (np.asarray(a) for a in want)
    assert llr.shape == llrr.shape and x.shape == xr.shape
    same = np.all(_decisions(x, modem_name) == _decisions(xr, modem_name),
                  axis=(-1, -2))  # (B, n_sym, n_sc)
    assert int(np.sum(~same)) <= 2, int(np.sum(~same))
    np.testing.assert_allclose(x[same], xr[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nve[same], nver[same], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(llr[same], llrr[same], rtol=1e-3,
                               atol=1e-5 * float(np.abs(llrr).max()))
    assert np.mean(np.sign(llr) == np.sign(llrr)) >= 0.999


@pytest.mark.parametrize("n_rx,n_tx,modem_name", _SIC_CASES)
def test_sic_twin_matches_jnp(n_rx, n_tx, modem_name):
    y, h, nv = _sic_inputs(n_rx, n_tx, modem_name, seed=n_rx * 10 + n_tx)
    want = ref_rx.sic_detect_demap_jnp(
        jnp.asarray(y), jnp.asarray(h), jnp.float32(nv),
        ref_modem(modem_name))
    _assert_sic_close(_port_sic(y, h, nv, modem_name), want, modem_name)


@pytest.mark.parametrize("n_rx,n_tx", _SHAPES)
def test_sic_twin_matches_staged_oracle(n_rx, n_tx):
    # linalg.solve (LAPACK) against the unrolled elimination
    y, h, nv = _sic_inputs(n_rx, n_tx, "qam16", seed=3 + n_rx)
    want = ref_oracle.sic_detect_demap_ref(
        jnp.asarray(y), jnp.asarray(h), jnp.float32(nv),
        ref_ofdm.make_modem("qam16"))
    _assert_sic_close(_port_sic(y, h, nv, "qam16"), want, "qam16")


def test_sic_twin_matches_pallas_interpret():
    y, h, nv = _sic_inputs(2, 2, "qam16", seed=5)
    want = ref_rx.sic_detect_demap_pallas(
        jnp.asarray(y), jnp.asarray(h), jnp.float32(nv),
        ref_ofdm.make_modem("qam16"), interpret=True)
    _assert_sic_close(_port_sic(y, h, nv, "qam16"), want, "qam16")


@pytest.mark.parametrize("n_rx,n_tx", [(2, 2), (4, 4)])
def test_staged_sic_detector_matches_reference_and_twin(n_rx, n_tx):
    """``classical.mimo_sic_detect_ext`` (per (B*n_sym) rows) against the
    reference's and, per stream, against the fused twin."""
    y, h, nv = _sic_inputs(n_rx, n_tx, "qam16", seed=9)
    b, n_sym, n_sc, _ = y.shape
    yf = y.reshape(b * n_sym, n_sc, n_rx)
    hf = np.broadcast_to(h[:, None], (b, n_sym) + h.shape[1:]).reshape(
        b * n_sym, n_sc, n_rx, n_tx)
    x, nve = classical.mimo_sic_detect_ext(
        torch.from_numpy(yf), torch.from_numpy(np.ascontiguousarray(hf)),
        torch.tensor(nv), ofdm.make_modem("qam16"))
    xr, nver = ref_classical.mimo_sic_detect_ext(
        jnp.asarray(yf), jnp.asarray(hf), jnp.float32(nv),
        ref_ofdm.make_modem("qam16"))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(nve.numpy(), np.asarray(nver), rtol=1e-4,
                               atol=1e-5)
    xt, nvt, llr_t = _port_sic(y, h, nv, "qam16")  # the LLRs: no oracle
    _assert_sic_close(
        [x.numpy().reshape(xt.shape), nve.numpy().reshape(nvt.shape), llr_t],
        [xt, nvt, llr_t], "qam16")


# ---------------------------------------------------------------------------
# the SIC pipeline on the registered MU-MIMO grid
# ---------------------------------------------------------------------------

def _reports_equal(port_p, ref_p):
    assert port_p.tti_report(batch=8) == ref_p.tti_report(batch=8)
    assert dataclasses.asdict(port_p.energy_report()) == \
        dataclasses.asdict(ref_p.energy_report())
    assert dataclasses.asdict(port_p.total_cycles()) == \
        dataclasses.asdict(ref_p.total_cycles())
    assert {k: dataclasses.asdict(v) for k, v in
            port_p.stage_cycles().items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_p.stage_cycles().items()}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_sic_pipeline_matches_reference(fused):
    slot = jax_slots(_MU, 2, 41)
    ref_p = ref_link.build_classical(ref_scn.get_scenario(_MU), fused=fused,
                                     sic=True)
    port_p = link.build_classical(scenarios.get_scenario(_MU), fused=fused,
                                  sic=True, device="cpu")
    assert port_p.name == ref_p.name == (
        f"classical+sic{'+fused' if fused else ''}/{_MU}")
    assert [s.name for s in port_p.stages] == [s.name for s in ref_p.stages]
    want = {k: np.asarray(v) for k, v in ref_p.run(slot).items()}
    got = {k: v.numpy() for k, v in
           port_p.run(ofdm.slot_from_numpy(slot, "cpu")).items()}

    assert_decode_matches_reference(_MU, got, want)
    assert got["llr"].shape == want["llr"].shape
    assert int(np.sum((got["llr"] > 0) != (want["llr"] > 0))) <= 2
    np.testing.assert_allclose(got["llr"], want["llr"], rtol=1e-3,
                               atol=1e-5 * float(np.abs(want["llr"]).max()))
    np.testing.assert_allclose(got["h_hat"], want["h_hat"], rtol=1e-4,
                               atol=1e-5)
    _reports_equal(port_p, ref_p)
    # the staged solve is priced above the joint one
    joint = link.build_classical(scenarios.get_scenario(_MU), fused=True,
                                 device="cpu")
    assert port_p.stage_cycles()["sic_demap_fused"].pe_cycles > \
        joint.stage_cycles()["detect_demap_fused"].pe_cycles


# ---------------------------------------------------------------------------
# the MU-MIMO closed loop
# ---------------------------------------------------------------------------

_LOOP = dict(n_users=3, batch_size=2, arrival_rate=0.8, snr_spread_db=2.0,
             max_retx=2, seed=11, options={"fused": True, "sic": True})


def test_sic_closed_loop_replays_live_reference_run():
    ref_sch = ref_runtime.SlotScheduler(_MU, prebuild=False, **_LOOP)
    want = _snapshot(ref_sch, ref_sch.run(5))
    factory = _JaxSlotFactory()
    sch = runtime.SlotScheduler(_MU, device="cpu", slot_factory=factory,
                                **_LOOP)
    got = _snapshot(sch, sch.run(5))
    assert factory.calls == got["report"]["n_slots"] > 0
    _assert_same(got, want, "closed-loop[sic]")
    assert sch.runners[0].pipeline.name == \
        ref_sch.runners[0].pipeline.name == f"classical+sic+fused/{_MU}"
    assert got["report"]["mean_harq_rounds"] > 1.0  # HARQ was exercised
