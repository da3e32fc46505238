"""Port vs reference: the neural receivers (DeepRx, CE-ViT).

The reference's weights are carried across (``*_params_from_numpy``), so
both packages run the same networks; on the CPU the port's GEMMs and
attention are the plain twins of its kernels.

* **Models.**  ``deeprx_apply`` / ``cevit_apply`` against the reference's
  fused path (TE GEMM and MHA Pallas kernels in interpret mode, on shapes
  that tile) and its unfused jnp path, at small widths with nonzero
  biases and LayerNorm affines: rtol 1e-4, atol 1e-5 of the largest
  |out| (im2col GEMM against XLA's conv, and a fused-vs-split qkv
  projection, sum in other orders).
* **Pipelines.**  ``build_deeprx`` / ``build_cevit`` at their default
  widths on JAX-drawn coded slots (SISO and 2x2, full 256-subcarrier
  grid): LLR signs agree on >= 99.9%, LLR values within rtol 1e-3 / atol
  1e-5 of the largest |LLR|, CRC flags equal, TTI / stage-cycle / energy
  reports equal.
* **Closed loop.**  ``SlotScheduler("siso-coded", receiver=...)`` replays
  a live reference run field for field (the reference serves its unfused
  network to save CPU time; its fused path is held by the model tests).
* **Initialisation.**  The port's own seeded weights follow the
  reference's init distributions (it cannot replay ``jax.random``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common import params as ref_params
from repro.phy import link as ref_link
from repro.phy import models as ref_models
from repro.phy import scenarios as ref_scn
from repro.serve import runtime as ref_runtime
from repro_torch.common import params
from repro_torch.phy import link, models, ofdm, scenarios
from repro_torch.serve import runtime
# the reference's jitted one-slot draws and the closed-loop comparison
from test_torch_closed_loop import _JaxSlotFactory, _assert_same, _snapshot
from test_torch_pipeline import jax_slots
from _port_share import port_share  # noqa: F401


def _np_tree(tree, rng=None):
    """A reference param tree as numpy; with ``rng``, every all-zero or
    all-one leaf (biases, LayerNorm affines) is redrawn, so the carried
    weights exercise them."""
    def leaf(x):
        x = np.asarray(x)
        if rng is not None and (np.all(x == 0) or np.all(x == 1)):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
        return x

    return jax.tree.map(leaf, tree)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_deeprx_apply_matches_reference(fused):
    rng = np.random.default_rng(1)
    rcfg = ref_models.DeepRxConfig(channels=16, blocks=2, bits_per_re=4,
                                   in_features=6)
    tree = _np_tree(ref_models.init_deeprx(jax.random.PRNGKey(1), rcfg),
                    rng)
    feats = rng.standard_normal((2, 4, 16, 6)).astype(np.float32)  # M = 128
    want = ref_models.deeprx_apply(tree, rcfg, feats, fused=fused)
    cfg = models.DeepRxConfig(**dataclasses.asdict(rcfg))
    got = models.deeprx_apply(models.deeprx_params_from_numpy(tree, "cpu"),
                              cfg, torch.from_numpy(feats))
    assert tuple(got.shape) == (2, 4, 16, 4)
    _close(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_cevit_apply_matches_reference(fused):
    rng = np.random.default_rng(2)
    rcfg = ref_models.CEViTConfig(d_model=32, heads=2, layers=2, d_ff=64,
                                  patch=4)
    tree = _np_tree(ref_models.init_cevit(jax.random.PRNGKey(2), rcfg), rng)
    feats = rng.standard_normal((4, 64, 4)).astype(np.float32)
    want = ref_models.cevit_apply(tree, rcfg, feats, fused=fused)
    cfg = models.CEViTConfig(**dataclasses.asdict(rcfg))
    got = models.cevit_apply(models.cevit_params_from_numpy(tree, "cpu"),
                             cfg, torch.from_numpy(feats))
    assert got.dtype == torch.complex64 and tuple(got.shape) == (4, 64)
    _close(got.numpy(), want, 1e-4)


def test_feature_builders_match_reference():
    rng = np.random.default_rng(3)
    b, n_sym, n_sc = 2, 14, 32
    cplx = lambda *s: (rng.standard_normal(s)
                       + 1j * rng.standard_normal(s)).astype(np.complex64)
    y, h_ls = cplx(b, n_sym, n_sc), cplx(b, n_sc)
    pm = rng.random((n_sym, n_sc)) < 0.25
    nv = np.float32(0.3)
    want = ref_models.deeprx_features(
        {"y": y, "pilot_mask": pm, "noise_var": nv}, h_ls)
    got = models.deeprx_features(
        {"y": torch.from_numpy(y), "pilot_mask": torch.from_numpy(pm),
         "noise_var": torch.tensor(nv)}, torch.from_numpy(h_ls))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = ref_models.cevit_features(h_ls, pm[0], nv)
    got = models.cevit_features(torch.from_numpy(h_ls),
                                torch.from_numpy(pm[0]), torch.tensor(nv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# pipelines at the builders' default widths
# ---------------------------------------------------------------------------

_NAMES = ["siso-qam16-r12-snr15", "mimo2x2-qam16-r12-snr17"]
_FROM_NUMPY = {"deeprx": models.deeprx_params_from_numpy,
               "cevit": models.cevit_params_from_numpy}


def _port_twin(ref_p, kind: str, **kw):
    """The port's pipeline of ``kind`` on the reference pipeline's rung,
    with its weights carried across, on the CPU."""
    return link.build_pipeline(
        kind, scenarios.get_scenario(ref_p.scenario.name),
        params=_FROM_NUMPY[kind](_np_tree(ref_p.params), "cpu"),
        device="cpu", **kw)


@pytest.fixture(scope="module")
def slots():
    return {name: jax_slots(name, 2, 31 + i)
            for i, name in enumerate(_NAMES)}


@pytest.mark.parametrize("kind", ["deeprx", "cevit"])
@pytest.mark.parametrize("name", _NAMES)
def test_neural_pipeline_matches_reference(slots, name, kind):
    ref_p = ref_link.build_pipeline(kind, ref_scn.get_scenario(name),
                                    fused=False, fused_rx=True)
    port_p = _port_twin(ref_p, kind, fused_rx=True)
    assert port_p.name == ref_p.name
    want = {k: np.asarray(v) for k, v in ref_p.run(slots[name]).items()}
    got = {k: v.numpy() for k, v in
           port_p.run(ofdm.slot_from_numpy(slots[name], "cpu")).items()}

    assert got["llr"].shape == want["llr"].shape
    agree = float(np.mean((got["llr"] > 0) == (want["llr"] > 0)))
    assert agree >= 0.999, agree
    _close(got["llr"], want["llr"], 1e-3)
    assert np.array_equal(got["crc_ok"], want["crc_ok"])
    if kind == "cevit":
        _close(got["h_hat"], want["h_hat"], 1e-4)

    assert port_p.tti_report(batch=8) == ref_p.tti_report(batch=8)
    assert dataclasses.asdict(port_p.energy_report()) == \
        dataclasses.asdict(ref_p.energy_report())
    assert {k: dataclasses.asdict(v) for k, v in
            port_p.stage_cycles().items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_p.stage_cycles().items()}


# ---------------------------------------------------------------------------
# closed loop
# ---------------------------------------------------------------------------

_LOOP = dict(n_users=3, batch_size=2, arrival_rate=0.8, snr_spread_db=2.0,
             max_retx=2, seed=11)


def _replay(kind: str, ref_options: dict, port_options: dict):
    # prebuild=False: the reference compiles each rung at its first batch
    ref_sch = ref_runtime.SlotScheduler("siso-coded", receiver=kind,
                                        options=ref_options, prebuild=False,
                                        **_LOOP)
    pipelines = [_port_twin(r.pipeline, kind, **port_options)
                 for r in ref_sch.runners]
    want = _snapshot(ref_sch, ref_sch.run(6))
    factory = _JaxSlotFactory()
    sch = runtime.SlotScheduler("siso-coded", receiver=kind,
                                pipelines=pipelines, device="cpu",
                                slot_factory=factory, **_LOOP)
    got = _snapshot(sch, sch.run(6))
    assert factory.calls == got["report"]["n_slots"] > 0
    _assert_same(got, want, f"closed-loop[{kind}]")
    assert got["report"]["mean_harq_rounds"] > 1.0  # HARQ was exercised
    for r, rr in zip(sch.runners, ref_sch.runners):
        assert r.pipeline.name == rr.pipeline.name
        assert r.pipeline.tti_report(batch=2) == \
            rr.pipeline.tti_report(batch=2)
        assert {k: dataclasses.asdict(v) for k, v in
                r.pipeline.stage_cycles().items()} == \
            {k: dataclasses.asdict(v) for k, v in
             rr.pipeline.stage_cycles().items()}


def test_cevit_closed_loop_replays_live_reference_run():
    _replay("cevit", {"fused": False, "fused_rx": True}, {"fused_rx": True})


def test_deeprx_closed_loop_replays_live_reference_run():
    # conv_out's width is the rung's bits per RE, so each rung carries its
    # own reference weights across (``_replay`` converts them per rung)
    _replay("deeprx", {"fused": False}, {})


def test_port_native_neural_loop_conserves_jobs():
    sch = runtime.SlotScheduler(
        "siso-coded", receiver="cevit", options={"fused_rx": True},
        n_users=2, batch_size=2, arrival_rate=1.0, max_retx=1, seed=3,
        device="cpu")
    rep = sch.run(3)
    loop = sch.loop
    queued = [j.job_id for u in loop.users for j in u.backlog]
    assert sorted(loop.finalized_jobs + queued) == \
        list(range(loop._job_ids.n))
    assert rep.n_slots > 0 and rep.receiver == "cevit"
    # untrained weights: the loop NACKs (nearly) every block
    assert rep.first_tx_bler > 0.9


# ---------------------------------------------------------------------------
# the port's own initialisation
# ---------------------------------------------------------------------------

def test_port_init_follows_reference_distributions():
    rcfg = ref_models.CEViTConfig(d_model=64, heads=4, layers=2, d_ff=128)
    cfg = models.CEViTConfig(**dataclasses.asdict(rcfg))
    p = models.init_cevit(ofdm.make_generator(0, "cpu"), cfg)
    assert params.count_params(p) == \
        ref_params.count_params(ref_models.cevit_schema(rcfg))
    # scaled: normal / sqrt(fan_in), fan_in = the second-to-last dim
    for w, fan_in in ((p["blocks"][0]["w1"], 64), (p["embed"], 16),
                      (p["blocks"][1]["w2"], 128)):
        assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert abs(float(p["pos"].std()) / 0.02 - 1.0) < 0.05
    assert torch.equal(p["blocks"][0]["ln1"]["g"], torch.ones(64))
    assert torch.equal(p["blocks"][0]["b1"], torch.zeros(128))

    dcfg = models.DeepRxConfig(channels=32, blocks=2, bits_per_re=2,
                               in_features=6)
    d = models.init_deeprx(ofdm.make_generator(0, "cpu"), dcfg)
    # an HWIO conv weight's fan_in is cin, not kh * kw * cin
    w = d["blocks"][0]["conv1"]["w"]
    assert abs(float(w.std()) * np.sqrt(32) - 1.0) < 0.05
    assert params.tree_size_bytes(d) == 4 * params.count_params(d)
    # the same seed gives the same weights; another seed other weights
    again = models.init_deeprx(ofdm.make_generator(0, "cpu"), dcfg)
    other = models.init_deeprx(ofdm.make_generator(1, "cpu"), dcfg)
    assert torch.equal(d["conv_in"]["w"], again["conv_in"]["w"])
    assert not torch.equal(d["conv_in"]["w"], other["conv_in"]["w"])


def test_builders_check_carried_weights():
    scn = scenarios.get_scenario("siso-qam16-r12-snr15")  # 4 bits per RE
    dcfg = models.DeepRxConfig(channels=32, blocks=2, bits_per_re=2,
                               in_features=6)
    wrong = models.init_deeprx(ofdm.make_generator(0, "cpu"), dcfg)
    with pytest.raises(ValueError, match="shape"):
        link.build_deeprx(scn, params=wrong, device="cpu")
    rx = link.build_cevit(scn, device="cpu")
    assert rx.params is not None and rx.name == "cevit/siso-qam16-r12-snr15"
    assert [s.name for s in rx.stages] == [
        "cfft", "ls_che", "cevit_che", "mmse_detect", "llr_demod",
        "ldpc_decode"]
