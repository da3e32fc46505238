"""Port vs reference: the closed-loop TTI runtime.

* **Trajectory parity.**  The configuration of the single-cell golden
  trajectory (``tests/test_golden_trajectories.py::_single_cell_snapshot``)
  runs live in both packages with ``options={"fused": True}``.  The port
  is fed the reference's own slots: its ``slot_factory`` draws
  ``make_coded_slot(jax.random.PRNGKey(seed), ...)`` from the integer the
  cell stream hands it, which is the integer the reference turns into its
  key.  Tick log, per-user (mcs, olla, snr_db) and every report field
  outside the golden test's unstable set must be equal (floats to rtol
  1e-5, as the golden test compares them).  The port runs twice against
  one reference run: with every rung's registry step acquired before the
  first TTI (``prebuild=True``) and with each acquired at its rung's
  first batch; the compile fields must count one step per rung acquired.
* **Conservation.**  A port-native run (torch slots) accounts for every
  issued job exactly once.
* **Slot generator statistics.**  Torch cannot replay ``jax.random``
  streams, so the port's own generator is held to the reference's draws:
  noise variance, mean channel power, and each ``siso-coded`` rung's BLER
  at its operating point (the port's receiver decodes both generators'
  slots; the receiver itself is held to the reference elsewhere).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.phy import coding as ref_coding
from repro.phy import ofdm as ref_ofdm
from repro.phy import scenarios as ref_scn
from repro.serve import runtime as ref_runtime
from repro_torch.phy import coding, link, ofdm, scenarios
from repro_torch.serve import runtime
from repro_torch.serve.exec_registry import ExecRegistry
# the reference's jitted one-slot draws, compiled once per scenario for
# this file and the pipeline parity tests
from test_torch_pipeline import jax_slots
from _port_share import port_share  # noqa: F401

# fields derived from wall time or compile history (the golden test's set)
_UNSTABLE = {"wall_s", "slots_per_sec", "goodput_bits_per_sec",
             "info_bits_per_sec", "cells",
             "compile_time_s", "executables_compiled", "cache_hits",
             "first_tick_s", "steady_tick_s"}

_CONFIG = dict(n_users=3, batch_size=2, arrival_rate=0.8,
               snr_spread_db=2.0, max_retx=2, seed=11,
               options={"fused": True})


def _assert_same(got, want, path):
    if isinstance(want, float):
        assert isinstance(got, (int, float)), f"{path}: {got!r} != {want!r}"
        assert np.isclose(got, want, rtol=1e-5, atol=1e-8), (
            f"{path}: {got!r} != {want!r}")
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


def _snapshot(sch, rep) -> dict:
    return {
        "report": {k: v for k, v in dataclasses.asdict(rep).items()
                   if k not in _UNSTABLE},
        "ticks": [dataclasses.asdict(t) for t in sch.tick_log],
        "users": [(u.user_id, u.mcs, u.olla, u.snr_db) for u in sch.users],
    }


class _JaxSlotFactory:
    """The reference's slot for the cell stream's integer, as a port slot
    on the CPU."""

    def __init__(self):
        self.calls = 0

    def __call__(self, seed, scenario, batch, *, rv=None, info=None):
        self.calls += 1
        scn = ref_scn.get_scenario(scenario.name).replace(
            snr_db=scenario.snr_db, interferer_db=scenario.interferer_db)
        slot = ref_coding.make_coded_slot(
            jax.random.PRNGKey(seed), scn, batch, rv=rv,
            info=None if info is None else np.asarray(info))
        return ofdm.slot_from_numpy(
            {k: np.asarray(v) for k, v in slot.items()}, "cpu")


@functools.lru_cache(maxsize=None)
def _reference_run() -> dict:
    """The live reference run, once for every port run of this file."""
    # prebuild=False: the reference compiles each rung at its first batch
    # instead of drawing template slots first; compile timing is outside
    # the compared fields, the trajectory is not
    ref_sch = ref_runtime.SlotScheduler("siso-coded", prebuild=False,
                                        **_CONFIG)
    return _snapshot(ref_sch, ref_sch.run(6))


@pytest.mark.parametrize("prebuild", [False, True])
def test_trajectory_replays_live_reference_run(prebuild):
    want = _reference_run()
    factory = _JaxSlotFactory()
    sch = runtime.SlotScheduler("siso-coded", device="cpu",
                                slot_factory=factory, prebuild=prebuild,
                                registry=ExecRegistry(), **_CONFIG)
    rep = sch.run(6)
    got = _snapshot(sch, rep)
    assert factory.calls == got["report"]["n_slots"] > 0
    _assert_same(got, want, "closed-loop")
    # the run exercised HARQ and link adaptation, not just first shots
    assert got["report"]["mean_harq_rounds"] > 1.0
    assert len({u[1] for u in got["users"]}) > 1 or \
        any(u[2] != 0.0 for u in got["users"])
    # one registry step per rung acquired: every rung before the first TTI
    # with prebuild, else each rung at its first served batch; a runner
    # keeps its step, so no re-acquire (no hit) in a fresh registry
    served = sum(1 for r in sch.runners if r.n_batches)
    assert served == sum(1 for v in rep.mcs_occupancy.values() if v > 0)
    assert rep.executables_compiled == (len(sch.rungs) if prebuild
                                        else served)
    assert rep.cache_hits == 0 and rep.compile_time_s > 0.0
    assert rep.first_tick_s is not None and rep.steady_tick_s is not None


def test_port_native_run_conserves_jobs():
    sch = runtime.SlotScheduler(
        "siso-coded", n_users=4, batch_size=4, arrival_rate=1.0,
        max_retx=1, seed=3, device="cpu", options={"fused": True})
    rep = sch.run(5)
    loop = sch.loop
    queued = [j.job_id for u in loop.users for j in u.backlog]
    ids = sorted(loop.finalized_jobs + queued)
    assert ids == list(range(loop._job_ids.n))
    assert rep.n_arrivals == loop._job_ids.n
    assert rep.n_slots > 0 and rep.backlog_left == len(queued)
    assert rep.harq_open == sum(
        1 for u in loop.users for j in u.backlog if j.harq is not None)


def _residual_var(slot) -> tuple:
    """Per-slot empirical var of y - H x on the data REs, and noise_var."""
    y, x, h = (torch.as_tensor(np.asarray(slot[k]))
               for k in ("y", "x", "h"))
    hb = h.expand(y.shape[0], y.shape[1], *h.shape[2:])
    r = y - torch.einsum("bmsrt,bmst->bmsr", hb, x)
    m = torch.as_tensor(np.asarray(slot["data_mask"]))
    e = (r.abs() ** 2)[:, m]  # (B, n_data, n_rx)
    return e.mean(dim=(1, 2)).numpy(), float(np.asarray(slot["noise_var"]))


@pytest.mark.parametrize("name", ["siso-qam16-r12-snr15",
                                  "mimo2x2-qam16-r12-snr17"])
def test_port_noise_variance_matches_slot_side_info(name):
    gen = ofdm.make_generator(5, "cpu")
    per_slot, nv = _residual_var(
        coding.make_coded_slot(gen, scenarios.get_scenario(name), 32))
    assert abs(per_slot.mean() / nv - 1.0) < 0.02


def _within_4se(x: np.ndarray, expect: float) -> bool:
    """The mean of per-slot values ``x`` is within 4 standard errors of
    ``expect``."""
    return abs(x.mean() - expect) <= 4 * x.std(ddof=1) / np.sqrt(x.size)


@pytest.mark.parametrize("name", ["mimo2x2-qam16-r12-intf-snr20",
                                  "siso-qam16-r12-aging-snr18",
                                  "mimo4x4-qam16-mu-snr18"])
def test_port_generator_interference_aging_near_far(name):
    """The generator's other physics: a co-channel interferer (counted in
    ``noise_var``), a channel that ages per symbol, and per-user gains."""
    scn = scenarios.get_scenario(name)
    g = scn.grid
    slot = coding.make_coded_slot(ofdm.make_generator(13, "cpu"), scn, 32)
    t_steps = g.n_symbols if scn.doppler_rho < 1.0 else 1
    assert tuple(slot["h"].shape) == (32, t_steps, g.n_subcarriers,
                                      g.n_rx, g.n_tx)
    per_slot, nv = _residual_var(slot)
    assert _within_4se(per_slot / nv, 1.0)
    if scn.doppler_rho < 1.0:  # consecutive symbols decorrelate
        h = slot["h"]
        rho = (h[:, 1:] * h[:, :-1].conj()).mean().real / \
            (h.abs() ** 2).mean()
        assert abs(float(rho) - scn.doppler_rho) < 0.05
    for t, p_db in enumerate(scn.user_power_db or ()):
        p = (slot["h"][..., t].abs() ** 2).mean(dim=(1, 2, 3)).numpy()
        assert _within_4se(p, 10.0 ** (p_db / 10.0))


def test_port_channel_power_matches_reference_draws():
    g = scenarios.get_scenario("siso-qam16-r12-snr15").grid
    h = ofdm.tdl_channel(ofdm.make_generator(9, "cpu"), g, 256)
    p = (h.abs() ** 2).mean(dim=(1, 2, 3)).numpy()
    h_ref = np.asarray(ref_ofdm.tdl_channel(
        jax.random.PRNGKey(9), ref_scn.get_scenario(
            "siso-qam16-r12-snr15").grid, 256))
    p_ref = (np.abs(h_ref) ** 2).mean(axis=(1, 2, 3))
    se = np.sqrt(p.var(ddof=1) / p.size + p_ref.var(ddof=1) / p_ref.size)
    assert abs(p.mean() - p_ref.mean()) <= 4 * se
    assert abs(p.mean() - 1.0) < 0.2  # unit-power PDP


@pytest.mark.parametrize("name", scenarios.get_ladder("siso-coded").rungs)
def test_port_bler_matches_reference_draws(name):
    scn = scenarios.get_scenario(name)
    rx = link.build_classical(scn, fused=True, device="cpu")

    def per_slot_bler(slot):
        return link.slot_metrics(rx.run(slot), scn,
                                 per_slot=True)["bler"].numpy()

    b_port = per_slot_bler(coding.make_coded_slot(
        ofdm.make_generator(21, "cpu"), scn, 32))
    b_ref = per_slot_bler(ofdm.slot_from_numpy(jax_slots(name, 32, 21),
                                               "cpu"))
    se = np.sqrt(b_port.var(ddof=1) / 32 + b_ref.var(ddof=1) / 32)
    assert abs(b_port.mean() - b_ref.mean()) <= 4 * se, (
        b_port.mean(), b_ref.mean(), se)


def test_open_loop_engine_serves_and_reports():
    from repro_torch.serve import PhyServeEngine

    eng = PhyServeEngine.from_scenario("siso-qam16-r12-snr15",
                                       batch_size=2, device="cpu",
                                       fused=True)
    reqs = eng.submit_traffic(7, n_users=5)
    rep = eng.run()
    assert [r.user_id for r in reqs] == list(range(5))
    assert all(r.done for r in reqs)
    assert (rep.n_slots, rep.n_batches, rep.batch_size) == (5, 3, 2)
    assert rep.bler == pytest.approx(np.mean([r.metrics["bler"]
                                              for r in reqs]))
    assert rep.pipeline == "classical+fused/siso-qam16-r12-snr15"
    er = eng.pipeline.energy_report()
    assert rep.gops_per_watt == er.gops_per_watt
    assert rep.tti == eng.pipeline.tti_report(batch=2)
    assert rep.info_bits_per_sec is not None and rep.ber is not None
