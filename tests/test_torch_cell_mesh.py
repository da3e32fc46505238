"""Port vs reference: multi-cell serving (``serve/cell_mesh.py``).

* **Live replay.**  A two-cell reference ``MeshSlotScheduler`` run
  (``siso-coded``, ``fused=True``, SIC's mesh coupling on, the two cells'
  lanes at different noise variances) runs live once for this file; the
  port replays it from the reference's own slots (the ``slot_factory`` of
  ``tests/test_torch_closed_loop.py``), with every (group, rung, lane
  bucket) step captured before the first TTI and with each captured at
  first use.  The
  mesh report outside the unstable set, each cell's report, tick log and
  users, and the finalized and queued job ids must be equal.
* **The folded step against ``vmap``.**  On a 64-subcarrier grid, three
  lanes of distinct noise variance through the port's lane step (lanes
  folded into the kernels' batch axis) against the reference's
  ``jax.vmap(pipeline._apply)`` at the port's LLR gates, and against the
  port's own single-cell step on each lane's slots (decisions equal,
  float planes at rtol 1e-5): fused classical, fused SIC and CE-ViT.
* **Port-native invariants** on a shrunk-grid ladder (the reference's
  ``tests/test_mesh_closed_loop.py``): conservation under load skew with
  handover, handover moves whole users, shedding takes only new-data
  jobs, a one-cell mesh equals the port's ``SlotScheduler``, seed
  determinism, isolated cell streams.
* **The open-loop engine** (the reference's ``tests/test_cell_mesh.py``):
  groups by shape, per-cell parity with ``PhyServeEngine``, ``steal``
  against ``pad``, bad inputs.
* **Registry and mesh**: lane steps' keys, ``make_cell_mesh``'s grids,
  the bucket rule, and a two-entry grid that serves (the grid path is
  held to the reference in ``tests/test_torch_cell_mesh_grid.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.phy import coding as ref_coding
from repro.phy import link as ref_link
from repro.phy import scenarios as ref_scn
from repro.serve import cell_mesh as ref_mesh
from repro_torch.distributed.sharding import cell_slot_placement
from repro_torch.launch.mesh import make_cell_mesh
from repro_torch.phy import coding, link, models, ofdm, scenarios
from repro_torch.serve import (
    CellMeshEngine, MeshSlotScheduler, PhyServeEngine, SlotScheduler, cell,
    closed_cell, runtime,
)
from repro_torch.serve.cell_mesh import stage_lanes
from repro_torch.serve.exec_registry import (
    ExecRegistry, exec_key_for, slot_schema, template_slot,
)
from test_torch_closed_loop import _UNSTABLE, _JaxSlotFactory, _assert_same
from _port_share import port_share  # noqa: F401

# ---------------------------------------------------------------------------
# live replay of a two-cell reference run
# ---------------------------------------------------------------------------

_RUNG0_SNR = scenarios.get_scenario(
    scenarios.get_ladder("siso-coded").rungs[0]).snr_db
_MESH_KW = dict(batch_size=2, max_retx=2, seed=11)
_TICKS = 4


def _two_cells(closed):
    return [
        closed("c0", "siso-coded", n_users=2, arrival_rate=0.8,
               tx_power_db=0.0, coupling_db=-15.0, fused=True),
        closed("c1", "siso-coded", n_users=2, arrival_rate=0.8,
               snr_db=_RUNG0_SNR + 2.0, tx_power_db=-3.0,
               coupling_db=-15.0, fused=True),
    ]


def _mesh_snapshot(sch, rep) -> dict:
    rep = dataclasses.asdict(rep)
    return {
        "report": {k: v for k, v in rep.items() if k not in _UNSTABLE},
        "cells": {name: {k: v for k, v in c.items() if k not in _UNSTABLE}
                  for name, c in rep["cells"].items()},
        "ticks": [[dataclasses.asdict(t) for t in loop.tick_log]
                  for loop in sch.loops],
        "users": [[(u.user_id, u.mcs, u.olla, u.snr_db) for u in loop.users]
                  for loop in sch.loops],
        "finalized": sch.finalized_job_ids(),
        "queued": sch.queued_job_ids(),
    }


@functools.lru_cache(maxsize=None)
def _reference_mesh_run() -> dict:
    """The live reference run, once for every port run of this file
    (``prebuild=False``: compile timing is outside the compared fields)."""
    sch = ref_mesh.MeshSlotScheduler(_two_cells(ref_mesh.closed_cell),
                                     prebuild=False, **_MESH_KW)
    return _mesh_snapshot(sch, sch.run(_TICKS))


@pytest.mark.parametrize("prebuild", [False, True])
def test_mesh_replays_live_reference_run(prebuild):
    want = _reference_mesh_run()
    factory = _JaxSlotFactory()
    sch = MeshSlotScheduler(_two_cells(closed_cell), device="cpu",
                            slot_factory=factory, prebuild=prebuild,
                            registry=ExecRegistry(), **_MESH_KW)
    # the coupling gives the two cells' lanes different noise variances
    assert [loop.interferer_db for loop in sch.loops] == [(-18.0,),
                                                          (-15.0,)]
    rep = sch.run(_TICKS)
    got = _mesh_snapshot(sch, rep)
    assert factory.calls == got["report"]["n_slots"] > 0
    _assert_same(got, want, "mesh")
    assert got["report"]["mean_harq_rounds"] > 1.0
    assert sorted(got["finalized"] + got["queued"]) == \
        list(range(sch.jobs_submitted))
    # one step per (group, rung, bucket) acquired: every bucket a tick can
    # emit before the first TTI with prebuild, else each at first use
    acquired = sum(len(g._execs) for g in sch.groups)
    assert rep.executables_compiled == acquired and rep.cache_hits == 0
    if prebuild:  # 2 cells x 2 users: up to 4 lanes, buckets 1, 2 and 4
        assert sch._capture_buckets(sch.groups[0]) == (1, 2, 4)
        assert acquired == 3 * len(sch.groups[0].rungs)
    assert rep.n_steps > 0 and rep.steady_tick_s is not None
    # some step served both cells' lanes, each at its own noise variance
    assert sch.n_real_lanes > rep.n_steps


# ---------------------------------------------------------------------------
# the folded lane step against the reference's vmap
# ---------------------------------------------------------------------------

_SMOKE = dict(n_subcarriers=64, fft_size=64, n_taps=4, delay_spread=1.0)
_LANE_SNR = (0.0, 2.5, 5.0)  # dB above the rung's: one noise_var a lane
_LANE_B = 2


def _shrunk(pkg, name: str):
    s = pkg.get_scenario(name)
    return s.replace(grid=dataclasses.replace(s.grid, **_SMOKE))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _lanes(name: str) -> tuple:
    """Three lanes of ``name`` at distinct SNRs, ``_LANE_B`` coded slots
    each (the port's generator; both packages take the same arrays), and
    their ``(lanes, ...)`` stack of every key."""
    scn = _shrunk(scenarios, name)
    lanes = [
        {k: v.numpy() for k, v in coding.make_coded_slot(
            ofdm.make_generator(40 + i, "cpu"),
            scn.replace(snr_db=scn.snr_db + d), _LANE_B).items()}
        for i, d in enumerate(_LANE_SNR)
    ]
    stacked = {k: np.stack([l[k] for l in lanes]) for k in lanes[0]}
    assert len(set(stacked["noise_var"].tolist())) == len(_LANE_SNR)
    return lanes, stacked


@functools.lru_cache(maxsize=None)
def _lane_case(name: str, kind: str, opts: tuple) -> tuple:
    """(reference vmapped state, port lane-step state, port per-lane
    single-step states, staged batch) for :func:`_lanes` of ``name``."""
    lanes, stacked = _lanes(name)
    ref_s = _shrunk(ref_scn, name)
    # the reference caches its data-RE index as jnp arrays: fill the cache
    # eagerly, or the jit below caches a tracer
    ref_coding._data_re_index(ref_s.grid)
    ref_p = ref_link.build_pipeline(kind, ref_s, **dict(opts))
    want = jax.jit(jax.vmap(ref_p._apply))(
        {k: jnp.asarray(v) for k, v in stacked.items()})
    want = {k: np.asarray(v) for k, v in want.items()}

    kw = dict(opts)
    if ref_p.params is not None:
        kw["params"] = models.cevit_params_from_numpy(
            _np_tree(ref_p.params), "cpu")
        kw.pop("fused", None)
    port_p = link.build_pipeline(kind, _shrunk(scenarios, name),
                                 device="cpu", **kw)
    (shard,) = cell_slot_placement(
        {k: torch.from_numpy(v) for k, v in stacked.items()},
        make_cell_mesh(len(lanes), "cpu"),
        batched_keys=runtime.BATCHED_KEYS)
    staged = shard.staged
    reg = ExecRegistry()
    step = reg.acquire_pipeline_step(port_p, staged, batch=_LANE_B,
                                     lanes=len(lanes))
    got = {k: v.clone() if isinstance(v, torch.Tensor) else v
           for k, v in step(staged).items()}
    singles = []
    for lane in lanes:
        batch = ofdm.slot_from_numpy(lane, "cpu")
        one = reg.acquire_pipeline_step(port_p, batch, batch=_LANE_B)
        singles.append({k: v.clone() for k, v in one(batch).items()
                        if isinstance(v, torch.Tensor)})
    return want, got, singles, staged


_LANE_CASES = [
    ("siso-qam16-r12-snr15", "classical", (("fused", True),)),
    ("mimo4x4-qam16-mu-snr18", "classical",
     (("fused", True), ("sic", True))),
    ("siso-qam16-r12-snr15", "cevit", (("fused", False),)),
]


def _close(got, want, rtol):
    """The port's LLR-gate form: ``rtol`` and an atol of 1e-5 of the
    plane's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name,kind,opts", _LANE_CASES)
def test_folded_lane_step_matches_reference_vmap(name, kind, opts):
    want, got, _, staged = _lane_case(name, kind, opts)
    assert tuple(staged["noise_var"].shape) == (len(_LANE_SNR),)
    llr = got["llr"].numpy()
    assert llr.shape == want["llr"].shape  # (lanes, batch, ...)
    agree = float(np.mean((llr > 0) == (want["llr"] > 0)))
    assert agree >= 0.999, agree
    _close(llr, want["llr"], 1e-3)
    for k in ("crc_ok", "decode_iters"):
        assert np.array_equal(got[k].numpy(), want[k]), k
    ok = want["crc_ok"].astype(bool)
    assert np.array_equal(got["info_bits_hat"].numpy()[ok],
                          want["info_bits_hat"][ok])
    _close(got["h_hat"].numpy(), want["h_hat"], 1e-4)
    # the lanes differ: a step that read lane 0's noise_var for all of
    # them would give another nv_eff on lanes 1 and 2
    nv_eff = got["nv_eff"].numpy()
    assert not np.allclose(nv_eff[0], nv_eff[1])
    _close(nv_eff, want["nv_eff"], 1e-3)


@pytest.mark.parametrize("name,kind,opts", _LANE_CASES)
def test_folded_lane_step_matches_single_cell_steps(name, kind, opts):
    """Each lane against the single-cell step on its slots: decisions
    equal; the float planes differ only by the CPU GEMMs' batch-dependent
    rounding (the LS twin's einsum; on the card the kernels are per row),
    held at rtol 1e-5 in the port's LLR-gate form."""
    _, got, singles, _ = _lane_case(name, kind, opts)
    for i, one in enumerate(singles):
        for k in ("crc_ok", "info_bits_hat", "decode_iters"):
            assert torch.equal(got[k][i], one[k]), (i, k)
        assert torch.equal(got["llr"][i] > 0, one["llr"] > 0), i
        for k in ("llr", "h_hat", "x_hat", "nv_eff", "cw_llr"):
            a, b = got[k][i], one[k]
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            _close(a.numpy(), b.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# port-native invariants of the closed loop (shrunk-grid ladder)
# ---------------------------------------------------------------------------

# wall-clock-dependent report fields: everything else must be equal
_WALL_FIELDS = {
    "wall_s", "slots_per_sec", "goodput_bits_per_sec",
    "compile_time_s", "executables_compiled", "cache_hits",
    "first_tick_s", "steady_tick_s",
}


@pytest.fixture
def ladder(monkeypatch) -> str:
    """A two-rung ladder of 64-subcarrier clones of coded rungs, registered
    in the port's registries for one test only (other test files hold the
    registries to the reference's catalogue)."""
    rungs = []
    for name, new in (("siso-qpsk-r12-snr8", "mcl-qpsk-r12"),
                      ("siso-qam16-r12-snr15", "mcl-qam16-r12")):
        s = scenarios.get_scenario(name).replace(name=new)
        monkeypatch.setitem(scenarios._REGISTRY, new, s.replace(
            grid=dataclasses.replace(s.grid, **_SMOKE)))
        rungs.append(new)
    monkeypatch.setitem(scenarios._LADDERS, "mcl-siso",
                        scenarios.MCSLadder("mcl-siso", tuple(rungs)))
    return "mcl-siso"


def _mesh(ladder: str, n_cells: int, **kw) -> MeshSlotScheduler:
    return MeshSlotScheduler.uniform(
        ladder, n_cells, device="cpu", registry=ExecRegistry(),
        options={"fused": True}, **kw)


def _assert_conservation(sch: MeshSlotScheduler):
    ids = sorted(sch.finalized_job_ids() + sch.queued_job_ids())
    assert len(ids) == len(set(ids)), "transport-block job duplicated"
    assert ids == list(range(sch.jobs_submitted))


def test_conservation_under_load_skew_and_handover(ladder):
    sch = _mesh(ladder, 4, n_users=2, arrival_rate=0.5, hot_cells=1, hot_factor=8.0,
                batch_size=2, max_batches_per_tick=1, deadline_ttis=1,
                max_retx=1, seed=5)
    rep = sch.run(6)
    assert rep.handovers > 0 and rep.jobs_shed > 0
    _assert_conservation(sch)
    assert rep.jobs_shed == sum(l.jobs_shed for l in sch.loops)
    # every step's lanes are its real lanes and the fillers up to a bucket
    assert rep.n_steps > 0 and sch.n_real_lanes >= rep.n_steps
    assert rep.n_filler_lanes == sch.n_filler_lanes
    # drain: stop arrivals, lift the pool cap, every job finalizes and
    # every HARQ buffer is freed
    for loop in sch.loops:
        loop.arrival_rate = 0.0
        loop.max_batches_per_tick = None
    for _ in range(32):
        if sch.backlog == 0:
            break
        sch.tick()
    assert sch.backlog == 0 and sch.harq_open == 0
    assert sorted(sch.finalized_job_ids()) == list(range(sch.jobs_submitted))


def test_handover_moves_whole_users_and_their_jobs(ladder):
    sch = _mesh(ladder, 2, n_users=2, arrival_rate=0.0, batch_size=2,
                max_batches_per_tick=1, deadline_ttis=0, seed=0)
    sch.loops[0].inject_backlog(6)
    n_users = sum(len(l.users) for l in sch.loops)
    sch.tick()
    assert sch.loops[0].handover_out >= 1
    assert sch.loops[1].handover_in == sch.loops[0].handover_out
    assert sum(len(l.users) for l in sch.loops) == n_users
    uids = [u.user_id for l in sch.loops for u in l.users]
    assert len(uids) == len(set(uids))
    _assert_conservation(sch)


def test_shedding_takes_only_new_data_jobs(ladder):
    rungs = scenarios.get_ladder(ladder).scenarios()
    loop = runtime.CellLoop(rungs, rng=runtime.cell_rng(3), n_users=2,
                            batch_size=2, max_batches_per_tick=1,
                            deadline_ttis=0, device="cpu")
    loop.inject_backlog(3)
    # the tail job of user 0 has a HARQ process in flight
    busy = loop.users[0].backlog[-1]
    busy.harq = runtime.HarqProcess(mcs=0, info=None, prior=None,
                                    acked=np.zeros(1, bool))
    assert loop.pending_jobs() == 6 > loop.capacity_jobs() == 2
    shed = loop.shed_tail(4)
    # user 0's tail is HARQ-active, so only user 1's new-data jobs go
    assert shed == [5, 4, 3]
    assert busy in loop.users[0].backlog and loop.jobs_shed == 3
    assert loop.finalized_jobs == shed
    queued = [j.job_id for u in loop.users for j in u.backlog]
    assert sorted(queued + loop.finalized_jobs) == list(range(6))
    assert runtime.CellLoop(rungs, rng=runtime.cell_rng(0),
                            device="cpu").capacity_jobs() == float("inf")


@pytest.mark.parametrize("snr_db", [21.0, None])  # clean, then with HARQ
def test_one_cell_mesh_matches_slot_scheduler(ladder, snr_db):
    kw = dict(n_users=3, arrival_rate=0.7, batch_size=2, max_retx=2,
              snr_db=snr_db, seed=11)
    mesh = _mesh(ladder, 1, **kw)
    single = SlotScheduler(ladder, device="cpu", registry=ExecRegistry(),
                           options={"fused": True}, **kw)
    rep_m = dataclasses.asdict(mesh.run(5).cells["cell0"])
    rep_s = dataclasses.asdict(single.run(5))
    if snr_db is None:
        assert rep_m["mean_harq_rounds"] > 1.0
    for k in _WALL_FIELDS:
        rep_m.pop(k), rep_s.pop(k)
    assert rep_m == rep_s


def _drop_wall(rep: dict) -> dict:
    for k in _WALL_FIELDS:
        rep.pop(k)
    for c in rep.get("cells", {}).values():
        for k in _WALL_FIELDS:
            c.pop(k)
    return rep


def test_mesh_run_is_deterministic_from_seed(ladder):
    reps = [_drop_wall(dataclasses.asdict(_mesh(
        ladder, 3, n_users=2, arrival_rate=0.9, snr_spread_db=2.0, batch_size=2,
        max_retx=2, seed=13).run(4))) for _ in range(2)]
    assert reps[0] == reps[1]


def test_cell_streams_are_isolated(ladder):
    def run(rate1):
        specs = [
            closed_cell("c0", ladder, n_users=2, arrival_rate=0.7),
            closed_cell("c1", ladder, n_users=2, arrival_rate=rate1),
        ]
        sch = MeshSlotScheduler(specs, batch_size=2, seed=23, device="cpu",
                                registry=ExecRegistry())
        return _drop_wall(dataclasses.asdict(sch.run(4).cells["c0"]))

    assert run(0.7) == run(1.5)


# ---------------------------------------------------------------------------
# the open-loop engine
# ---------------------------------------------------------------------------

_SISO = ofdm.GridConfig(n_subcarriers=64, fft_size=64, n_taps=4,
                        delay_spread=1.0)
_MIMO = dataclasses.replace(_SISO, n_tx=2, n_rx=2)


def _siso(name, snr_db=18.0):
    return scenarios.get_scenario("siso-qam16-snr12").replace(
        grid=_SISO, snr_db=snr_db, name=name)


def _mimo(name, snr_db=8.0):
    return scenarios.get_scenario("mimo2x2-qpsk-snr8").replace(
        grid=_MIMO, snr_db=snr_db, name=name)


def _four_cells():
    return [cell("c0", _siso("A")), cell("c1", _siso("B", snr_db=24.0)),
            cell("c2", _mimo("C")), cell("c3", _mimo("D", snr_db=14.0))]


def _engine(specs, **kw) -> CellMeshEngine:
    return CellMeshEngine(specs, device="cpu", registry=ExecRegistry(), **kw)


def test_cells_group_by_shape_not_by_snr():
    eng = _engine(_four_cells(), batch_size=2, prebuild=False)
    assert len(eng.groups) == 2  # SISO pair + MIMO pair, SNR ignored
    assert sorted(len(g.cell_idxs) for g in eng.groups) == [2, 2]
    assert len({g.pipeline.name for g in eng.groups}) == 2
    specs = [cell("a", _siso("A")), cell("b", _siso("B"), receiver="cevit"),
             cell("c", _siso("C"), mmse_smooth=False)]
    assert len(_engine(specs, batch_size=2, prebuild=False).groups) == 3


def test_per_cell_parity_with_single_cell_engine():
    """A cell served on the mesh against the same slots through the port's
    single-cell ``PhyServeEngine``: the reference's gates (soft metrics to
    rtol 1e-3, at most 2 payload-bit flips a slot)."""
    specs = _four_cells()
    eng = _engine(specs, batch_size=2)
    reqs = eng.submit_traffic(7, {"c0": 3, "c1": 2, "c2": 2, "c3": 1})
    rep = eng.run()
    assert (rep.n_cells, rep.n_groups, rep.n_slots) == (4, 2, 8)
    assert rep.executables_compiled == 2 and rep.mesh_shape == (1, 1)
    assert all(r.done for rs in reqs.values() for r in rs)
    assert "cells/2 groups" in rep.summary()
    assert sum(r.n_slots for r in rep.cells.values()) == 8
    for spec in specs:
        rx = link.build_pipeline("classical", spec.scenario, device="cpu")
        single = PhyServeEngine(rx, batch_size=2)
        mirror = [single.submit(r.slot) for r in reqs[spec.name]]
        single.run()
        for a, b in zip(reqs[spec.name], mirror):
            flips = (abs(a.metrics["ber"] - b.metrics["ber"])
                     * spec.scenario.data_bits_per_slot)
            assert flips <= 2
            for k in a.metrics:
                if k != "ber":
                    np.testing.assert_allclose(a.metrics[k], b.metrics[k],
                                               rtol=1e-3, atol=1e-4)


def test_steal_drains_hot_cell_in_fewer_steps():
    specs = [cell("hot", _siso("A")), cell("cold", _siso("B"))]
    traffic = {"hot": 8, "cold": 0}
    reps = {}
    for balance in ("steal", "pad"):
        eng = _engine(specs, batch_size=2, balance=balance)
        eng.submit_traffic(3, traffic)
        reps[balance] = eng.run()
    # stealing gives the hot cell the idle cell's lane: 2 steps vs 4
    assert reps["steal"].n_steps == 2 and reps["pad"].n_steps == 4
    assert reps["steal"].n_stolen > 0 and reps["pad"].n_stolen == 0
    assert reps["steal"].n_slots == reps["pad"].n_slots == 8
    eng = _engine([cell("c0", _siso("A")), cell("c1", _siso("B"))],
                  batch_size=4, balance="pad")
    eng.submit_traffic(torch.Generator().manual_seed(5), {"c0": 4, "c1": 1})
    rep = eng.run()
    assert rep.n_steps == 1 and rep.n_padded == 3  # c1's lane 1 -> 4


def test_bad_inputs_raise(ladder):
    with pytest.raises(ValueError, match="balance"):
        _engine([cell("x", _siso("A"))], balance="round-robin")
    with pytest.raises(ValueError, match="duplicate"):
        _engine([cell("x", _siso("A")), cell("x", _siso("B"))])
    eng = _engine([cell("x", _siso("A"))], prebuild=False)
    with pytest.raises(KeyError):
        eng.submit("nope", template_slot(_siso("A"), device="cpu"))
    with pytest.raises(ValueError, match="duplicate"):
        MeshSlotScheduler([closed_cell("x", ladder)] * 2, device="cpu")


# ---------------------------------------------------------------------------
# the registry's lane steps and the mesh
# ---------------------------------------------------------------------------

def test_lane_step_keys_and_reacquire():
    scn = _shrunk(scenarios, "siso-qam16-r12-snr15")
    p = link.build_classical(scn, fused=True, device="cpu")
    mesh = make_cell_mesh(2, "cpu")
    slot = template_slot(scn, harq=True, device="cpu")
    (shard,) = stage_lanes([([slot], 1), ([slot], 1)], mesh)
    staged = shard.staged
    reg = ExecRegistry()
    step = reg.acquire_pipeline_step(p, staged, batch=2, lanes=2)
    # the reference's rule: a lane step donates on the card, not on the CPU
    key = exec_key_for(p, 2, lanes=2, donate=False,
                       schema=slot_schema(staged))
    assert reg.keys() == [key] and (key.lanes, key.donate) == (2, False)
    assert reg.acquire_pipeline_step(p, staged, batch=2, lanes=2) is step
    assert reg.stats.cache_hits == 1
    out = step(staged)
    assert tuple(out["crc_ok"].shape[:2]) == (2, 2)
    assert tuple(out["noise_var"].shape) == (2,)
    # a single-cell step of the same pipeline is another key
    single = reg.acquire_pipeline_step(
        p, runtime.stack_slots([slot], 1), batch=2)
    assert single is not step and len(reg) == 2
    # a lane stack of another lane count is refused by the step
    with pytest.raises(ValueError):
        step(stage_lanes([([slot], 1)] * 3, mesh)[0].staged)


def test_placement_holds_side_info_and_noise_per_lane():
    scn = _shrunk(scenarios, "siso-qam16-r12-snr15")
    mesh = make_cell_mesh(2, "cpu")
    a = template_slot(scn, harq=True, device="cpu")
    b = dict(a, noise_var=a["noise_var"] * 2.0)
    (shard,) = stage_lanes([([a], 0), ([b], 0)], mesh, bucket=3)
    staged = shard.staged
    assert staged["noise_var"].tolist() == [
        float(a["noise_var"]), float(b["noise_var"]), float(a["noise_var"])]
    assert tuple(staged["prior_llr"].shape[:2]) == (3, 1)
    assert tuple(staged["pilot_seq"].shape) == tuple(a["pilot_seq"].shape)
    bad = dict(b, pilot_seq=-a["pilot_seq"])
    with pytest.raises(ValueError, match="pilot_seq"):
        stage_lanes([([a], 0), ([bad], 0)], mesh)
    pending = []
    stage_lanes([([a], 0), ([bad], 0)], mesh, pending=pending)
    with pytest.raises(ValueError, match="differs across the lanes"):
        pending[0].verify()


def test_cell_mesh_shape_and_multi_device_refusal(ladder):
    """The grid shapes (the reference's ``gcd`` rule over a repeated CPU
    device), the reference's ``ValueError`` for a bucket policy that the
    ``cell`` axis does not divide, and a two-entry grid that serves (it
    no longer refuses): both frontends, one step a shard."""
    from repro_torch.serve.exec_registry import FixedBuckets

    assert make_cell_mesh(4, "cpu").shape == (1, 1)
    devs = [torch.device("cpu")] * 4
    assert make_cell_mesh(6, devices=devs).shape == (2, 2)
    assert make_cell_mesh(8, devices=devs).shape == (4, 1)
    assert make_cell_mesh(1, devices=devs).shape == (1, 4)
    wide = make_cell_mesh(2, devices=devs[:2])
    assert (wide.shape, wide.cell, wide.batch) == ((2, 1), 2, 1)
    assert wide.distinct_devices() == [torch.device("cpu")]
    cells = [closed_cell("c0", ladder, fused=True),
             closed_cell("c1", ladder, fused=True)]
    with pytest.raises(ValueError, match="not a multiple of the mesh cell"):
        MeshSlotScheduler(cells, mesh=wide, device="cpu",
                          bucket_policy=FixedBuckets((1, 2)))
    sch = MeshSlotScheduler(cells, mesh=wide, device="cpu", batch_size=2,
                            seed=3, registry=ExecRegistry())
    rep = sch.run(2)
    assert rep.mesh_shape == (2, 1) and rep.n_steps > 0
    assert all(len(steps) == 2 for g in sch.groups
               for steps in g._execs.values())
    eng = _engine([cell("x", _siso("A")), cell("y", _siso("B"))],
                  mesh=wide, batch_size=2)
    eng.submit_traffic(7, 2)
    rep = eng.run()
    assert rep.mesh_shape == (2, 1) and rep.n_slots == 4
    assert rep.executables_compiled == 2  # one step a grid entry


def test_detect_twins_take_one_value_or_one_per_lane():
    from repro_torch.kernels import rx_fused

    scn = _shrunk(scenarios, "mimo4x4-qam16-mu-snr18")
    s = scn.make_batch(ofdm.make_generator(9, "cpu"), 4)
    y, h = s["y"], s["h"][:, 0]
    nv = torch.tensor([0.05, 0.4], dtype=torch.float32)
    for twin in (rx_fused.mmse_detect_demap_torch,
                 rx_fused.sic_detect_demap_torch):
        got = twin(y, h, nv, scn.modem)
        for lane in range(2):
            rows = slice(2 * lane, 2 * lane + 2)
            want = twin(y[rows], h[rows], nv[lane], scn.modem)
            for g, w in zip(got, want):
                assert torch.equal(g[rows], w)
        one = twin(y, h, nv[:1], scn.modem)
        for g, w in zip(one, twin(y, h, nv[0], scn.modem)):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="noise values"):
            twin(y, h, torch.ones(3), scn.modem)


@pytest.mark.parametrize("ladder", ["siso-coded", "mimo4x4-qam16-mu-snr18"])
def test_ladder_exec_specs_match_reference(ladder):
    kw = dict(receiver="classical", options={"fused": True, "sic": True},
              batch=8, lane_buckets=(0, 4), harq=True)
    want = ref_scn.ladder_exec_specs(ladder, **kw)
    got = scenarios.ladder_exec_specs(ladder, **kw)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
