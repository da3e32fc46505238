"""Port vs reference: supervised fault-tolerant serving (``serve/faults.py``,
``serve/supervisor.py``), on the reference's shrunk grid (64 subcarriers)
with a two-rung ``mcl-siso`` ladder registered in both packages for this
file only.

* **Live replay.**  One reference ``Supervisor`` run (two fused cells of
  distinct noise variance, 6 ticks, no watchdog) under a plan of a NaN
  burst, a corrupted slot, a retried step error, three stacked step
  errors that quarantine a bucket and a cell crash against a stale
  checkpoint (``checkpoint_every=2``) is replayed by the port from the
  reference's own slots (``_JaxSlotFactory``): the mesh report with its
  fault fields, each cell's report, tick log and users, and the
  finalized, queued and failed job ids must be equal.  The degraded lanes
  ran the fp32 unfused reference step in both packages.  A second, short
  pair of runs corrupts an int8 cell's slot: neither package degrades it.
* **``FaultPlan.seeded``** gives the reference's events over a grid of
  seeds, rates, ``max_crashes`` and ``max_seq``.
* **Snapshots cross the packages.**  A reference ``CellLoop`` snapshot,
  written by the reference's ``CheckpointManager``, restores into a port
  loop (``load_flat`` + ``restore_cell_loop``), and a port snapshot into
  a reference loop; the restored runs continue on shared slots and stay
  equal to the uninterrupted ones.  The flat names are equal.
* **Port-native invariants**, the reference's ``tests/test_supervisor.py``
  one for one (zero-fault identity, transparent degradation and retry,
  escalation, watchdog deferral, the quarantine lifecycle, lossless and
  stale crash recovery, checkpoint round trip, exact snapshot), and the
  supervised fault-conservation check of
  ``tests/test_fuzz_scenarios.py`` over seeded schedules.
"""
import dataclasses

import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as RefCheckpoints
from repro.phy import scenarios as ref_scn
from repro.serve import cell_mesh as ref_mesh
from repro.serve import faults as ref_faults
from repro.serve import supervisor as ref_sup
from repro_torch.checkpoint import CheckpointManager
from repro_torch.phy import scenarios
from repro_torch.serve import (
    FAULT_KINDS, FaultEvent, FaultPlan, MeshSlotScheduler, Supervisor,
    closed_cell, restore_cell_loop, snapshot_cell_loop,
)
from repro_torch.serve import faults as port_faults
from repro_torch.serve.exec_registry import ExecRegistry
from test_torch_cell_mesh import _mesh_snapshot
from test_torch_closed_loop import _JaxSlotFactory, _assert_same
from _port_share import port_share  # noqa: F401

_SMOKE = dict(n_subcarriers=64, fft_size=64, n_taps=4, delay_spread=1.0)
_RUNGS = (("siso-qpsk-r12-snr8", "mcl-qpsk-r12"),
          ("siso-qam16-r12-snr15", "mcl-qam16-r12"))
LADDER = "mcl-siso"


@pytest.fixture(scope="module", autouse=True)
def ladder():
    """The shrunk two-rung ladder in both packages' registries, for this
    module only (other files hold the registries to the catalogue)."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (scenarios, ref_scn):
            for name, new in _RUNGS:
                s = pkg.get_scenario(name).replace(name=new)
                mp.setitem(pkg._REGISTRY, new, s.replace(
                    grid=dataclasses.replace(s.grid, **_SMOKE)))
            mp.setitem(pkg._LADDERS, LADDER, pkg.MCSLadder(
                LADDER, tuple(new for _, new in _RUNGS)))
        yield LADDER


# wall-clock fields; everything else must be equal
_WALL_FIELDS = {
    "wall_s", "slots_per_sec", "goodput_bits_per_sec",
    "compile_time_s", "executables_compiled", "cache_hits",
    "first_tick_s", "steady_tick_s",
}
# fault accounting: stripped only when a faulted run is held to a clean one
_FAULT_MESH_FIELDS = {
    "faults_injected", "step_retries", "degraded_batches",
    "quarantined_batches", "batches_deferred", "ticks_over_budget",
    "cell_quarantines", "crashes", "recoveries", "jobs_failed",
}
_FAULT_CELL_FIELDS = {
    "faults", "degraded_batches", "quarantined_batches",
    "quarantine_ticks", "crashes", "jobs_failed",
}


def _rung0_snr() -> float:
    return scenarios.get_scenario(_RUNGS[0][1]).snr_db


# ---------------------------------------------------------------------------
# live replay of a reference Supervisor run
# ---------------------------------------------------------------------------

_LIVE_TICKS = 6
_LIVE_KW = dict(batch_size=2, max_retx=2, seed=11, checkpoint_every=2,
                watchdog_s=None)


def _live_cells(closed):
    return [
        closed("c0", LADDER, n_users=2, arrival_rate=0.8, fused=True),
        closed("c1", LADDER, n_users=2, arrival_rate=0.8,
               snr_db=_rung0_snr() + 2.0, fused=True),
    ]


def _live_plan(pkg) -> object:
    ev = pkg.FaultEvent
    return pkg.FaultPlan(
        [ev("nan_llr", tick=1, seq=0, cell=0),
         ev("corrupt_slot", tick=2, seq=0, cell=1),
         ev("step_error", tick=3, seq=0)]
        + [ev("step_error", tick=4, seq=0)] * 3
        + [ev("cell_crash", tick=5, cell=1)])


def _sup_snapshot(sch, rep) -> dict:
    snap = _mesh_snapshot(sch, rep)
    snap["failed"] = sch.failed_job_ids()
    return snap


@pytest.fixture(scope="module")
def reference_run(ladder) -> dict:
    """The live reference run, once for this module (``prebuild=False``:
    compile timing is outside the compared fields)."""
    sch = ref_sup.Supervisor(_live_cells(ref_mesh.closed_cell),
                             fault_plan=_live_plan(ref_faults),
                             prebuild=False, **_LIVE_KW)
    return _sup_snapshot(sch, sch.run(_LIVE_TICKS))


def test_supervisor_replays_live_reference_run(reference_run):
    want = reference_run
    factory = _JaxSlotFactory()
    sch = Supervisor(_live_cells(closed_cell),
                     fault_plan=_live_plan(port_faults),
                     device="cpu", slot_factory=factory,
                     registry=ExecRegistry(), **_LIVE_KW)
    got = _sup_snapshot(sch, sch.run(_LIVE_TICKS))
    _assert_same(got, want, "supervised")
    rep = got["report"]
    # every fault path ran: two lanes degraded to the unfused reference
    # step, one retried step, a bucket quarantined after three attempts,
    # one crash recovered from a stale checkpoint
    assert rep["faults_injected"] == 7 and rep["degraded_batches"] == 2
    assert rep["step_retries"] == 3 and rep["quarantined_batches"] == 2
    assert rep["crashes"] == rep["recoveries"] == 1
    assert rep["jobs_failed"] == len(got["failed"]) > 0
    # the degradation steps: group 0's rung 0 at the buckets it degraded
    assert {key[:2] for key in sch._ref_execs} == {(0, 0)}
    assert sorted(got["finalized"] + got["queued"] + got["failed"]) == \
        list(range(sch.jobs_submitted))


def _int8_cells(closed):
    return [closed("q0", LADDER, n_users=2, arrival_rate=0.8, fused=True,
                   precision="int8")]


def _int8_plan(pkg) -> object:
    # tick 2 is the first after tick 0 with arrivals under seed 11
    return pkg.FaultPlan([pkg.FaultEvent("corrupt_slot", tick=2, seq=0,
                                         cell=0)])


def test_int8_corrupted_slot_matches_reference():
    """``inf`` in an int8 lane's ``y_time``: the int8 chain hands its
    decoder finite int8 codes, so ``cw_llr`` stays finite and the guard
    does not degrade, in the reference as in the port; the runs stay equal
    field for field."""
    ref = ref_sup.Supervisor(_int8_cells(ref_mesh.closed_cell),
                             fault_plan=_int8_plan(ref_faults),
                             prebuild=False, **_LIVE_KW)
    want = _sup_snapshot(ref, ref.run(4))
    sch = Supervisor(_int8_cells(closed_cell),
                     fault_plan=_int8_plan(port_faults), device="cpu",
                     slot_factory=_JaxSlotFactory(),
                     registry=ExecRegistry(), **_LIVE_KW)
    got = _sup_snapshot(sch, sch.run(4))
    _assert_same(got, want, "int8 corrupted slot")
    rep = got["report"]
    assert rep["faults_injected"] == 1 and rep["precision"] == "int8"
    assert rep["degraded_batches"] == rep["quarantined_batches"] == 0
    assert not sch._ref_execs


# ---------------------------------------------------------------------------
# FaultPlan.seeded parity
# ---------------------------------------------------------------------------

_ALL = {k: 0.4 for k in FAULT_KINDS}


@pytest.mark.parametrize("seed,rates,max_crashes,max_seq", [
    (0, {}, 1, 4),
    (1, {"nan_llr": 0.5, "corrupt_slot": 0.5}, 1, 4),
    (2, {"step_error": 0.6, "straggler": 0.4}, 1, 2),
    (3, {"cell_crash": 1.0, "nan_llr": 0.3}, 3, 1),
    (41, _ALL, 2, 1),
    (97, _ALL, 0, 8),
])
def test_seeded_plan_equals_reference(seed, rates, max_crashes, max_seq):
    kw = dict(straggler_s=0.007, max_crashes=max_crashes, max_seq=max_seq)
    want = ref_faults.FaultPlan.seeded(seed, 12, 5, rates, **kw)
    got = FaultPlan.seeded(seed, 12, 5, rates, **kw)
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in want]
    assert repr(got) == repr(want)
    if rates:
        assert len(got) > 0
    with pytest.raises(ValueError, match="unknown fault kinds"):
        FaultPlan.seeded(seed, 2, 2, {"meteor": 1.0})


# ---------------------------------------------------------------------------
# snapshots across the packages
# ---------------------------------------------------------------------------

_SNAP_KW = dict(n_users=2, arrival_rate=0.8, batch_size=2, max_retx=2,
                adapt=False, seed=11)


def _snap_kw() -> dict:
    # below the operating point, so HARQ processes are open mid-run
    return dict(_SNAP_KW, snr_db=_rung0_snr() - 3.0)


def _restore_mesh(dst, restore, src, flat: dict) -> None:
    """Put ``src``'s snapshot ``flat`` into the fresh mesh ``dst`` (each
    loop through ``restore``) and carry ``src``'s mesh counters over."""
    for loop in dst.loops:
        prefix = loop.name + "/"
        restore(loop, {k[len(prefix):]: v for k, v in flat.items()
                       if k.startswith(prefix)})
    dst.now = src.now
    dst.job_counter.n = src.job_counter.n
    for k in ("n_steps", "n_real_lanes", "n_filler_lanes"):
        setattr(dst, k, getattr(src, k))


def _flat_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype, k


def test_snapshots_restore_across_packages(tmp_path):
    ref_a = ref_mesh.MeshSlotScheduler.uniform(LADDER, 2, **_snap_kw())
    port_b = MeshSlotScheduler.uniform(
        LADDER, 2, device="cpu", slot_factory=_JaxSlotFactory(),
        registry=ExecRegistry(), **_snap_kw())
    ref_a.run(3)
    port_b.run(3)
    assert ref_a.harq_open > 0 and port_b.harq_open > 0
    snaps = {}
    for name, sch, snap in (("ref", ref_a, ref_sup.snapshot_cell_loop),
                            ("port", port_b, snapshot_cell_loop)):
        snaps[name] = {loop.name: snap(loop) for loop in sch.loops}
    for cell in snaps["ref"]:
        _flat_equal(snaps["port"][cell], snaps["ref"][cell])
    # the reference writes, the port restores, and the reverse
    RefCheckpoints(str(tmp_path / "r"), async_save=False).save(
        3, snaps["ref"])
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(
        3, snaps["port"])
    from_ref = CheckpointManager(str(tmp_path / "r")).load_flat(3)
    from_port = RefCheckpoints(str(tmp_path / "p")).load_flat(3)
    assert sorted(from_ref) == sorted(from_port)

    port_c = MeshSlotScheduler.uniform(
        LADDER, 2, device="cpu", slot_factory=_JaxSlotFactory(),
        registry=ExecRegistry(), **_snap_kw())
    _restore_mesh(port_c, restore_cell_loop, ref_a, from_ref)
    ref_d = ref_mesh.MeshSlotScheduler.uniform(LADDER, 2, **_snap_kw())
    _restore_mesh(ref_d, ref_sup.restore_cell_loop, port_b, from_port)
    # the restored HARQ payloads are the slot builder's: tensors on the
    # loop's device in the port, arrays in the reference
    harq = [j.harq for loop in port_c.loops for u in loop.users
            for j in u.backlog if j.harq is not None]
    assert harq and all(h.info.device.type == "cpu" for h in harq)
    for sch in (ref_a, port_b, port_c, ref_d):
        sch.run(3)
    a = _mesh_snapshot(ref_a, ref_a.report())
    _assert_same(_mesh_snapshot(port_b, port_b.report()), a, "port")
    _assert_same(_mesh_snapshot(port_c, port_c.report()), a, "ref->port")
    _assert_same(_mesh_snapshot(ref_d, ref_d.report()), a, "port->ref")


# ---------------------------------------------------------------------------
# port-native invariants (the reference's tests/test_supervisor.py)
# ---------------------------------------------------------------------------

_KW = dict(n_users=2, arrival_rate=0.8, batch_size=2, max_retx=2,
           adapt=False, seed=11)


def _uniform(cls, n_cells: int, **kw):
    return cls.uniform(LADDER, n_cells, device="cpu",
                       registry=ExecRegistry(), **kw)


def _strip(rep, faults: bool = False) -> dict:
    d = dataclasses.asdict(rep)
    for k in _WALL_FIELDS | (_FAULT_MESH_FIELDS if faults else set()):
        d.pop(k, None)
    for c in d["cells"].values():
        for k in _WALL_FIELDS | (_FAULT_CELL_FIELDS if faults else set()):
            c.pop(k, None)
    return d


def _assert_conservation(sch) -> None:
    failed = (sch.failed_job_ids() if hasattr(sch, "failed_job_ids")
              else [])
    ids = sorted(sch.finalized_job_ids() + sch.queued_job_ids() + failed)
    assert len(ids) == len(set(ids)), "transport-block job duplicated"
    assert ids == list(range(sch.jobs_submitted)), (
        f"conservation violated: {sch.jobs_submitted} submitted, "
        f"{len(ids)} accounted")


def _drain(sch, max_ticks: int = 64) -> None:
    """Stop arrivals, lift the cap and the watchdog, tick until empty."""
    for loop in sch.loops:
        loop.arrival_rate = 0.0
        loop.max_batches_per_tick = None
    sch.watchdog_s = None
    for _ in range(max_ticks):
        if sch.backlog == 0:
            return
        sch.tick()
    raise AssertionError(f"mesh did not drain: backlog={sch.backlog}")


def _assert_drains(sch) -> None:
    _assert_conservation(sch)
    _drain(sch)
    _assert_conservation(sch)
    assert sorted(sch.finalized_job_ids() + sch.failed_job_ids()) == \
        list(range(sch.jobs_submitted))
    assert sch.harq_open == 0


def test_zero_fault_supervised_run_is_identical():
    base = _uniform(MeshSlotScheduler, 3, **_KW)
    sup = _uniform(Supervisor, 3, fault_plan=FaultPlan.none(), **_KW)
    # fault fields are not stripped: they must be zero on both sides
    assert _strip(base.run(5)) == _strip(sup.run(5))
    assert sup._ref_execs == {} and sup.injector.total == 0
    _assert_conservation(sup)


# (plan, cells, ticks, fault counters) whose trajectory must equal the
# clean run's: a degraded lane reruns on the reference step, which for
# these unfused cells is the primary chain; a retried step re-stages
_TRANSPARENT = {
    "stage-corruption": (
        [FaultEvent("nan_llr", tick=1, seq=0, cell=0),
         FaultEvent("corrupt_slot", tick=2, seq=0, cell=1)], 3, 5,
        dict(faults_injected=2, degraded_batches=2, step_retries=0,
             quarantined_batches=0, crashes=0)),
    "step-error": (
        [FaultEvent("step_error", tick=1, seq=0)], 2, 4,
        dict(faults_injected=1, degraded_batches=0, step_retries=1,
             quarantined_batches=0, crashes=0)),
    "lossless-crash": (
        [FaultEvent("cell_crash", tick=3, cell=1)], 3, 6,
        dict(faults_injected=1, crashes=1, recoveries=1, jobs_failed=0)),
}


@pytest.mark.parametrize("case", sorted(_TRANSPARENT))
def test_transparent_faults_keep_the_clean_trajectory(case):
    events, n_cells, ticks, counts = _TRANSPARENT[case]
    sup = _uniform(Supervisor, n_cells, fault_plan=FaultPlan(events),
                   checkpoint_every=1, **_KW)
    rep = sup.run(ticks)
    for k, v in counts.items():
        assert getattr(rep, k) == v, k
    if case == "stage-corruption":
        assert sum(c.degraded_batches for c in rep.cells.values()) == 2
    if case == "lossless-crash":
        assert rep.cells["cell1"].crashes == 1
    base = _uniform(MeshSlotScheduler, n_cells, **_KW)
    assert _strip(base.run(ticks), faults=True) == _strip(rep, faults=True)
    _assert_conservation(sup)


def test_step_error_escalation_quarantines_bucket():
    # four stacked failures at the same bucket outlast max_step_retries=1
    plan = FaultPlan([FaultEvent("step_error", tick=1, seq=0)] * 4)
    sup = _uniform(Supervisor, 2, fault_plan=plan, max_step_retries=1,
                   quarantine_faults=1, **_KW)
    rep = sup.run(4)
    assert rep.step_retries == 1
    assert rep.quarantined_batches >= 1 and rep.cell_quarantines >= 1
    # the bucket's jobs were requeued, not lost
    _assert_drains(sup)


def test_straggler_trips_watchdog_and_defers_not_sheds():
    # two init_mcs values => two step buckets a tick; the straggler in
    # bucket 0 blows the budget, so bucket 1 is deferred (its jobs go back
    # to the queue heads: HARQ state untouched, nothing shed)
    specs = [
        closed_cell("w0", LADDER, n_users=2, arrival_rate=0.8, init_mcs=0),
        closed_cell("w1", LADDER, n_users=2, arrival_rate=0.8, init_mcs=1),
    ]
    plan = FaultPlan([
        FaultEvent("straggler", tick=t, seq=0, magnitude=0.05)
        for t in (1, 2, 3)
    ])
    sup = Supervisor(specs, fault_plan=plan, watchdog_s=0.02,
                     batch_size=2, max_retx=2, adapt=False, seed=13,
                     device="cpu", registry=ExecRegistry())
    rep = sup.run(4)
    assert rep.faults_injected >= 1
    assert rep.ticks_over_budget >= 1 and rep.batches_deferred >= 1
    assert rep.jobs_shed == 0
    _assert_drains(sup)
    assert sup.failed_job_ids() == []


def test_quarantine_then_probation_then_requarantine():
    plan = FaultPlan([
        FaultEvent("nan_llr", tick=1, seq=0, cell=0),
        FaultEvent("nan_llr", tick=4, seq=0, cell=0),
    ])
    sup = _uniform(Supervisor, 2, fault_plan=plan, quarantine_faults=1,
                   quarantine_ttis=2, probation_ttis=2,
                   **dict(_KW, arrival_rate=1.0, seed=17))
    rep = sup.run(7)
    # tick 1: fault -> quarantined (ticks 2, 3); tick 4: probation, the
    # second fault quarantines it again at once (ticks 5, 6)
    assert rep.cells["cell0"].faults == 2
    assert rep.cell_quarantines == 2
    assert rep.cells["cell0"].quarantine_ticks == 4
    assert rep.cells["cell1"].quarantine_ticks == 0
    # arrivals accrue while quarantined: the cell is muted, not dead
    assert rep.cells["cell0"].n_arrivals > 0
    _assert_conservation(sup)


def test_crash_with_stale_checkpoint_fails_lost_window_jobs():
    plan = FaultPlan([FaultEvent("cell_crash", tick=3, cell=0)])
    sup = _uniform(Supervisor, 2, fault_plan=plan, checkpoint_every=8,
                   **dict(_KW, arrival_rate=1.2, seed=23))
    rep = sup.run(5)
    assert rep.crashes == 1 and rep.recoveries == 1
    # only the construction-time checkpoint existed: jobs that lived
    # solely in the lost window are finalized as failed, not dropped
    assert rep.jobs_failed > 0
    assert rep.jobs_failed == len(sup.failed_job_ids())
    assert rep.cells["cell0"].jobs_failed == rep.jobs_failed
    _assert_drains(sup)


def test_checkpoint_roundtrip_resumes_identically(tmp_path):
    kw = _snap_kw()
    a = _strip(_uniform(MeshSlotScheduler, 2, **kw).run(6))
    first = _uniform(MeshSlotScheduler, 2, **kw)
    first.run(3)
    assert first.harq_open > 0, "the snapshot must cover open HARQ state"
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, {loop.name: snapshot_cell_loop(loop)
                 for loop in first.loops})
    resumed = _uniform(MeshSlotScheduler, 2, **kw)
    _restore_mesh(resumed, restore_cell_loop, first, mgr.load_flat(3))
    assert _strip(resumed.run(3)) == a
    _assert_conservation(resumed)


def test_snapshot_restore_cell_loop_is_exact():
    sch = _uniform(MeshSlotScheduler, 1, **_snap_kw())
    sch.run(3)
    src = sch.loops[0]
    dst = sch._make_loop(0)
    restore_cell_loop(dst, snapshot_cell_loop(src))
    assert dst.now == src.now
    assert dst.finalized_jobs == src.finalized_jobs
    assert dst.rng.bit_generator.state == src.rng.bit_generator.state
    assert len(dst.users) == len(src.users)
    n_harq = 0
    for ud, us in zip(dst.users, src.users):
        assert (ud.user_id, ud.mcs, ud.snr_db, ud.olla) == \
            (us.user_id, us.mcs, us.snr_db, us.olla)
        assert len(ud.backlog) == len(us.backlog)
        for jd, js in zip(ud.backlog, us.backlog):
            assert (jd.enq_tick, jd.job_id) == (js.enq_tick, js.job_id)
            assert (jd.harq is None) == (js.harq is None)
            if js.harq is None:
                continue
            n_harq += 1
            np.testing.assert_array_equal(jd.harq.prior, js.harq.prior)
            # the payload comes back as the builder made it
            assert jd.harq.info.dtype == js.harq.info.dtype
            assert jd.harq.info.device == js.harq.info.device
            assert np.array_equal(jd.harq.info.numpy(),
                                  js.harq.info.numpy())
            np.testing.assert_array_equal(jd.harq.acked, js.harq.acked)
            assert (jd.harq.n_tx, jd.harq.rv) == (js.harq.n_tx, js.harq.rv)
    assert n_harq > 0


# the reference's tests/test_fuzz_scenarios.py FAULT_RATE_SETS[4]
_EVERY_KIND = {k: 0.4 for k in FAULT_KINDS}


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_supervised_fault_conservation(seed):
    """The supervised mesh completes a seeded schedule of every fault kind
    with conservation exact, drains afterwards, and HARQ can still only
    recover blocks (residual <= first-tx BLER)."""
    n_ticks = 4
    plan = FaultPlan.seeded(seed, n_ticks, 2, _EVERY_KIND, max_seq=2)
    sup = _uniform(Supervisor, 2, fault_plan=plan, n_users=2,
                   arrival_rate=0.8, batch_size=2, max_retx=1,
                   max_step_retries=1, quarantine_faults=1,
                   quarantine_ttis=1, probation_ttis=1, checkpoint_every=1,
                   adapt=False, seed=seed)
    sup.run(n_ticks)
    assert sup.injector.total > 0
    _assert_conservation(sup)
    for loop in sup.loops:
        loop.arrival_rate = 0.0
    for _ in range(64):
        if sup.backlog == 0:
            break
        sup.tick()
    rep = sup.report()
    assert rep.backlog_left == 0 and rep.harq_open == 0
    _assert_conservation(sup)
    if rep.first_tx_bler is not None and rep.residual_bler is not None:
        assert rep.residual_bler <= rep.first_tx_bler + 1e-12


def test_nan_lane_on_second_grid_shard_is_quarantined_as_on_one_device():
    """On a (2, 1) grid of CPU entries, a NaN burst in the lane that the
    second shard holds is degraded, charged and quarantined exactly as on
    one device at the same lane buckets: the whole report, fault fields
    included, and the per-cell fault counts are equal."""
    import torch

    from repro_torch.launch.mesh import make_cell_mesh
    from repro_torch.serve.exec_registry import PowerOfTwoBuckets

    plan = [FaultEvent("nan_llr", tick=1, seq=0, cell=1),
            FaultEvent("nan_llr", tick=4, seq=0, cell=1)]
    kw = dict(fault_plan=FaultPlan(plan), quarantine_faults=1,
              quarantine_ttis=2, probation_ttis=2,
              bucket_policy=PowerOfTwoBuckets(2),
              **dict(_KW, arrival_rate=1.0, seed=17))
    corrupted = []
    reps = []
    for mesh in (make_cell_mesh(2, "cpu"),
                 make_cell_mesh(2, devices=[torch.device("cpu")] * 2)):
        sup = _uniform(Supervisor, 2, mesh=mesh, **kw)
        real = sup._corrupt

        def spy(shards, key, li, value, real=real, mesh=mesh):
            held = [sh.entry for sh in shards
                    if sh.lanes.start <= li < sh.lanes.stop]
            corrupted.append((mesh.shape, li, held))
            return real(shards, key, li, value)

        sup._corrupt = spy
        reps.append(_strip(sup.run(7)))
        _assert_conservation(sup)
    one, grid = reps
    assert (one["mesh_shape"], grid["mesh_shape"]) == ((1, 1), (2, 1))
    grid["mesh_shape"] = one["mesh_shape"]
    assert grid == one
    assert one["cells"]["cell1"]["faults"] == 2
    assert one["cell_quarantines"] == 2 and one["degraded_batches"] == 2
    # on the grid the NaN lane is lane 1, the second shard's
    assert [c for c in corrupted if c[0] == (2, 1)] == \
        [((2, 1), 1, [(1, 0)])] * 2
