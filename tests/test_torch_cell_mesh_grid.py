"""Port vs reference: multi-cell serving over a ``(cell, batch)`` grid of
several devices (``serve/cell_mesh.py`` on a ``CellMesh`` of four entries,
``ROADMAP.md`` item 7 part 3).

One reference subprocess on 4 forced XLA host devices (one thread for XLA
and for OpenMP) runs, on 64-subcarrier grids:

* the open-loop ``CellMeshEngine`` on the fleet and traffic of
  ``examples/phy_multicell_serve.py`` under ``steal`` and ``pad`` (its
  default mesh is ``(2, 2)``); it writes the slots it drew and each slot's
  metrics;
* the closed-loop ``MeshSlotScheduler`` for a few TTIs on the shrunk
  ``mcl-siso`` ladder (``tests/test_mesh_closed_loop.py``) over the grids
  ``(4, 1)``, ``(2, 2)`` and ``(1, 4)``: ``make_cell_mesh`` of 4, 2 and 1
  cells.

The port runs the same on ``make_cell_mesh(n, devices=[cpu] * 4)``, fed
the slots the reference drew (the engine's submitted slots; the
scheduler's through ``slot_factory=``, by the integer the reference turns
into its key).  Every report field must be equal (the
ACK/NACK, HARQ and OLLA trajectory, ``n_lane_steps``, ``mesh_shape``,
``n_filler_lanes``), each served slot's metrics within the one-device
tests' gates.  A second set of runs holds each grid run to the port's own
one-device run on the same slots (and the same lane buckets): every lane
step's LLRs, payload bits, CRC flags and combined LLRs bit for bit.  There
the closed loop serves the fused receiver, so the kernels' twins with one
noise value a lane run on each shard.
"""
import contextlib
import dataclasses
import functools
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.phy import scenarios as ref_scn
from repro_torch.launch.mesh import make_cell_mesh
from repro_torch.phy import ofdm, scenarios
from repro_torch.serve import CellMeshEngine, MeshSlotScheduler, cell
from repro_torch.serve import cell_mesh as port_mesh
from repro_torch.serve.exec_registry import ExecRegistry, PowerOfTwoBuckets
from test_torch_closed_loop import _JaxSlotFactory, _assert_same
from _port_share import port_share  # noqa: F401

_CPU4 = [torch.device("cpu")] * 4
LADDER = "mcl-siso"
# the example's fleet and traffic (downtown-a is the hot cell)
_FLEET = (("downtown-a", "siso-qam16-snr12"),
          ("downtown-b", "siso-qam16-snr12"),
          ("stadium-a", "mimo2x2-qam16-snr16"),
          ("stadium-b", "mimo2x2-qam16-snr16"))
_TRAFFIC = {"downtown-a": 16, "downtown-b": 4, "stadium-a": 4,
            "stadium-b": 4}
# grid -> cells: make_cell_mesh's gcd rule over 4 devices gives the grid
_GRIDS = {(4, 1): 4, (2, 2): 2, (1, 4): 1}
_MESH_KW = dict(n_users=2, arrival_rate=0.9, batch_size=4, max_retx=2,
                seed=7)
_TICKS = 3
# shared by the reference script and the port: the shrunk registries and
# the compared snapshot of a closed-loop mesh run
_COMMON = r'''
import dataclasses

SMOKE = dict(n_subcarriers=64, fft_size=64, n_taps=4, delay_spread=1.0)
RUNGS = (("siso-qpsk-r12-snr8", "mcl-qpsk-r12"),
         ("siso-qam16-r12-snr15", "mcl-qam16-r12"))
UNSTABLE = {"wall_s", "slots_per_sec", "goodput_bits_per_sec",
            "info_bits_per_sec", "compile_time_s", "executables_compiled",
            "cache_hits", "first_tick_s", "steady_tick_s"}


def shrunk(pkg, name):
    s = pkg.get_scenario(name)
    return s.replace(grid=dataclasses.replace(s.grid, **SMOKE))


def register_ladder(pkg, setitem):
    for name, new in RUNGS:
        setitem(pkg._REGISTRY, new, shrunk(pkg, name).replace(name=new))
    setitem(pkg._LADDERS, "mcl-siso", pkg.MCSLadder(
        "mcl-siso", tuple(new for _, new in RUNGS)))


def strip(d):
    return {k: (strip(v) if isinstance(v, dict) else v)
            for k, v in d.items() if k not in UNSTABLE}


def slot_key(seed, scn, batch, rv, info):
    import numpy as np
    return (int(seed), scn.name, float(scn.snr_db),
            tuple(float(x) for x in scn.interferer_db), int(batch), rv,
            None if info is None else np.asarray(info).astype(np.int64)
            .tobytes())


def mesh_snapshot(sch, rep):
    return {
        "report": strip(dataclasses.asdict(rep)),
        "ticks": [[dataclasses.asdict(t) for t in loop.tick_log]
                  for loop in sch.loops],
        "users": [[(u.user_id, u.mcs, float(u.olla), float(u.snr_db))
                   for u in loop.users] for loop in sch.loops],
        "finalized": sch.finalized_job_ids(),
        "queued": sch.queued_job_ids(),
    }
'''
exec(_COMMON)

_REF_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import pickle
import jax
import numpy as np
from repro.phy import coding
from repro.phy import scenarios as S
from repro.serve import CellMeshEngine, MeshSlotScheduler, cell
''' + _COMMON + r'''
args = pickle.loads(bytes.fromhex(sys.argv[2]))
register_ladder(S, lambda d, k, v: d.__setitem__(k, v))
assert jax.device_count() == 4
out = {"engine": {}, "mesh": {}, "slots": {}}
draw = coding.make_coded_slot


def recorded(key, scn, batch, rv=None, info=None):
    # the closed loops' slots, by the integer their PRNGKey was made of
    slot = draw(key, scn, batch, rv=rv, info=info)
    out["slots"][slot_key(int(np.asarray(key)[1]), scn, batch, rv, info)] = {
        k: np.asarray(v) for k, v in slot.items()}
    return slot


coding.make_coded_slot = recorded
for balance in ("steal", "pad"):
    eng = CellMeshEngine([cell(n, shrunk(S, s)) for n, s in args["fleet"]],
                         batch_size=4, balance=balance, prebuild=False)
    reqs = eng.submit_traffic(jax.random.PRNGKey(0), args["traffic"])
    rep = eng.run()
    out["engine"][balance] = {
        "report": strip(dataclasses.asdict(rep)),
        "slots": {n: [{k: np.asarray(v) for k, v in r.slot.items()}
                      for r in rs] for n, rs in reqs.items()},
        "metrics": {n: [r.metrics for r in rs] for n, rs in reqs.items()},
    }
for grid, n in args["grids"].items():
    sch = MeshSlotScheduler.uniform("mcl-siso", n, prebuild=False,
                                    **args["mesh_kw"])
    assert tuple(sch.mesh.devices.shape) == grid
    out["mesh"][grid] = mesh_snapshot(sch, sch.run(args["ticks"]))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


@pytest.fixture(scope="module", autouse=True)
def ladder():
    """The shrunk ladder in both packages' registries, for this module
    only (the slot factory reads the reference's)."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (scenarios, ref_scn):
            register_ladder(pkg, mp.setitem)
        yield LADDER


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    """The one reference subprocess of this file, on 4 host devices."""
    path = tmp_path_factory.mktemp("grid") / "ref.pkl"
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    args = dict(fleet=_FLEET, traffic=_TRAFFIC, grids=_GRIDS,
                mesh_kw=_MESH_KW, ticks=_TICKS)
    out = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, str(path),
         pickle.dumps(args).hex()],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


class _Slots(_JaxSlotFactory):
    """The slot the reference drew for a key (its run's record), else one
    drawn here from the same key; a copy each time."""

    def __init__(self, drawn: dict):
        super().__init__()
        self.drawn = drawn

    def __call__(self, seed, scenario, batch, *, rv=None, info=None):
        key = slot_key(seed, scenario, batch, rv, info)
        if key not in self.drawn:
            self.drawn[key] = {k: v.numpy() for k, v in super().__call__(
                seed, scenario, batch, rv=rv, info=info).items()}
        else:
            self.calls += 1
        return ofdm.slot_from_numpy(self.drawn[key], "cpu")


@contextlib.contextmanager
def _recording(keys: tuple):
    """Every grid step's ``keys`` on the host, all lanes in lane order,
    as each step is launched (one ``gather_lanes`` a key)."""
    log: list = []
    real = port_mesh._launch

    def launch(steps, shards):
        outs = real(steps, shards)
        n = max(sh.lanes.stop for sh in shards)
        log.append({k: port_mesh.gather_lanes(shards, outs, k, n).copy()
                    for k in keys if k in outs[0]})
        return outs

    port_mesh._launch = launch
    try:
        yield log
    finally:
        port_mesh._launch = real


def _assert_logs_equal(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].shape == w[k].shape, (i, k)
            assert g[k].tobytes() == w[k].tobytes(), (i, k)


# ---------------------------------------------------------------------------
# the open-loop engine on the example's fleet
# ---------------------------------------------------------------------------

_ENGINE_KEYS = ("llr", "x_hat", "h_hat", "nv_eff")


@functools.lru_cache(maxsize=None)
def _engine_run(balance: str, grid: bool, slots_blob: bytes) -> tuple:
    """The port's engine on the reference's slots: (report dict, per-slot
    metrics by cell, step log)."""
    slots = pickle.loads(slots_blob)
    mesh = (make_cell_mesh(2, devices=_CPU4) if grid
            else make_cell_mesh(2, "cpu"))
    eng = CellMeshEngine(
        [cell(n, port_shrunk(s)) for n, s in _FLEET], batch_size=4,
        balance=balance, mesh=mesh, device="cpu", registry=ExecRegistry())
    reqs = {n: [eng.submit(n, ofdm.slot_from_numpy(s, "cpu"))
                for s in slots[n]] for n in sorted(slots)}
    with _recording(_ENGINE_KEYS) as log:
        rep = eng.run()
    return (strip(dataclasses.asdict(rep)),
            {n: [r.metrics for r in rs] for n, rs in reqs.items()}, log)


def port_shrunk(name):
    return shrunk(scenarios, name)


def _assert_metrics(got: dict, want: dict, scn) -> None:
    """The one-device tests' gates: at most 2 payload-bit flips a slot,
    the other metrics at rtol 1e-3, atol 1e-4."""
    assert sorted(got) == sorted(want)
    flips = abs(got["ber"] - want["ber"]) * scn.data_bits_per_slot
    assert flips <= 2 + 1e-6, flips
    for k in want:
        if k != "ber":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("balance", ["steal", "pad"])
def test_engine_grid_matches_reference(reference, balance):
    want = reference["engine"][balance]
    rep, metrics, _ = _engine_run(balance, True,
                                  pickle.dumps(want["slots"]))
    assert rep["mesh_shape"] == want["report"]["mesh_shape"] == (2, 2)
    floats = {"ber", "che_mse", "evm", "bler", "l1_residency",
              "gops_per_watt", "energy_uj_per_slot"}
    for k, v in want["report"].items():
        if k == "cells":
            continue
        if k in floats and v is not None:
            np.testing.assert_allclose(rep[k], v, rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        else:
            _assert_same(rep[k], v, f"report.{k}")
    assert sorted(rep["cells"]) == sorted(want["report"]["cells"])
    for name, wc in want["report"]["cells"].items():
        gc = rep["cells"][name]
        for k, v in wc.items():
            if k in floats and v is not None:
                np.testing.assert_allclose(gc[k], v, rtol=1e-3, atol=1e-4,
                                           err_msg=f"{name}.{k}")
            else:
                _assert_same(gc[k], v, f"cells.{name}.{k}")
    scns = dict(_FLEET)
    for name, ms in want["metrics"].items():
        assert len(metrics[name]) == len(ms)
        for g, w in zip(metrics[name], ms):
            _assert_metrics(g, w, port_shrunk(scns[name]))


@pytest.mark.parametrize("balance", ["steal", "pad"])
def test_engine_grid_equals_one_device_run(reference, balance):
    blob = pickle.dumps(reference["engine"][balance]["slots"])
    rep, metrics, log = _engine_run(balance, True, blob)
    rep1, metrics1, log1 = _engine_run(balance, False, blob)
    assert rep1["mesh_shape"] == (1, 1)
    rep1["mesh_shape"] = rep["mesh_shape"]
    assert rep == rep1 and metrics == metrics1
    _assert_logs_equal(log, log1)


# ---------------------------------------------------------------------------
# the closed loop on three grids
# ---------------------------------------------------------------------------

_MESH_KEYS = ("llr", "info_bits_hat", "crc_ok", "cw_llr", "decode_iters")


_RUNS: dict = {}


def _mesh_run(reference, grid: tuple, on_grid: bool, fused: bool) -> tuple:
    """The port's scheduler on ``grid`` (or one device at that grid's lane
    buckets), on the reference's slots: (snapshot, step log), once."""
    key = (grid, on_grid, fused)
    if key not in _RUNS:
        _RUNS[key] = _run_mesh(reference["slots"], grid, on_grid, fused)
    return _RUNS[key]


def _run_mesh(drawn: dict, grid: tuple, on_grid: bool, fused: bool):
    n = _GRIDS[grid]
    mesh = (make_cell_mesh(n, devices=_CPU4) if on_grid
            else make_cell_mesh(n, "cpu"))
    factory = _Slots(drawn)
    sch = MeshSlotScheduler.uniform(
        LADDER, n, mesh=mesh, device="cpu", slot_factory=factory,
        registry=ExecRegistry(), bucket_policy=PowerOfTwoBuckets(grid[0]),
        options={"fused": True} if fused else None, **_MESH_KW)
    with _recording(_MESH_KEYS) as log:
        snap = mesh_snapshot(sch, sch.run(_TICKS))
    assert factory.calls == snap["report"]["n_slots"] > 0
    return snap, log


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_mesh_grid_replays_reference(reference, grid):
    want = reference["mesh"][grid]
    got, log = _mesh_run(reference, grid, True, False)
    assert got["report"]["mesh_shape"] == grid
    _assert_same(got, want, f"mesh{grid}")
    # every tick served; buckets are multiples of the cell axis
    assert got["report"]["n_steps"] >= _TICKS
    assert all(len(step["crc_ok"]) % grid[0] == 0 for step in log)


@pytest.mark.parametrize("grid", list(_GRIDS))
def test_mesh_grid_equals_one_device_run(reference, grid):
    got, log = _mesh_run(reference, grid, True, True)
    want, log1 = _mesh_run(reference, grid, False, True)
    assert want["report"]["mesh_shape"] == (1, 1)
    want["report"]["mesh_shape"] = grid
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)
    _assert_logs_equal(log, log1)
    assert any(not step["crc_ok"].all() for step in log)  # NACKs served
