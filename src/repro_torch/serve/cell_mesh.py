"""Multi-cell PHY slot serving over a ``(cell, batch)`` grid of devices
(port of :mod:`repro.serve.cell_mesh`).

The paper places TensorPool inside a densified base-station fleet: one
compute cluster multiplexes many cells' uplink traffic.  This module
scales the single-cell frontends past one cell.  Both of its frontends are
thin layers over the shared core of :mod:`repro_torch.serve.runtime`
(stacking rules, metric aggregation, report construction, the per-cell
closed-loop state machine :class:`~repro_torch.serve.runtime.CellLoop`).

Execution model
---------------
* Cells are partitioned into **shape groups** by (receiver kind, grid,
  modulation, code, builder options).  The cells of a group share one
  :class:`~repro_torch.phy.link.ReceiverPipeline` and therefore its
  captured steps: nothing else about a scenario (SNR, Doppler,
  description) changes the receive computation.
* A group step stages its slots as ``(n_lanes, batch, ...)``: one lane per
  cell (or per share of a hot cell), each lane with its own ``noise_var``.
  The reference runs ``jit(vmap(pipeline._apply))`` over that stack,
  sharded over a ``(cell, batch)`` device mesh.  The port cuts the stack
  into one shard a grid entry (the lanes over ``cell``, each lane's slots
  over ``batch``: :func:`repro_torch.distributed.sharding.
  cell_slot_placement`) and folds each shard's lanes into its kernels'
  batch axis (:func:`repro_torch.serve.exec_registry.lane_step`): the
  kernels see ``lanes * batch`` rows, the stages that read the noise
  variance read row ``b``'s lane value, and each (group, rung, lane
  bucket, grid entry) step is one CUDA graph of the registry
  (:mod:`repro_torch.serve.exec_registry`) on the entry's device, from
  the pipeline built for that device.  Every shard's replay is launched
  before any is read back, so separate cards run at once; the host then
  reads each shard once and puts the rows back in lane order.  A lane's
  numbers are those of the single-cell step on its slots.
* **Staging overlaps the device**: a step is replayed, then the host
  stacks the next step's slots (the HARQ priors, host arrays, go to the
  card from pinned memory without blocking), then the host synchronizes
  and reads the results.
* A **load-imbalance policy** keeps lanes busy: ``balance="steal"`` gives
  lanes to the cells with the longest queues each step (a hot cell may
  take several lanes); ``balance="pad"`` keeps one lane per cell and pads
  short lanes.  Stealing is lane-granular because a lane shares one
  ``noise_var``.

Two frontends share this execution model:

* :class:`CellMeshEngine`: open loop, drains pre-submitted slot queues.
* :class:`MeshSlotScheduler`: closed loop at mesh scale.  Many cells
  advance in TTI lockstep, each owning a :class:`CellLoop` (HARQ, OLLA,
  Poisson arrivals, its own ``cell_rng`` stream).  Every tick the cells'
  planned (MCS, RV) batches are bucketed per (ladder group, rung) into
  lane buckets, served by one replay each, and the CRC results fan back
  to each cell's feedback.  When a cell's pool saturates its deadline
  budget, queued users hand over to the least-loaded sibling of the same
  ladder group, and when no sibling has headroom, not-yet-started jobs
  are shed from the queue tails.

Entry points take ``device=None`` (CUDA: every visible card) to build the
default mesh, or ``mesh=`` a :class:`~repro_torch.launch.mesh.CellMesh`,
whose grid may repeat a device.  The cells' state and their slots live on
the mesh's first device (``CellMesh.home``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.distributed.sharding import cell_slot_placement
from repro_torch.launch.mesh import make_cell_mesh
from repro_torch.phy import coding
from repro_torch.phy import link as _link
from repro_torch.phy.scenarios import (
    LinkScenario, get_scenario, ladder_exec_specs,
)
from repro_torch.serve.exec_registry import (
    ExecStats, PowerOfTwoBuckets, get_registry, slot_schema, template_slot,
)
from repro_torch.serve.runtime import (
    BATCHED_KEYS, TTI_S, CellLoop, JobCounter,
    PhyServeReport, SlotLedger, SlotRequest, TickStats, build_serve_report,
    cell_rng, first_steady, make_traffic, occupancy_energy, resolve_ladder,
    validate_slots,
)

__all__ = [
    "CellMeshEngine", "CellSpec", "ClosedCellSpec", "MeshClosedLoopReport",
    "MeshServeReport", "MeshSlotScheduler", "cell", "closed_cell",
    "stage_lanes",
]


# ---------------------------------------------------------------------------
# Staging shared by both frontends
# ---------------------------------------------------------------------------

def _join(values: list, op: str):
    """Concatenate (``op="cat"``) or stack values of one key: numpy if all
    are host arrays (the HARQ priors, pinned at placement), else tensors
    on the first tensor's device."""
    if all(isinstance(v, np.ndarray) for v in values):
        return getattr(np, "concatenate" if op == "cat" else "stack")(values)
    dev = next(v.device for v in values if isinstance(v, torch.Tensor))
    ts = [torch.as_tensor(v, device=dev) for v in values]
    return torch.cat(ts) if op == "cat" else torch.stack(ts)


def stage_lanes(lanes: list, mesh, *, bucket: Optional[int] = None,
                pending: Optional[list] = None) -> list:
    """Stage one step's lanes, ``[(slots, pad), ...]``, as the mesh steps
    take them: each lane's slots (batch dim 1 each) plus ``pad`` repeats
    of its first, filler lanes replaying lane 0 up to ``bucket``, the
    batched keys ``(lanes, batch, ...)`` and each lane's side info (its
    first slot's, ``noise_var`` included) stacked by lane, then placed on
    the mesh's grid: one :class:`~repro_torch.distributed.sharding.
    LaneShard` an entry (:func:`cell_slot_placement`; ``pending`` defers
    each shard's side-info check to the caller's next synchronize)."""
    rows = [list(slots) + [slots[0]] * pad for slots, pad in lanes]
    bucket = len(rows) if bucket is None else bucket
    if bucket < len(rows):
        raise ValueError(f"{len(rows)} lanes do not fit a bucket of "
                         f"{bucket}")
    rows += [rows[0]] * (bucket - len(rows))
    if len({len(r) for r in rows}) != 1:
        raise ValueError("every lane of a step holds the same batch")
    flat = [s for row in rows for s in row]
    validate_slots(flat)
    stacked = {}
    for k, v in flat[0].items():
        if k in BATCHED_KEYS:
            joined = _join([s[k] for s in flat], "cat")
            stacked[k] = joined.reshape(bucket, -1, *joined.shape[1:])
        else:
            stacked[k] = _join([row[0][k] for row in rows], "stack")
    return cell_slot_placement(stacked, mesh, batched_keys=BATCHED_KEYS,
                               pending=pending)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _synchronize_mesh(mesh) -> None:
    for dev in mesh.distinct_devices():
        _synchronize(dev)


def _pipelines(mesh, build: Callable) -> dict:
    """``build(device)`` for each distinct device of ``mesh``: one
    pipeline a device (its constants, the Wiener operators' inputs
    included, live there)."""
    return {dev: build(dev) for dev in mesh.distinct_devices()}


def _acquire_steps(registry, pipes: dict, shards: list, mesh,
                   stats: ExecStats) -> tuple:
    """One captured step a shard: the pipeline of its device over its
    staged share, keyed by its grid entry on a mesh of several entries
    (two entries on one device get two steps, two sets of buffers)."""
    grid = mesh.size > 1
    return tuple(
        registry.acquire_pipeline_step(
            pipes[sh.device], sh.staged, batch=sh.slots.stop - sh.slots.start,
            lanes=sh.lanes.stop - sh.lanes.start, stats=stats,
            entry=sh.entry if grid else None)
        for sh in shards)


def _launch(steps: tuple, shards: list) -> list:
    """Every shard's step on its staged share, each launched before any
    output is read back (separate cards run at once): one output dict a
    shard, valid until that step's next call."""
    return [step(sh.staged) for step, sh in zip(steps, shards)]


def gather_lanes(shards: list, outs: list, read, n_lanes: int
                 ) -> np.ndarray:
    """``read(out, k)``, a ``(k, slots, ...)`` tensor of a shard's first
    ``k`` lanes (or the key ``read`` of its outputs), for the first
    ``n_lanes`` lanes of a grid step, on the host as ``(n_lanes, batch,
    ...)`` in lane order: one read a shard, and the filler lanes past
    ``n_lanes`` are never read."""
    if isinstance(read, str):
        key = read
        read = lambda out, k: out[key][:k]  # noqa: E731
    parts = []
    for sh, out in zip(shards, outs):
        k = min(sh.lanes.stop, n_lanes) - sh.lanes.start
        if k > 0:
            parts.append((sh, read(out, k).cpu().numpy()))
    if len(parts) == 1:
        return parts[0][1]
    batch = max(sh.slots.stop for sh, _ in parts)
    first = parts[0][1]
    res = np.empty((n_lanes, batch) + first.shape[2:], first.dtype)
    for sh, a in parts:
        res[sh.lanes.start:sh.lanes.start + len(a), sh.slots] = a
    return res


def _verify(pending: list) -> None:
    """Raise on a failed side-info check (read after a synchronize)."""
    checks = list(pending)
    pending.clear()
    for c in checks:
        c.verify()


# ---------------------------------------------------------------------------
# Open loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Static description of one cell: scenario + receiver + options.

    ``options`` is a sorted tuple of (key, value) pairs forwarded to
    :func:`repro_torch.phy.link.build_pipeline`, hashable so it can take
    part in the shape-group key.
    """
    name: str
    scenario: Union[str, LinkScenario]
    receiver: str = "classical"
    options: tuple = ()


def cell(name: str, scenario: Union[str, LinkScenario],
         receiver: str = "classical", **options) -> CellSpec:
    """Convenience constructor: ``cell("c0", "siso-qam16-snr12", "cevit")``.
    Builder options ride along in the shape-group key, so
    ``cell("c0", "mimo2x2-qam16-snr16", fused=True)`` serves that cell
    through the fused kernels, in a group of its own."""
    return CellSpec(name, scenario, receiver, tuple(sorted(options.items())))


@dataclasses.dataclass
class _Cell:
    spec: CellSpec
    scenario: LinkScenario
    queue: list = dataclasses.field(default_factory=list)
    served: list = dataclasses.field(default_factory=list)
    n_lane_steps: int = 0  # lanes this cell occupied across all steps


@dataclasses.dataclass
class _Lane:
    """One lane of one step: up to ``batch`` slots of a single cell."""
    cell_idx: Optional[int]  # None = filler lane (results discarded)
    reqs: list = dataclasses.field(default_factory=list)
    pad: int = 0  # slots repeated from reqs[0] to reach the static batch


class _Group:
    """Cells sharing one pipeline and its captured steps (same shapes and
    receiver): ``pipes`` holds the pipeline on each of the mesh's devices,
    ``pipeline`` the one on its first.  The steps live in the process's
    executable registry; ``_execs`` caches the acquired handles, one a
    shard, per slot schema."""

    def __init__(self, pipes: dict, cell_idxs: list):
        self.pipes = pipes
        self.pipeline = next(iter(pipes.values()))
        self.cell_idxs = cell_idxs
        self._execs: dict = {}  # slot schema -> (CapturedStep a shard)
        self.wall_s = 0.0
        self.n_steps = 0
        self.n_padded = 0
        self.n_stolen = 0


@dataclasses.dataclass
class MeshServeReport:
    """Aggregate + per-cell report of one multi-cell serving run (the
    reference's fields).

    ``tti_utilization`` is the modeled TensorPool budget of the run: each
    group step costs its pipeline's concurrent-schedule milliseconds for a
    ``batch_size`` lane, groups run back-to-back, normalized by the 1 ms
    TTI per step.  ``cells`` maps cell name to a
    :class:`~repro_torch.serve.runtime.PhyServeReport` comparable to a
    single-cell run of the same traffic.
    """
    n_cells: int
    n_groups: int
    mesh_shape: tuple
    balance: str
    batch_size: int
    n_slots: int
    n_steps: int
    wall_s: float
    slots_per_sec: float
    ber: Optional[float]
    che_mse: Optional[float]
    tti_utilization: float
    fits_tti: bool
    n_padded: int
    n_stolen: int
    cells: dict  # name -> PhyServeReport
    bler: Optional[float] = None
    info_bits_per_sec: Optional[float] = None
    gops_per_watt: Optional[float] = None
    l1_residency: Optional[float] = None
    compile_time_s: float = 0.0
    executables_compiled: int = 0
    cache_hits: int = 0
    first_tick_s: Optional[float] = None
    steady_tick_s: Optional[float] = None

    def summary(self) -> str:
        parts = [
            f"mesh[{self.mesh_shape[0]}x{self.mesh_shape[1]}] "
            f"{self.n_cells} cells/{self.n_groups} groups "
            f"({self.balance}): {self.n_slots} slots in {self.wall_s:.3f}s "
            f"({self.slots_per_sec:.1f} slots/s, batch={self.batch_size}, "
            f"{self.n_steps} steps)"
        ]
        if self.ber is not None:
            parts.append(f"BER={self.ber:.4f}")
        if self.bler is not None:
            parts.append(f"BLER={self.bler:.4f}")
        if self.info_bits_per_sec is not None:
            parts.append(
                f"goodput={self.info_bits_per_sec/1e6:.2f} Mbit/s"
            )
        if self.che_mse is not None:
            parts.append(f"CHE-MSE={self.che_mse:.4f}")
        parts.append(
            f"TTI util={self.tti_utilization:.3f} (fits={self.fits_tti})"
        )
        if self.gops_per_watt is not None:
            parts.append(f"{self.gops_per_watt:.0f} GOPS/W")
        if self.n_padded or self.n_stolen:
            parts.append(
                f"padded={self.n_padded} stolen_lanes={self.n_stolen}"
            )
        return "  ".join(parts)

    def per_cell_summary(self) -> str:
        return "\n".join(
            f"  {name:16s} {rep.summary()}"
            for name, rep in sorted(self.cells.items())
        )


class CellMeshEngine:
    """Serve N cells' slot queues through lane-folded group steps.

    Parameters
    ----------
    cells: CellSpec list (see :func:`cell`).  Cell names must be unique.
    batch_size: slots per lane per step (static; short lanes are padded).
    mesh: a :class:`~repro_torch.launch.mesh.CellMesh`; defaults to
        :func:`make_cell_mesh` over ``device``'s local devices, sized so
        every shape group divides it.
    balance: "steal" (lane-granular work stealing, default) or "pad"
        (one lane per cell, pad-only).
    prebuild: capture every group's step at construction through the
        registry; ``False`` defers each group to its first served step
        (still outside the timed window).
    registry: explicit :class:`~repro_torch.serve.exec_registry.
        ExecRegistry` (default: the process-wide one).
    device: the default mesh's device (None -> CUDA).
    """

    def __init__(self, cells: list, *, batch_size: int = 4,
                 mesh=None, balance: str = "steal",
                 prebuild: bool = True, registry=None,
                 device: DeviceLike = None):
        if balance not in ("steal", "pad"):
            raise ValueError(f"unknown balance policy {balance!r}")
        names = [c.name for c in cells]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cell names in {names}")
        self.batch_size = batch_size
        self.balance = balance
        self.cells: list = []
        for spec in cells:
            scn = (get_scenario(spec.scenario)
                   if isinstance(spec.scenario, str) else spec.scenario)
            self.cells.append(_Cell(spec=spec, scenario=scn))

        by_key: dict = {}
        for i, c in enumerate(self.cells):
            # the code is part of the receive computation (decode stage
            # structure), so coded cells only group with same-code cells
            key = (c.spec.receiver, c.scenario.grid, c.scenario.modulation,
                   c.scenario.code, c.spec.options)
            by_key.setdefault(key, []).append(i)
        if mesh is None:
            lanes = math.gcd(*(len(v) for v in by_key.values())) \
                if by_key else 1
            mesh = make_cell_mesh(lanes, device)
        self.mesh = mesh
        self.device = mesh.home
        self.groups: list = []
        for idxs in by_key.values():
            first = self.cells[idxs[0]]
            pipes = _pipelines(mesh, lambda dev: _link.build_pipeline(
                first.spec.receiver, first.scenario, device=dev,
                **dict(first.spec.options)))
            self.groups.append(_Group(pipes, idxs))
        if any(d.type == "cuda" for d in mesh.distinct_devices()):
            from repro_torch.kernels import _build

            _build.build_all()
        self._ledger = SlotLedger()
        self.registry = registry if registry is not None else get_registry()
        self.exec_stats = ExecStats()
        self.step_times: list = []
        self._pending: list = []  # side-info checks read after a sync
        if prebuild:
            for group in self.groups:
                staged = self._template_staged(group)
                _verify(self._pending)
                self._group_step(group, staged)

    def _template_staged(self, group: _Group) -> list:
        """A staged example step of ``group`` from a template slot, through
        the serving staging path, so keys, shapes and dtypes match."""
        scn = self.cells[group.cell_idxs[0]].scenario
        req = SlotRequest(user_id=-1,
                          slot=template_slot(scn, device=self.device))
        lane = _Lane(cell_idx=None, reqs=[req], pad=self.batch_size - 1)
        return self._stage([lane] * len(group.cell_idxs))

    def _group_step(self, group: _Group, shards: list) -> tuple:
        """Acquire ``group``'s steps, one a shard, for ``shards``' slot
        schema (registry hits once resident)."""
        schema = slot_schema(shards[0].staged)
        steps = group._execs.get(schema)
        if steps is None:
            steps = _acquire_steps(self.registry, group.pipes, shards,
                                   self.mesh, self.exec_stats)
            group._execs[schema] = steps
        return steps

    # -- traffic ----------------------------------------------------------
    def _cell(self, name: str) -> _Cell:
        for c in self.cells:
            if c.spec.name == name:
                return c
        raise KeyError(
            f"unknown cell {name!r}; have {[c.spec.name for c in self.cells]}"
        )

    def submit(self, cell_name: str, slot: dict,
               user_id: Optional[int] = None) -> SlotRequest:
        c = self._cell(cell_name)
        req = self._ledger.new_request(slot, user_id)
        c.queue.append(req)
        return req

    def submit_traffic(self, rng, n_slots: Union[int, dict]) -> dict:
        """Simulate per-cell arrivals on the mesh's device.

        ``rng``: an int seed (cell ``j`` of the sorted names draws from
        ``cell_rng(seed, j)``, as the reference splits one key per cell), a
        numpy Generator or a torch Generator (one stream for every cell,
        drawn in sorted-name order).  ``n_slots`` is one count for every
        cell or a ``{cell_name: count}`` dict (uneven counts exercise the
        balance policy).  Returns ``{cell_name: [SlotRequest, ...]}``.
        """
        if isinstance(n_slots, int):
            n_slots = {c.spec.name: n_slots for c in self.cells}
        out = {}
        for j, (name, n) in enumerate(sorted(n_slots.items())):
            scn = self._cell(name).scenario
            stream = (cell_rng(int(rng), j)
                      if isinstance(rng, (int, np.integer)) else rng)
            out[name] = [
                self.submit(name, slot)
                for slot in (make_traffic(scn, stream, n,
                                          device=self.device) if n else [])
            ]
        return out

    # -- scheduling -------------------------------------------------------
    def _plan(self, group: _Group) -> list:
        """Partition the group's queued slots into steps of static lanes."""
        B = self.batch_size
        queues = {i: list(self.cells[i].queue) for i in group.cell_idxs
                  if self.cells[i].queue}
        for i in group.cell_idxs:
            self.cells[i].queue = []
        n_lanes = len(group.cell_idxs)
        steps: list = []
        while queues:
            lanes: list = []
            if self.balance == "steal":
                # hottest-queue-first lane assignment: a backlogged cell
                # may occupy several lanes this step
                for lane_j in range(n_lanes):
                    if not queues:
                        lanes.append(_Lane(cell_idx=None))
                        continue
                    i = max(queues, key=lambda i: len(queues[i]))
                    take, queues[i] = queues[i][:B], queues[i][B:]
                    if not queues[i]:
                        del queues[i]
                    if group.cell_idxs[lane_j] != i:
                        group.n_stolen += 1
                    lanes.append(_Lane(cell_idx=i, reqs=take,
                                       pad=B - len(take)))
            else:  # "pad": lane j always serves cell j
                for i in group.cell_idxs:
                    q = queues.get(i, [])
                    take, rest = q[:B], q[B:]
                    if rest:
                        queues[i] = rest
                    else:
                        queues.pop(i, None)
                    if take:
                        lanes.append(_Lane(cell_idx=i, reqs=take,
                                           pad=B - len(take)))
                    else:
                        lanes.append(_Lane(cell_idx=None))
            # filler lanes replay the first real lane (results discarded)
            donor = next(l for l in lanes if l.cell_idx is not None)
            for j, l in enumerate(lanes):
                if l.cell_idx is None:
                    lanes[j] = _Lane(cell_idx=None, reqs=list(donor.reqs),
                                     pad=donor.pad)
            group.n_padded += sum(
                l.pad for l in lanes if l.cell_idx is not None
            )
            steps.append(lanes)
        return steps

    # -- staging (host side; overlapped with the device) ------------------
    def _stage(self, lanes: list) -> list:
        """One step's slots as ``(n_lanes, batch, ...)`` on the grid."""
        return stage_lanes([([r.slot for r in l.reqs], l.pad)
                            for l in lanes], self.mesh,
                           pending=self._pending)

    # -- serving ----------------------------------------------------------
    def _record(self, group: _Group, lanes: list, shards: list,
                outs: list, side_keys) -> None:
        """Per-lane, per-slot metrics of the steps' unfolded outputs (each
        shard's ``(lanes, batch, ...)`` planes read as ``lanes * batch``
        rows, its metrics read once), in lane order."""
        names: list = []

        def shard_metrics(out, k):
            flat = {key: (v[:k].flatten(0, 1) if key not in side_keys
                          and isinstance(v, torch.Tensor) else v)
                    for key, v in out.items()}
            m = _link.slot_metrics(flat, group.pipeline.scenario,
                                   per_slot=True)
            names[:] = list(m)
            return torch.stack(list(m.values()), -1).reshape(k, -1, len(m))

        table = gather_lanes(shards, outs, shard_metrics, len(lanes))
        metrics = {k: table[..., i] for i, k in enumerate(names)}
        for j, lane in enumerate(lanes):
            if lane.cell_idx is None:
                continue
            c = self.cells[lane.cell_idx]
            c.n_lane_steps += 1
            for s, req in enumerate(lane.reqs):
                req.metrics = {k: float(v[j, s]) for k, v in metrics.items()}
                req.done = True
                c.served.append(req)

    def run(self, warmup: bool = True) -> MeshServeReport:
        """Serve every queued slot; returns the mesh report.

        Each group's steps run back to back; within a group the host
        stages step *i+1* while the device runs step *i*.  The group's
        step is acquired before the timed window opens (a no-op when
        prebuilt), so the times are those of replays; ``warmup`` is kept
        for the reference's signature."""
        del warmup  # acquisition replaced warmup execution
        for group in self.groups:
            plan = self._plan(group)
            if not plan:
                continue
            staged = self._stage(plan[0])
            side = {k for k in staged[0].staged if k not in BATCHED_KEYS}
            steps = self._group_step(group, staged)
            t_group = 0.0
            for i, lanes in enumerate(plan):
                t0 = time.perf_counter()
                shards, outs = staged, _launch(steps, staged)
                staged = (self._stage(plan[i + 1])
                          if i + 1 < len(plan) else None)
                _synchronize_mesh(self.mesh)
                dt = time.perf_counter() - t0
                _verify(self._pending)
                t_group += dt
                self.step_times.append(dt)
                self._record(group, lanes, shards, outs, side)
            group.wall_s += t_group
            group.n_steps += len(plan)
        return self._report()

    # -- reporting --------------------------------------------------------
    def _cell_report(self, group: _Group, c: _Cell) -> PhyServeReport:
        # wall time is the whole group's (its cells share its steps)
        return build_serve_report(
            group.pipeline, c.scenario, [r.metrics for r in c.served],
            n_slots=len(c.served), n_batches=c.n_lane_steps,
            batch_size=self.batch_size, wall_s=group.wall_s,
        )

    def _report(self) -> MeshServeReport:
        cells = {}
        group_of = {i: g for g in self.groups for i in g.cell_idxs}
        for i, c in enumerate(self.cells):
            cells[c.spec.name] = self._cell_report(group_of[i], c)
        n_slots = sum(r.n_slots for r in cells.values())
        n_steps = sum(g.n_steps for g in self.groups)
        wall = sum(g.wall_s for g in self.groups)
        # modeled budget: group steps run back-to-back, one TTI per step
        model_ms = sum(
            g.n_steps
            * g.pipeline.tti_report(batch=self.batch_size)["concurrent_ms"]
            for g in self.groups
        )
        budget_ms = n_steps * TTI_S * 1e3
        util = model_ms / budget_ms if budget_ms else 0.0

        def slot_mean(metric):
            # slot-weighted, as PhyServeEngine aggregates
            pairs = [(getattr(r, metric), r.n_slots)
                     for r in cells.values()
                     if getattr(r, metric) is not None and r.n_slots]
            total = sum(n for _, n in pairs)
            if not total:
                return None
            return float(sum(v * n for v, n in pairs) / total)

        good_bits = 0.0
        any_coded = False
        for c in self.cells:
            rep = cells[c.spec.name]
            if rep.bler is None or c.scenario.code is None:
                continue
            any_coded = True
            good_bits += coding.goodput_bits(c.scenario, rep.bler,
                                             rep.n_slots)
        # energy-weighted efficiency = total modeled ops / total joules
        e_pairs = [
            (r.gops_per_watt, r.n_slots * r.energy_uj_per_slot)
            for r in cells.values()
            if r.gops_per_watt is not None and r.energy_uj_per_slot
            and r.n_slots
        ]
        tot_j = sum(j for _, j in e_pairs)
        gops_w = (
            sum(g * j for g, j in e_pairs) / tot_j if tot_j else None
        )
        first_s, steady_s = first_steady(self.step_times)
        return MeshServeReport(
            n_cells=len(self.cells),
            n_groups=len(self.groups),
            mesh_shape=self.mesh.shape,
            balance=self.balance,
            batch_size=self.batch_size,
            n_slots=n_slots,
            n_steps=n_steps,
            wall_s=wall,
            slots_per_sec=n_slots / max(wall, 1e-9),
            ber=slot_mean("ber"),
            che_mse=slot_mean("che_mse"),
            tti_utilization=util,
            fits_tti=bool(util <= 1.0),
            n_padded=sum(g.n_padded for g in self.groups),
            n_stolen=sum(g.n_stolen for g in self.groups),
            cells=cells,
            bler=slot_mean("bler"),
            info_bits_per_sec=(good_bits / max(wall, 1e-9)
                               if any_coded else None),
            gops_per_watt=gops_w,
            l1_residency=slot_mean("l1_residency"),
            compile_time_s=self.exec_stats.compile_time_s,
            executables_compiled=self.exec_stats.executables_compiled,
            cache_hits=self.exec_stats.cache_hits,
            first_tick_s=first_s,
            steady_tick_s=steady_s,
        )


# ---------------------------------------------------------------------------
# Closed-loop serving at mesh scale
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClosedCellSpec:
    """Static description of one closed-loop cell (the reference's).

    ``ladder`` is a registered MCS ladder (or coded scenario) name.  Cells
    sharing (ladder, receiver, options) form one ladder group: they share
    the per-rung pipelines and captured steps, and handover and shedding
    move users between them.

    ``tx_power_db`` / ``coupling_db`` model co-channel coupling between
    same-group neighbours: with ``coupling_db`` set, every other cell of
    the ladder group adds an interferer at ``neighbour.tx_power_db +
    coupling_db`` dB relative to the served signal (appended to each
    rung's own interferers at slot generation, and folded into the slot's
    ``noise_var``).  Interference never enters the group key; the default
    ``coupling_db=None`` leaves a cell uncoupled.
    """
    name: str
    ladder: str
    n_users: int = 4
    arrival_rate: float = 1.0
    snr_db: Optional[float] = None
    snr_spread_db: float = 0.0
    init_mcs: int = 0
    receiver: str = "classical"
    options: tuple = ()
    tx_power_db: float = 0.0
    coupling_db: Optional[float] = None


def closed_cell(name: str, ladder: str, receiver: str = "classical",
                *, n_users: int = 4, arrival_rate: float = 1.0,
                snr_db: Optional[float] = None, snr_spread_db: float = 0.0,
                init_mcs: int = 0, tx_power_db: float = 0.0,
                coupling_db: Optional[float] = None,
                **options) -> ClosedCellSpec:
    """Convenience constructor mirroring :func:`cell` for closed loops."""
    return ClosedCellSpec(
        name, ladder, n_users=n_users, arrival_rate=arrival_rate,
        snr_db=snr_db, snr_spread_db=snr_spread_db, init_mcs=init_mcs,
        receiver=receiver, options=tuple(sorted(options.items())),
        tx_power_db=tx_power_db, coupling_db=coupling_db,
    )


@dataclasses.dataclass
class _ClosedLane:
    """One lane of one closed-loop step: one cell's planned batch."""
    cell_idx: Optional[int]  # None = filler lane (results discarded)
    pairs: list = dataclasses.field(default_factory=list)  # (user, job)
    slots: list = dataclasses.field(default_factory=list)
    pad: int = 0


class _LadderGroup:
    """Cells sharing one MCS ladder + receiver: per-rung pipelines on each
    of the mesh's devices (``pipes``; ``pipelines`` those on its first),
    whose captured steps live in the registry, cached here per (rung,
    lane bucket, slot schema), one a shard."""

    def __init__(self, ladder_name: str, rungs, receiver: str,
                 options: dict, cell_idxs: list, mesh):
        self.ladder_name = ladder_name
        self.rungs = rungs
        self.receiver = receiver
        self.options = options
        self.cell_idxs = cell_idxs
        self.pipes = _pipelines(mesh, lambda dev: [
            _link.build_pipeline(receiver, s, device=dev, **options)
            for s in rungs])
        self.pipelines = self.pipes[mesh.home]
        # (mcs, bucket, schema) -> (CapturedStep a shard)
        self._execs: dict = {}

    def rung_pipes(self, mcs: int) -> dict:
        """Rung ``mcs``'s pipeline on each device."""
        return {dev: ps[mcs] for dev, ps in self.pipes.items()}


@dataclasses.dataclass
class MeshClosedLoopReport:
    """Aggregate + per-cell report of a mesh-scale closed-loop run (the
    reference's fields).

    ``cells`` maps cell name to a
    :class:`~repro_torch.serve.runtime.ClosedLoopReport` comparable to a
    single-cell :class:`~repro_torch.serve.runtime.SlotScheduler` run of
    the same seeded traffic (per-cell wall time is the shared mesh wall).
    The fault fields are a supervised run's and stay zero here.
    """
    n_cells: int
    n_groups: int
    mesh_shape: tuple
    batch_size: int
    n_users: int
    n_ticks: int
    max_retx: int
    n_slots: int
    n_steps: int
    n_filler_lanes: int
    wall_s: float
    slots_per_sec: float
    n_arrivals: int
    deadline_miss_rate: float
    first_tx_bler: Optional[float]
    residual_bler: Optional[float]
    mean_harq_rounds: Optional[float]
    blocks_delivered: int
    blocks_lost: int
    jobs_shed: int
    handovers: int
    goodput_bits_per_sec: float
    goodput_bits_per_tti: float
    backlog_left: int
    harq_open: int
    precision: str = "fp32"
    energy_uj_per_slot: Optional[float] = None
    gops_per_watt: Optional[float] = None
    l1_residency: Optional[float] = None
    # fault-tolerance accounting (supervised runs only)
    faults_injected: int = 0
    step_retries: int = 0
    degraded_batches: int = 0
    quarantined_batches: int = 0
    batches_deferred: int = 0
    ticks_over_budget: int = 0
    cell_quarantines: int = 0
    crashes: int = 0
    recoveries: int = 0
    jobs_failed: int = 0
    # capture accounting and first vs steady-state tick latency
    compile_time_s: float = 0.0
    executables_compiled: int = 0
    cache_hits: int = 0
    first_tick_s: Optional[float] = None
    steady_tick_s: Optional[float] = None
    cells: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        parts = [
            f"mesh-closed[{self.mesh_shape[0]}x{self.mesh_shape[1]}] "
            f"{self.n_cells} cells/{self.n_groups} groups: "
            f"{self.n_slots} slots / {self.n_ticks} TTIs in "
            f"{self.wall_s:.3f}s ({self.slots_per_sec:.1f} slots/s, "
            f"batch={self.batch_size}, {self.n_steps} steps)",
            f"miss={self.deadline_miss_rate:.3f}",
        ]
        if self.first_tx_bler is not None:
            parts.append(f"1tx-BLER={self.first_tx_bler:.4f}")
        if self.residual_bler is not None:
            parts.append(f"resid-BLER={self.residual_bler:.4f}")
        parts.append(f"goodput={self.goodput_bits_per_sec/1e6:.2f} Mbit/s")
        if self.gops_per_watt is not None:
            parts.append(
                f"{self.precision}: {self.gops_per_watt:.0f} GOPS/W"
            )
        if self.handovers or self.jobs_shed:
            parts.append(
                f"handovers={self.handovers} shed={self.jobs_shed}"
            )
        if self.faults_injected or self.crashes or self.jobs_failed:
            parts.append(
                f"faults={self.faults_injected} crashes={self.crashes} "
                f"recovered={self.recoveries} failed={self.jobs_failed}"
            )
        if self.executables_compiled or self.cache_hits:
            parts.append(
                f"compile={self.compile_time_s:.2f}s "
                f"({self.executables_compiled}x/{self.cache_hits}hit)"
            )
        return "  ".join(parts)

    def per_cell_summary(self) -> str:
        return "\n".join(
            f"  {name:16s} {rep.summary()}"
            for name, rep in sorted(self.cells.items())
        )


class MeshSlotScheduler:
    """TTI-lockstep closed-loop scheduler for many cells on one mesh.

    The mesh-scale sibling of
    :class:`repro_torch.serve.runtime.SlotScheduler`: every cell owns a
    :class:`CellLoop`, and each tick advances all of them in lockstep:

    1. **arrive**: every cell draws its Poisson arrivals from its own
       ``cell_rng(seed, i)`` stream.
    2. **rebalance**: within each ladder group, cells whose pending jobs
       exceed :meth:`CellLoop.capacity_jobs` hand whole users over to the
       least-loaded sibling with headroom; failing that, not-yet-started
       jobs are shed from queue tails (HARQ-active jobs never are).
    3. **plan**: each cell forms its (MCS, SNR) batches; the batches of a
       (ladder group, rung) become the lanes of one step, padded with
       filler lanes to the :class:`BucketPolicy`'s lane bucket
       (:class:`PowerOfTwoBuckets` by default).
    4. **serve**: each bucket is staged (:func:`stage_lanes`) and served
       by one replay of its (group, rung, bucket) step; the host stages
       bucket *k+1* while the device runs bucket *k*.
    5. **feedback**: each real lane's CRC results and combined LLRs go
       back to its cell: ACK/NACK, HARQ buffers, OLLA.  They are read
       before the next replay of the same step overwrites them; filler
       lanes never reach feedback.

    Transport-block jobs draw ids from one shared :class:`JobCounter`, so
    conservation holds mesh-wide across handover: issued ids == finalized
    ids + queued ids, exactly once each.

    Besides the reference's parameters: ``device`` (None -> CUDA, every
    visible card; the default mesh's devices: the pipelines live on each,
    the cells' slots and state on the first),
    ``slot_factory`` (handed to every :class:`CellLoop`, as
    :class:`SlotScheduler` does) and ``registry``.
    """

    def __init__(self, cells: list, *,
                 batch_size: int = 4, mesh=None, max_retx: int = 2,
                 deadline_ttis: int = 4,
                 max_batches_per_tick: Optional[int] = None,
                 adapt: bool = True, target_bler: float = 0.1,
                 olla_step: float = 0.1, seed: int = 0,
                 bucket_policy=None, registry=None,
                 prebuild: bool = True, device: DeviceLike = None,
                 slot_factory: Optional[Callable] = None):
        names = [c.name for c in cells]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cell names in {names}")
        self.batch_size = batch_size
        self.max_retx = max_retx
        self.specs = list(cells)
        self.job_counter = JobCounter()
        # loop-construction parameters, kept so a cell's loop can be
        # rebuilt from its spec (see _make_loop)
        self.seed = seed
        self.deadline_ttis = deadline_ttis
        self.max_batches_per_tick = max_batches_per_tick
        self.adapt = adapt
        self.target_bler = target_bler
        self.olla_step = olla_step
        self.slot_factory = slot_factory

        if mesh is None:
            mesh = make_cell_mesh(len(self.specs), device)
        self.mesh = mesh
        self.device = mesh.home
        by_key: dict = {}
        for i, spec in enumerate(self.specs):
            by_key.setdefault(
                (spec.ladder, spec.receiver, spec.options), []
            ).append(i)
        self.groups: list = []
        self._group_of: dict = {}
        for (ladder, receiver, options), idxs in by_key.items():
            ladder_name, rungs = resolve_ladder(ladder)
            g = _LadderGroup(ladder_name, rungs, receiver, dict(options),
                             idxs, mesh)
            self.groups.append(g)
            for i in idxs:
                self._group_of[i] = g
        if any(d.type == "cuda" for d in mesh.distinct_devices()):
            from repro_torch.kernels import _build

            _build.build_all()

        self._uid_bases: list = []
        uid_base = 0
        for spec in self.specs:
            self._uid_bases.append(uid_base)
            uid_base += spec.n_users
        self.loops: list = [
            self._make_loop(i) for i in range(len(self.specs))
        ]

        # lane buckets stay divisible by the mesh's cell axis
        self._min_lanes = int(self.mesh.shape[0])
        self.bucket_policy = (
            bucket_policy if bucket_policy is not None
            else PowerOfTwoBuckets(self._min_lanes)
        )
        max_lanes = max(len(g.cell_idxs) for g in self.groups)
        for b in self.bucket_policy.buckets(max_lanes):
            if b % self._min_lanes:
                raise ValueError(
                    f"bucket {b} of {self.bucket_policy!r} is not a "
                    f"multiple of the mesh cell axis ({self._min_lanes})"
                )
        self.registry = registry if registry is not None else get_registry()
        self.exec_stats = ExecStats()
        self.tick_times: list = []
        self.wall_s = 0.0
        self.n_steps = 0
        self.n_filler_lanes = 0
        self.n_real_lanes = 0
        self.now = 0
        self._pending: list = []  # side-info checks read after a sync
        if prebuild:
            self._prebuild()

    @classmethod
    def uniform(cls, ladder: str, n_cells: int, *, n_users: int = 4,
                arrival_rate: float = 1.0, snr_db: Optional[float] = None,
                snr_spread_db: float = 0.0, init_mcs: int = 0,
                receiver: str = "classical", hot_cells: int = 0,
                hot_factor: float = 1.0, tx_power_db: float = 0.0,
                coupling_db: Optional[float] = None,
                options: Optional[dict] = None,
                **kw) -> "MeshSlotScheduler":
        """N same-config cells; the first ``hot_cells`` get their arrival
        rate multiplied by ``hot_factor`` (load-skew sweeps).  Setting
        ``coupling_db`` couples every cell to its N-1 siblings."""
        specs = [
            closed_cell(
                f"cell{i}", ladder, receiver, n_users=n_users,
                arrival_rate=(arrival_rate * hot_factor if i < hot_cells
                              else arrival_rate),
                snr_db=snr_db, snr_spread_db=snr_spread_db,
                init_mcs=init_mcs, tx_power_db=tx_power_db,
                coupling_db=coupling_db, **(options or {}),
            )
            for i in range(n_cells)
        ]
        return cls(specs, **kw)

    def _make_loop(self, i: int) -> CellLoop:
        """Build cell ``i``'s :class:`CellLoop` from its spec (factored out
        so a supervisor can rebuild a crashed cell: same spec, same seeded
        stream)."""
        spec = self.specs[i]
        g = self._group_of[i]
        return CellLoop(
            g.rungs, name=spec.name, rng=cell_rng(self.seed, i),
            n_users=spec.n_users, batch_size=self.batch_size,
            arrival_rate=spec.arrival_rate, max_retx=self.max_retx,
            deadline_ttis=self.deadline_ttis,
            max_batches_per_tick=self.max_batches_per_tick,
            adapt=self.adapt, target_bler=self.target_bler,
            olla_step=self.olla_step, init_mcs=spec.init_mcs,
            snr_db=spec.snr_db, snr_spread_db=spec.snr_spread_db,
            interferer_db=self._coupled_interferers(i),
            uid_base=self._uid_bases[i], job_ids=self.job_counter,
            slot_factory=self.slot_factory, device=self.device,
        )

    def _coupled_interferers(self, i: int) -> tuple:
        """Cell ``i``'s co-channel interferer powers from its same-group
        neighbours: ``sibling.tx_power_db + coupling_db`` for every other
        cell of the ladder group (dB relative to the served signal);
        ``coupling_db=None`` decouples the cell."""
        spec = self.specs[i]
        if spec.coupling_db is None:
            return ()
        return tuple(
            self.specs[j].tx_power_db + spec.coupling_db
            for j in self._group_of[i].cell_idxs
            if j != i
        )

    # -- invariants (the test harness's observation surface) --------------
    @property
    def jobs_submitted(self) -> int:
        return self.job_counter.n

    def finalized_job_ids(self) -> list:
        return [j for loop in self.loops for j in loop.finalized_jobs]

    def queued_job_ids(self) -> list:
        return [
            j.job_id
            for loop in self.loops
            for u in loop.users
            for j in u.backlog
        ]

    @property
    def harq_open(self) -> int:
        return sum(loop.harq_open for loop in self.loops)

    @property
    def backlog(self) -> int:
        return sum(loop.backlog for loop in self.loops)

    def inject_backlog(self, n_per_user: int) -> None:
        for loop in self.loops:
            loop.inject_backlog(n_per_user)

    # -- rebalancing: inter-cell handover + load shedding -----------------
    def _rebalance(self) -> None:
        """Migrate users off saturated cells; shed as the last resort.

        A cell saturates when its pending jobs exceed
        :meth:`CellLoop.capacity_jobs` (never, with unlimited pools).
        Users move whole (queue, HARQ state, OLLA state) to the
        least-loaded same-group sibling, and only when the move fits the
        receiver's headroom or strictly improves the balance."""
        for g in self.groups:
            loops = [self.loops[i] for i in g.cell_idxs]
            for donor in loops:
                while donor.pending_jobs() > donor.capacity_jobs():
                    moved = False
                    recvs = [
                        l for l in loops
                        if l is not donor
                        and l.pending_jobs() < l.capacity_jobs()
                    ]
                    movable = [u for u in donor.users if u.backlog]
                    if recvs and movable and len(donor.users) > 1:
                        recv = min(recvs, key=lambda l: l.pending_jobs())
                        user = max(movable, key=lambda u: len(u.backlog))
                        headroom = (recv.capacity_jobs()
                                    - recv.pending_jobs())
                        moved_load = len(user.backlog)
                        if moved_load <= headroom or (
                            recv.pending_jobs() + moved_load
                            < donor.pending_jobs()
                        ):
                            donor.users.remove(user)
                            recv.users.append(user)
                            donor.handover_out += 1
                            recv.handover_in += 1
                            moved = True
                    if not moved:
                        overflow = int(
                            donor.pending_jobs() - donor.capacity_jobs()
                        )
                        donor.shed_tail(overflow)
                        break  # HARQ-active jobs may keep it over cap

    # -- staging ----------------------------------------------------------
    def _bucket(self, n_lanes: int) -> int:
        """The lane bucket a dynamic lane count maps onto (the
        :class:`BucketPolicy`'s)."""
        return self.bucket_policy.bucket_for(n_lanes)

    def _stage(self, lanes: list, bucket: Optional[int] = None) -> list:
        """Stage one step's lanes as ``(bucket, batch, ...)`` on the grid,
        filler lanes replaying lane 0 up to the policy's lane bucket."""
        if bucket is None:
            bucket = self._bucket(len(lanes))
        return stage_lanes([(lane.slots, lane.pad) for lane in lanes],
                           self.mesh, bucket=bucket, pending=self._pending)

    # -- the lockstep TTI loop --------------------------------------------
    #
    # tick() is decomposed into overridable hooks so a supervisor can
    # interpose fault handling without duplicating the lockstep machinery.

    def _begin_tick(self) -> None:
        """Hook before any per-tick mutation (a supervisor's crash,
        restore and quarantine lifecycle).  Base: no-op."""

    def _cell_plannable(self, ci: int) -> bool:
        """Whether cell ``ci`` may plan batches this tick (a supervisor:
        False while quarantined; arrivals still accrue).  Base: True."""
        return True

    def _plan_tick(self) -> list:
        """Plan every cell's batches, bucketed per (ladder group, rung)."""
        work: dict = {}
        for gi, g in enumerate(self.groups):
            for ci in g.cell_idxs:
                if not self._cell_plannable(ci):
                    continue
                loop = self.loops[ci]
                for mcs, pairs in loop.plan_batches():
                    slots = [
                        loop.make_slot(u, job, mcs) for u, job in pairs
                    ]
                    loop.n_batches += 1
                    work.setdefault((gi, mcs), []).append(_ClosedLane(
                        cell_idx=ci, pairs=pairs, slots=slots,
                        pad=self.batch_size - len(pairs),
                    ))
        return sorted(work.items())

    def _serve_items(self, items: list, stats: list) -> None:
        """Serve the tick's buckets; staging of bucket k+1 runs while the
        device runs bucket k (the prefetch thunk runs inside
        :meth:`_dispatch`, between the replay and the synchronize)."""
        if not items:
            return
        staged = self._stage(items[0][1])
        for i, ((gi, mcs), lanes) in enumerate(items):
            prefetch = (
                (lambda j=i + 1: self._stage(items[j][1]))
                if i + 1 < len(items) else None
            )
            staged = self._dispatch(gi, mcs, lanes, staged, stats,
                                    prefetch)

    def _dispatch(self, gi: int, mcs: int, lanes: list, staged: list,
                  stats: list, prefetch=None) -> Optional[list]:
        """Run one (group, rung) bucket step and fan feedback back out.

        The timed window holds the staging copies and every shard's
        replay, the next bucket's staging (``prefetch``) and the
        synchronize.  Returns the next bucket's staged shards, so the
        caller's double buffering survives overrides."""
        bucket = self._bucket(len(lanes))
        steps = self._step_for(gi, mcs, bucket, staged)
        t0 = time.perf_counter()
        outs = _launch(steps, staged)
        nxt = prefetch() if prefetch is not None else None
        _synchronize_mesh(self.mesh)
        self.wall_s += time.perf_counter() - t0
        _verify(self._pending)
        self.n_steps += 1
        self.n_real_lanes += len(lanes)
        self.n_filler_lanes += bucket - len(lanes)
        n = len(lanes)
        self._feedback(lanes, mcs, gather_lanes(staged, outs, "crc_ok", n),
                       gather_lanes(staged, outs, "cw_llr", n), stats)
        return nxt

    def _step_for(self, gi: int, mcs: int, bucket: int,
                  shards: list) -> tuple:
        """Acquire the (group, rung, bucket, schema) steps, one a shard,
        from the registry: resident steps are a dict lookup, new ones are
        captured here, before the timed window."""
        g = self.groups[gi]
        key = (mcs, bucket, slot_schema(shards[0].staged))
        steps = g._execs.get(key)
        if steps is None:
            steps = _acquire_steps(self.registry, g.rung_pipes(mcs), shards,
                                   self.mesh, self.exec_stats)
            g._execs[key] = steps
        return steps

    def _capture_buckets(self, g: _LadderGroup) -> tuple:
        """Every lane bucket a (group, rung) step of ``g`` can be served
        at.  A tick's lanes at one rung are at most the group's users (one
        job each per tick; handover keeps users inside their group) and,
        under a batch cap, that cap per cell.  Counts above a declared
        bucket envelope are refused at dispatch, so they end the set."""
        cap = sum(self.specs[i].n_users for i in g.cell_idxs)
        if self.max_batches_per_tick is not None:
            cap = min(cap, self.max_batches_per_tick * len(g.cell_idxs))
        out = set()
        for n in range(1, cap + 1):
            try:
                out.add(self._bucket(n))
            except ValueError:
                break
        return tuple(sorted(out))

    def _prebuild(self) -> None:
        """Capture every (group, rung, lane bucket) step the run can serve
        before the first TTI, from template slots through the serving
        staging path, so no tick captures (the reference captures the base
        bucket only and the rest at first use)."""
        for gi, g in enumerate(self.groups):
            buckets = self._capture_buckets(g)
            specs = ladder_exec_specs(
                g.ladder_name, receiver=g.receiver, options=g.options,
                batch=self.batch_size, lane_buckets=buckets, harq=True,
            )
            for i, spec in enumerate(specs):  # rung-major
                lane = _ClosedLane(
                    cell_idx=None,
                    slots=[template_slot(get_scenario(spec.scenario),
                                         harq=spec.harq, device=self.device)],
                    pad=self.batch_size - 1,
                )
                staged = self._stage([lane], bucket=spec.lanes)
                _verify(self._pending)
                self._step_for(gi, i // len(buckets), spec.lanes, staged)

    def _end_tick_hook(self, stats: list) -> None:
        """Hook after every cell's end_tick (a supervisor's periodic
        checkpointing).  Base: no-op."""

    def tick(self) -> list:
        """Advance every cell one TTI in lockstep."""
        self._begin_tick()
        stats = [TickStats(tick=loop.now) for loop in self.loops]
        for loop, st in zip(self.loops, stats):
            loop.arrive(st)
        self._rebalance()
        items = self._plan_tick()
        n0, w0 = self.n_steps, self.wall_s
        self._serve_items(items, stats)
        # first vs steady-state latency: only ticks that served a step
        if self.n_steps > n0:
            self.tick_times.append(self.wall_s - w0)
        for loop, st in zip(self.loops, stats):
            loop.end_tick(st)
        self._end_tick_hook(stats)
        self.now += 1
        return stats

    def _feedback(self, lanes: list, mcs: int, crc_ok: np.ndarray,
                  cw_llr: np.ndarray, stats: list) -> None:
        """Each real lane's CRC flags ``(L, B, C)`` and combined LLRs, read
        to the host in lane order before the step replays again, back to
        its cell."""
        for li, lane in enumerate(lanes):
            loop = self.loops[lane.cell_idx]
            for j, (u, job) in enumerate(lane.pairs):
                loop.serve_feedback(
                    u, job, mcs, crc_ok[li, j].astype(bool),
                    cw_llr[li, j : j + 1], stats[lane.cell_idx],
                )

    def run(self, n_ticks: int) -> MeshClosedLoopReport:
        for _ in range(n_ticks):
            self.tick()
        return self.report()

    # -- reporting --------------------------------------------------------
    def report(self) -> MeshClosedLoopReport:
        cells = {}
        for i, loop in enumerate(self.loops):
            g = self._group_of[i]
            cells[loop.name] = loop.report(
                ladder_name=g.ladder_name, receiver=g.receiver,
                pipelines=g.pipelines, wall_s=self.wall_s,
                n_batches=loop.n_batches,
            )
        loops = self.loops
        wall_safe = max(self.wall_s, 1e-9)
        served = sum(l._served for l in loops)
        missed = sum(l._missed for l in loops)
        ftx_blocks = sum(l._first_tx_blocks for l in loops)
        ftx_errors = sum(l._first_tx_errors for l in loops)
        delivered = sum(sum(l._delivered) for l in loops)
        lost = sum(l._lost for l in loops)
        rounds = [r for l in loops for r in l._rounds]
        good_bits = sum(l.good_bits() for l in loops)
        # occupancy-weighted energy over every (group, rung) pipeline
        occ, pipes = [], []
        for g in self.groups:
            for r in range(len(g.rungs)):
                occ.append(sum(
                    self.loops[i]._occupancy[r] for i in g.cell_idxs
                ))
                pipes.append(g.pipelines[r])
        energy, gops_w, l1_res = occupancy_energy(occ, pipes)
        first_s, steady_s = first_steady(self.tick_times)
        return MeshClosedLoopReport(
            n_cells=len(self.loops),
            n_groups=len(self.groups),
            mesh_shape=self.mesh.shape,
            batch_size=self.batch_size,
            n_users=sum(len(l.users) for l in loops),
            n_ticks=self.now,
            max_retx=self.max_retx,
            n_slots=served,
            n_steps=self.n_steps,
            n_filler_lanes=self.n_filler_lanes,
            wall_s=self.wall_s,
            slots_per_sec=served / wall_safe,
            n_arrivals=sum(l._arrivals for l in loops),
            deadline_miss_rate=missed / served if served else 0.0,
            first_tx_bler=(
                ftx_errors / ftx_blocks if ftx_blocks else None
            ),
            residual_bler=(
                lost / (lost + delivered) if lost + delivered else None
            ),
            mean_harq_rounds=(
                float(np.mean(rounds)) if rounds else None
            ),
            blocks_delivered=delivered,
            blocks_lost=lost,
            jobs_shed=sum(l.jobs_shed for l in loops),
            handovers=sum(l.handover_in for l in loops),
            goodput_bits_per_sec=good_bits / wall_safe,
            goodput_bits_per_tti=good_bits / max(self.now, 1),
            backlog_left=self.backlog,
            harq_open=self.harq_open,
            precision=self.groups[0].pipelines[0].precision,
            energy_uj_per_slot=energy,
            gops_per_watt=gops_w,
            l1_residency=l1_res,
            compile_time_s=self.exec_stats.compile_time_s,
            executables_compiled=self.exec_stats.executables_compiled,
            cache_hits=self.exec_stats.cache_hits,
            first_tick_s=first_s,
            steady_tick_s=steady_s,
            cells=cells,
        )
