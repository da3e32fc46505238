"""Supervised fault-tolerant serving: guards, retries, checkpoint/restore
(port of :mod:`repro.serve.supervisor`).

A base-station runtime serves for years unattended, so the mesh closed
loop must keep its exactness guarantees *through* faults, not just on
clean runs.  This module wraps the two execution cores with a
supervision layer driven by :mod:`repro_torch.serve.faults`:

* :class:`SupervisedBatchRunner`: the single-cell
  :class:`~repro_torch.serve.runtime.BatchRunner` with bounded
  retry-with-backoff on step exceptions and a non-finite guard on every
  batch output that reruns the batch once on the fp32 unfused reference
  pipeline (the bottom rung of the degradation ladder: quantized -> fp32
  and fused -> unfused are pipeline *build options*, so the reference is
  always constructible from the scenario alone).
* :class:`Supervisor`: a :class:`~repro_torch.serve.cell_mesh.
  MeshSlotScheduler` whose tick hooks interpose, in order:

  1. **crash recovery** (tick start): a crashed cell's ``CellLoop`` is
     rebuilt from its spec and restored from the latest checkpoint
     (HARQ combined-LLR buffers and payloads, OLLA offsets, user queues
     and the RNG stream position round-trip through
     :class:`repro_torch.checkpoint.manager.CheckpointManager`).  The
     restored state is reconciled against the rest of the mesh: jobs
     already finalized or queued elsewhere are deduplicated, and jobs
     that existed only in the lost window (arrived after the checkpoint,
     unfinalized at the crash) are *finalized as failed*, so
     ``finalized + queued + failed == submitted`` stays exact.
  2. **quarantine lifecycle**: a cell charged ``quarantine_faults``
     faults in one tick is quarantined for ``quarantine_ttis`` (arrivals
     accrue, nothing is planned), then re-admitted on probation for
     ``probation_ttis``; one fault during probation quarantines it again.
     Recovered (crashed) cells re-enter on probation too.
  3. **watchdog** (per step bucket): once a tick has run past
     ``watchdog_s`` since it began (arrivals, planning and slot
     generation included), its remaining buckets are *deferred*: their
     jobs go back to their users' queue heads untouched (HARQ
     retransmissions are never shed).  The first bucket always runs, so
     every tick makes progress.
  4. **step execution**: staged-tensor faults are injected into every
     shard that holds the lane, then the captured steps (one a grid
     entry) run under bounded retry-with-backoff (each retry
     re-stages clean inputs; transient faults do not fire again), each
     attempt closed by a device synchronize so an asynchronous failure
     surfaces in the attempt that caused it.  Retries exhausted: the
     bucket's batches are quarantined (jobs requeued, cells charged).
  5. **non-finite guard** (per lane, on each shard's device, one host
     read a shard): a lane with a non-finite combined LLR degrades the
     bucket to the fp32 unfused reference steps (one a shard) on a clean
     re-stage; lanes still non-finite after that are quarantined.
  6. **checkpoint** (tick end): every ``checkpoint_every`` ticks, every
     cell's loop state is snapshotted through the atomic checkpoint
     manager (plus one snapshot at construction, so a tick-0 crash can
     restore).  A snapshot reads every open HARQ process's payload from
     the card to the host; a restore puts it back on the loop's device,
     the mesh's first (where the cells' slots are drawn).

On the card a bucket's step is a CUDA graph whose outputs are static
tensors that its next replay overwrites: the guard, the real lanes'
``crc_ok`` and ``cw_llr`` are read to the host before the degradation
step or any later replay runs.

Every fault, retry, degradation, deferral, quarantine, crash, recovery
and failed job is accounted on the :class:`~repro_torch.serve.cell_mesh.
MeshClosedLoopReport` / :class:`~repro_torch.serve.runtime.
ClosedLoopReport` fault fields.  Under :meth:`FaultPlan.none` the
supervisor consumes no randomness and mutates nothing, so a supervised
run is field for field identical to an unsupervised run of the same seed
(wall-clock fields aside).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, host_array
from repro_torch.phy import link as _link
from repro_torch.serve.cell_mesh import (
    MeshClosedLoopReport, MeshSlotScheduler, _acquire_steps, _launch,
    _pipelines, _synchronize, _synchronize_mesh, _verify, gather_lanes,
)
from repro_torch.serve.exec_registry import slot_schema
from repro_torch.serve.faults import FaultInjector, FaultPlan, InjectedFault
from repro_torch.serve.runtime import (
    BatchRunner, CellLoop, HarqProcess, TickStats, UserState, _Job,
)

__all__ = [
    "SupervisedBatchRunner", "Supervisor",
    "snapshot_cell_loop", "restore_cell_loop",
]


# ---------------------------------------------------------------------------
# CellLoop snapshot serde (flat name -> ndarray, checkpoint-manager ready)
# ---------------------------------------------------------------------------

# int64 aggregate counters, snapshotted positionally
_SCALARS = (
    "now", "n_batches", "_arrivals", "_served", "_missed",
    "_first_tx_blocks", "_first_tx_errors", "_lost",
    "handover_in", "handover_out", "jobs_shed",
)


def snapshot_cell_loop(loop: CellLoop) -> dict:
    """Flatten one :class:`CellLoop`'s live state to name -> ndarray.

    Covers everything the closed loop's trajectory depends on: aggregate
    counters, per-rung delivery and occupancy, the finalized-job ledger,
    the tick log, the **RNG stream position** (the PCG64 state's JSON:
    its integers exceed int64, so it rides as utf-8 bytes) and every
    user's queue including in-flight HARQ processes (combined-LLR prior,
    payload bits, per-block ACK mask, RV position).  The names and
    layout are the reference's, so a snapshot of either package restores
    into the other.
    """
    flat = {
        "scalars": np.asarray(
            [int(getattr(loop, k)) for k in _SCALARS], np.int64
        ),
        "delivered": np.asarray(loop._delivered, np.int64),
        "occupancy": np.asarray(loop._occupancy, np.int64),
        "rounds": np.asarray(loop._rounds, np.int64),
        "finalized": np.asarray(loop.finalized_jobs, np.int64),
        "ticklog": np.asarray(
            [[s.tick, s.n_arrivals, s.n_served, s.n_miss, s.backlog_after]
             for s in loop.tick_log], np.int64
        ).reshape(-1, 5),
        "rng": np.frombuffer(
            json.dumps(loop.rng.bit_generator.state).encode(), np.uint8
        ).copy(),
        "n_users": np.asarray([len(loop.users)], np.int64),
    }
    for i, u in enumerate(loop.users):
        p = f"u{i:03d}"
        flat[f"{p}/ids"] = np.asarray([u.user_id, u.mcs], np.int64)
        flat[f"{p}/fs"] = np.asarray([u.snr_db, u.olla], np.float64)
        flat[f"{p}/jobs"] = np.asarray(
            [[j.enq_tick, j.job_id, int(j.harq is not None)]
             for j in u.backlog], np.int64
        ).reshape(-1, 3)
        for jx, j in enumerate(u.backlog):
            if j.harq is None:
                continue
            h, q = j.harq, f"{p}/j{jx:03d}"
            flat[f"{q}/hmeta"] = np.asarray(
                [h.mcs, h.n_tx, h.rv], np.int64
            )
            # the slot builder's tensor, on the card in serving
            flat[f"{q}/hinfo"] = host_array(h.info)
            flat[f"{q}/hprior"] = np.asarray(h.prior, np.float32)
            flat[f"{q}/hacked"] = np.asarray(h.acked, bool)
    return flat


def restore_cell_loop(loop: CellLoop, flat: dict) -> None:
    """Overwrite ``loop``'s live state from a :func:`snapshot_cell_loop`
    dict.  ``loop`` should be freshly built from the same spec
    (:meth:`MeshSlotScheduler._make_loop`); users are rebuilt outright,
    since handover may have changed their number since construction.  A
    HARQ payload comes back as the slot builder makes it: a tensor of the
    snapshot's dtype on ``loop.device``, so a retransmission re-encodes
    the same bits."""
    for k, v in zip(_SCALARS, flat["scalars"]):
        setattr(loop, k, int(v))
    loop._delivered = [int(x) for x in flat["delivered"]]
    loop._occupancy = [int(x) for x in flat["occupancy"]]
    loop._rounds = [int(x) for x in flat["rounds"]]
    loop.finalized_jobs = [int(x) for x in flat["finalized"]]
    loop.tick_log = [
        TickStats(tick=int(r[0]), n_arrivals=int(r[1]), n_served=int(r[2]),
                  n_miss=int(r[3]), backlog_after=int(r[4]))
        for r in flat["ticklog"]
    ]
    loop.rng.bit_generator.state = json.loads(
        bytes(bytearray(flat["rng"])).decode()
    )
    users = []
    for i in range(int(flat["n_users"][0])):
        p = f"u{i:03d}"
        ids, fs = flat[f"{p}/ids"], flat[f"{p}/fs"]
        u = UserState(user_id=int(ids[0]), snr_db=float(fs[0]),
                      mcs=int(ids[1]), olla=float(fs[1]))
        for jx, row in enumerate(flat[f"{p}/jobs"]):
            job = _Job(enq_tick=int(row[0]), job_id=int(row[1]))
            if int(row[2]):
                q = f"{p}/j{jx:03d}"
                hm = flat[f"{q}/hmeta"]
                info = np.ascontiguousarray(flat[f"{q}/hinfo"])
                job.harq = HarqProcess(
                    mcs=int(hm[0]),
                    info=torch.from_numpy(info).to(loop.device),
                    prior=np.asarray(flat[f"{q}/hprior"], np.float32),
                    acked=np.asarray(flat[f"{q}/hacked"], bool),
                    n_tx=int(hm[1]), rv=int(hm[2]),
                )
            u.backlog.append(job)
        users.append(u)
    loop.users = users


# ---------------------------------------------------------------------------
# Single-cell supervision: the guarded BatchRunner
# ---------------------------------------------------------------------------

class SupervisedBatchRunner(BatchRunner):
    """:class:`BatchRunner` with the supervisor's per-batch guards.

    * step exceptions (:class:`InjectedFault`): up to ``max_retries``
      retries with exponential backoff (``backoff_s * 2**attempt``);
      exhausted retries re-raise.
    * non-finite outputs: any non-finite value under the guarded keys
      (tested on the device, one host read) degrades the batch once to
      the fp32 unfused reference pipeline of the same scenario (built
      lazily on the primary pipeline's device, no fused kernels, no
      quantized precision; its step acquired from the registry outside
      the timed window); counted in :attr:`degraded_batches`.
    """

    GUARD_KEYS = ("cw_llr", "llr", "x_hat")

    def __init__(self, pipeline: _link.ReceiverPipeline, batch_size: int,
                 *, receiver: str = "classical", max_retries: int = 2,
                 backoff_s: float = 0.0, registry=None):
        super().__init__(pipeline, batch_size, registry=registry)
        self.receiver = receiver
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.retries = 0
        self.degraded_batches = 0
        self._ref: Optional[_link.ReceiverPipeline] = None
        self._ref_execs: dict = {}  # slot schema -> reference step

    def _guard_ok(self, state: dict) -> bool:
        flags = [torch.isfinite(state[k]).all() for k in self.GUARD_KEYS
                 if isinstance(state.get(k), torch.Tensor)]
        return not flags or bool(torch.stack(flags).all())

    def _reference(self) -> _link.ReceiverPipeline:
        if self._ref is None:
            self._ref = _link.build_pipeline(
                self.receiver, self.pipeline.scenario,
                device=self.pipeline.device,
            )
        return self._ref

    def _ref_exec(self, batch: dict):
        """The fp32 unfused reference step, acquired from the same
        registry as the primary step (captured here, untimed)."""
        schema = slot_schema(batch)
        step = self._ref_execs.get(schema)
        if step is None:
            step = self.registry.acquire_pipeline_step(
                self._reference(), batch, batch=self.batch_size,
                stats=self.exec_stats,
            )
            self._ref_execs[schema] = step
        return step

    def _execute(self, batch: dict) -> dict:
        state = None
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                state = self._step(batch)
                _synchronize(self.pipeline.device)
                dt = time.perf_counter() - t0
                self.wall_s += dt
                self.batch_times.append(dt)
                break
            except InjectedFault:
                self.wall_s += time.perf_counter() - t0
                if attempt >= self.max_retries:
                    raise
                self.retries += 1
                if self.backoff_s:
                    time.sleep(self.backoff_s * 2 ** attempt)
        if not self._guard_ok(state):
            self.degraded_batches += 1
            ref = self._ref_exec(batch)
            t0 = time.perf_counter()
            state = ref(batch)
            _synchronize(self.pipeline.device)
            self.wall_s += time.perf_counter() - t0
        return state


# ---------------------------------------------------------------------------
# Mesh supervision
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CellHealth:
    """Quarantine lifecycle of one cell:
    healthy -> quarantined -> probation -> healthy."""
    state: str = "healthy"
    until: int = 0  # tick the current non-healthy state expires at
    faults_tick: int = 0  # faults charged in the current tick


class Supervisor(MeshSlotScheduler):
    """Fault-tolerant :class:`MeshSlotScheduler` (see the module doc).

    Extra parameters on top of the base scheduler (the reference's, with
    its defaults):

    fault_plan: the :class:`FaultPlan` to inject (default: none).
    max_step_retries / retry_backoff_s: bounded retry on step exceptions.
    watchdog_s: per-TTI budget from the tick's start; ``None`` disables
        deferral.
    quarantine_faults: faults in one tick that quarantine a cell.
    quarantine_ttis / probation_ttis: lifecycle durations.
    checkpoint_every: ticks between state snapshots (1 = every tick, the
        lossless setting: a crash restores the exact pre-tick state).
    checkpoint_dir: snapshot directory (default: a private temp dir).
    keep_checkpoints: snapshots kept on disk.
    """

    def __init__(self, cells, *, fault_plan: Optional[FaultPlan] = None,
                 max_step_retries: int = 2, retry_backoff_s: float = 0.0,
                 watchdog_s: Optional[float] = None,
                 quarantine_faults: int = 2, quarantine_ttis: int = 2,
                 probation_ttis: int = 2, checkpoint_every: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 keep_checkpoints: int = 3, **kw):
        super().__init__(cells, **kw)
        self.injector = FaultInjector(fault_plan or FaultPlan.none())
        self.max_step_retries = max_step_retries
        self.retry_backoff_s = retry_backoff_s
        self.watchdog_s = watchdog_s
        self.quarantine_faults = quarantine_faults
        self.quarantine_ttis = quarantine_ttis
        self.probation_ttis = probation_ttis
        self.checkpoint_every = max(int(checkpoint_every), 1)

        n = len(self.specs)
        self._health = [_CellHealth() for _ in range(n)]
        self.failed_jobs: list = []
        self.step_retries = 0
        self.degraded_batches = 0
        self.quarantined_batches = 0
        self.batches_deferred = 0
        self.ticks_over_budget = 0
        self.cell_quarantines = 0
        self.crashes = 0
        self.recoveries = 0
        self._cell_faults = [0] * n
        self._cell_degraded = [0] * n
        self._cell_quarantined = [0] * n
        self._cell_qticks = [0] * n
        self._cell_crashes = [0] * n
        self._cell_failed = [0] * n

        self._tick_t0 = 0.0
        self._tick_deferred = False
        self._seq = 0
        # fp32 unfused reference pipelines (lazy per (group, rung), one a
        # device); their captured steps live in the registry, cached per
        # (gi, mcs, bucket), one a shard
        self._ref_pipes: dict = {}
        self._ref_execs: dict = {}

        if checkpoint_dir is None:
            self._ckpt_tmp = tempfile.TemporaryDirectory(
                prefix="supervisor_ckpt_"
            )
            checkpoint_dir = self._ckpt_tmp.name
        # synchronous saves: a crash event must always find a complete
        # snapshot on disk (atomicity comes from the manager's rename)
        self._ckpt = CheckpointManager(
            checkpoint_dir, keep=keep_checkpoints, async_save=False
        )
        self._save_checkpoint(0)

    # -- conservation surface ---------------------------------------------
    def failed_job_ids(self) -> list:
        """Jobs explicitly finalized as failed by crash recovery: the
        third leg of ``finalized + queued + failed == submitted``."""
        return list(self.failed_jobs)

    # -- checkpointing ----------------------------------------------------
    def _save_checkpoint(self, step: int) -> None:
        self._ckpt.save(
            step, {loop.name: snapshot_cell_loop(loop)
                   for loop in self.loops}
        )

    def _end_tick_hook(self, stats) -> None:
        if (self.now + 1) % self.checkpoint_every == 0:
            # state after finishing tick `now` == state entering tick
            # `now + 1`: a crash at tick t restores losslessly from step t
            self._save_checkpoint(self.now + 1)

    # -- crash recovery ---------------------------------------------------
    def _crash_cell(self, ci: int) -> None:
        """Drop cell ``ci``'s in-flight state; restore it from the latest
        checkpoint and reconcile job accounting against the mesh."""
        dead = self.loops[ci]
        self.crashes += 1
        self._cell_crashes[ci] += 1
        pre_queued = {j.job_id for u in dead.users for j in u.backlog}
        pre_finalized = list(dead.finalized_jobs)

        loop = self._make_loop(ci)
        step = self._ckpt.latest_step()
        prefix = dead.name + "/"
        flat = {
            k[len(prefix):]: v
            for k, v in self._ckpt.load_flat(step).items()
            if k.startswith(prefix)
        }
        restore_cell_loop(loop, flat)
        # delivery records are durable (the ACKs went out): keep ids
        # finalized after the checkpoint so they are never served again
        seen = set(loop.finalized_jobs)
        loop.finalized_jobs.extend(
            j for j in pre_finalized if j not in seen
        )
        self.loops[ci] = loop

        # reconcile the restored snapshot against the live mesh: G is
        # every job id accounted somewhere else (or already finalized)
        others_users = {
            u.user_id for j2, other in enumerate(self.loops) if j2 != ci
            for u in other.users
        }
        G = set(self.failed_jobs)
        G.update(j for other in self.loops for j in other.finalized_jobs)
        G.update(
            j.job_id for j2, other in enumerate(self.loops) if j2 != ci
            for u in other.users for j in u.backlog
        )
        snapshot_queued = {
            j.job_id for u in loop.users for j in u.backlog
        }
        # users handed over since the snapshot live elsewhere now
        loop.users = [
            u for u in loop.users if u.user_id not in others_users
        ]
        for u in loop.users:
            u.backlog = collections.deque(
                j for j in u.backlog if j.job_id not in G
            )
        restored = {j.job_id for u in loop.users for j in u.backlog}
        # anything that existed only in the lost window is finalized as
        # failed, never silently dropped
        failed = sorted((pre_queued | snapshot_queued) - (restored | G))
        self.failed_jobs.extend(failed)
        self._cell_failed[ci] += len(failed)
        self.recoveries += 1
        h = self._health[ci]
        h.state, h.until = "probation", self.now + self.probation_ttis

    # -- tick hooks --------------------------------------------------------
    def _begin_tick(self) -> None:
        self._tick_t0 = time.perf_counter()
        self._tick_deferred = False
        self._seq = 0
        for ci, h in enumerate(self._health):
            h.faults_tick = 0
            if h.state == "quarantined" and self.now >= h.until:
                h.state = "probation"
                h.until = self.now + self.probation_ttis
            elif h.state == "probation" and self.now >= h.until:
                h.state = "healthy"
            if h.state == "quarantined":
                self._cell_qticks[ci] += 1
        for ci in self.injector.crashes(self.now):
            if 0 <= ci < len(self.loops):
                self._crash_cell(ci)

    def _cell_plannable(self, ci: int) -> bool:
        return self._health[ci].state != "quarantined"

    def _charge_fault(self, ci: int) -> None:
        self._cell_faults[ci] += 1
        h = self._health[ci]
        h.faults_tick += 1
        if (h.state == "probation"
                or h.faults_tick >= self.quarantine_faults):
            if h.state != "quarantined":
                self.cell_quarantines += 1
            h.state = "quarantined"
            h.until = self.now + 1 + self.quarantine_ttis
            h.faults_tick = 0

    def _requeue(self, lanes) -> None:
        """Give a bucket's jobs back to their users' queue heads: no
        feedback, no HARQ mutation; they retry on a later tick.  (One job
        per user per tick, so head order is preserved.)"""
        for lane in lanes:
            for u, job in lane.pairs:
                u.backlog.appendleft(job)

    # -- degradation ladder ------------------------------------------------
    def _ref_step(self, gi: int, mcs: int, bucket: int,
                  shards: list) -> tuple:
        """The fp32 unfused reference step for (group, rung): the same
        receiver kind with no build options (no fused kernels, no
        quantized precision), acquired from the registry at first use,
        outside the timed window like every other step.  Its key takes the
        registry's rule (the reference's names no donation): the port
        donates no buffers, so an unfused fp32 group's lane step and its
        degradation step are one graph, which is safe because
        :meth:`_dispatch` reads the primary's outputs to the host before
        the degradation replay.  One step a shard, as the primary's."""
        key = (gi, mcs, bucket)
        steps = self._ref_execs.get(key)
        if steps is None:
            pkey = (gi, mcs)
            if pkey not in self._ref_pipes:
                g = self.groups[gi]
                self._ref_pipes[pkey] = _pipelines(
                    self.mesh, lambda dev: _link.build_pipeline(
                        g.receiver, g.rungs[mcs], device=dev))
            steps = _acquire_steps(self.registry, self._ref_pipes[pkey],
                                   shards, self.mesh, self.exec_stats)
            self._ref_execs[key] = steps
        return steps

    # -- staged-tensor fault injection ------------------------------------
    @staticmethod
    def _corrupt(shards: list, key: str, li: int, value: float) -> list:
        """A copy of ``shards`` whose ``key`` has lane ``li`` overwritten in
        every shard that holds (part of) it (a clone: the staged tensor is
        not the step's input, the step copies it in).  Lanes are the
        leading axis of a shard on its device, so no re-placement is
        needed."""
        out = []
        for sh in shards:
            if sh.lanes.start <= li < sh.lanes.stop:
                staged = dict(sh.staged)
                corrupted = staged[key].clone()
                corrupted[li - sh.lanes.start] = value
                staged[key] = corrupted
                sh = dataclasses.replace(sh, staged=staged)
            out.append(sh)
        return out

    def _inject_stage(self, staged: list, lanes, seq: int) -> list:
        for ev in self.injector.stage_events(self.now, seq):
            li = next(
                (i for i, lane in enumerate(lanes)
                 if lane.cell_idx == ev.cell), 0,
            )
            if ev.kind == "nan_llr" and "prior_llr" in staged[0].staged:
                staged = self._corrupt(staged, "prior_llr", li,
                                       float("nan"))
            elif ev.kind == "corrupt_slot":
                key = next(
                    (k for k in ("y_time", "y") if k in staged[0].staged),
                    None
                )
                if key is not None:
                    staged = self._corrupt(staged, key, li, float("inf"))
        return staged

    # -- the supervised bucket step ---------------------------------------
    def _dispatch(self, gi, mcs, lanes, staged, stats,
                  prefetch=None) -> Optional[dict]:
        seq = self._seq
        self._seq += 1

        # watchdog: over-budget ticks defer their remaining buckets (the
        # first bucket always runs, so every tick makes progress)
        if (self.watchdog_s is not None and seq > 0
                and time.perf_counter() - self._tick_t0 > self.watchdog_s):
            if not self._tick_deferred:
                self._tick_deferred = True
                self.ticks_over_budget += 1
            self.batches_deferred += len(lanes)
            self._requeue(lanes)
            nxt = prefetch() if prefetch is not None else None
            _verify(self._pending)
            return nxt

        bucket = self._bucket(len(lanes))
        steps = self._step_for(gi, mcs, bucket, staged)

        staged = self._inject_stage(staged, lanes, seq)
        straggle = self.injector.straggle_s(self.now, seq)

        nxt, prefetched = None, False
        outs = None
        for attempt in range(self.max_step_retries + 1):
            ev = self.injector.step_error(self.now, seq)
            t0 = time.perf_counter()
            try:
                if ev is not None:
                    raise InjectedFault(
                        f"injected step error at tick {self.now} "
                        f"bucket {seq} (attempt {attempt})"
                    )
                # every shard's replay, queued on its device
                launched = _launch(steps, staged)
                if not prefetched:
                    nxt = prefetch() if prefetch is not None else None
                    prefetched = True
                if straggle > 0.0:
                    time.sleep(straggle)
                    straggle = 0.0
                _synchronize_mesh(self.mesh)
                outs = launched
                self.wall_s += time.perf_counter() - t0
                break
            except Exception:
                self.wall_s += time.perf_counter() - t0
                if attempt >= self.max_step_retries:
                    break  # retries exhausted: quarantine the bucket
                self.step_retries += 1
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * 2 ** attempt)
                staged = self._stage(lanes)  # clean re-stage
        if not prefetched:
            nxt = prefetch() if prefetch is not None else None
        # a staging or side-info error is a bug, never a step fault
        _verify(self._pending)

        if outs is None:
            self.quarantined_batches += len(lanes)
            for lane in lanes:
                self._cell_quarantined[lane.cell_idx] += 1
                self._charge_fault(lane.cell_idx)
            self._requeue(lanes)
            return nxt

        self.n_steps += 1
        self.n_real_lanes += len(lanes)
        self.n_filler_lanes += bucket - len(lanes)

        # the real lanes' results and their guard (one read a shard each),
        # read before any other replay can overwrite the steps' outputs
        n = len(lanes)
        finite = self._finite_lanes(staged, outs, n)
        crc = gather_lanes(staged, outs, "crc_ok", n).copy()
        llr = gather_lanes(staged, outs, "cw_llr", n).copy()
        bad = [li for li in range(n) if not finite[li]]
        still_bad: set = set()
        if bad:
            # degradation ladder: rerun the bucket once on the fp32
            # unfused reference step over a clean re-stage
            self.degraded_batches += len(bad)
            for li in bad:
                self._cell_degraded[lanes[li].cell_idx] += 1
                self._charge_fault(lanes[li].cell_idx)
            clean = self._stage(lanes)
            ref = self._ref_step(gi, mcs, bucket, clean)
            t0 = time.perf_counter()
            routs = _launch(ref, clean)
            _synchronize_mesh(self.mesh)
            self.wall_s += time.perf_counter() - t0
            _verify(self._pending)
            rfinite = self._finite_lanes(clean, routs, n)
            rcrc = gather_lanes(clean, routs, "crc_ok", n)
            rllr = gather_lanes(clean, routs, "cw_llr", n)
            for li in bad:
                if rfinite[li]:
                    crc[li], llr[li] = rcrc[li], rllr[li]
                else:
                    still_bad.add(li)
            if still_bad:
                self.quarantined_batches += len(still_bad)
                for li in sorted(still_bad):
                    self._cell_quarantined[lanes[li].cell_idx] += 1
                    self._requeue([lanes[li]])

        for li, lane in enumerate(lanes):
            if li in still_bad:
                continue
            self._feedback([lane], mcs, crc[li:li + 1], llr[li:li + 1],
                           stats)
        return nxt

    @staticmethod
    def _finite_lanes(shards: list, outs: list, n: int) -> np.ndarray:
        """Whether each of the first ``n`` lanes' combined LLRs are finite
        (tested on each shard's device, one read a shard)."""
        return gather_lanes(
            shards, outs,
            lambda out, k: torch.isfinite(out["cw_llr"][:k]).flatten(2)
            .all(2), n).all(1)

    # -- reporting ---------------------------------------------------------
    def report(self) -> MeshClosedLoopReport:
        rep = super().report()
        cells = dict(rep.cells)
        for i, loop in enumerate(self.loops):
            cells[loop.name] = dataclasses.replace(
                cells[loop.name],
                faults=self._cell_faults[i],
                degraded_batches=self._cell_degraded[i],
                quarantined_batches=self._cell_quarantined[i],
                quarantine_ticks=self._cell_qticks[i],
                crashes=self._cell_crashes[i],
                jobs_failed=self._cell_failed[i],
            )
        return dataclasses.replace(
            rep,
            faults_injected=self.injector.total,
            step_retries=self.step_retries,
            degraded_batches=self.degraded_batches,
            quarantined_batches=self.quarantined_batches,
            batches_deferred=self.batches_deferred,
            ticks_over_budget=self.ticks_over_budget,
            cell_quarantines=self.cell_quarantines,
            crashes=self.crashes,
            recoveries=self.recoveries,
            jobs_failed=len(self.failed_jobs),
            cells=cells,
        )
