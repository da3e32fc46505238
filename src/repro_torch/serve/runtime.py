"""Closed-loop TTI serving runtime and the shared slot-scheduler core
(port of :mod:`repro.serve.runtime`).

* **Shared core**: :class:`SlotRequest` / :class:`PhyServeReport`, submit
  bookkeeping (:class:`SlotLedger`), batch stacking (:func:`stack_slots`),
  traffic (:func:`make_traffic` over :func:`cell_rng`), metric aggregation
  and report construction, and the timed batch executor
  (:class:`BatchRunner`), which serves each slot schema through one step
  of the executable registry (:mod:`repro_torch.serve.exec_registry`): a
  CUDA graph of the receive chain on the card.  Its timed window holds the
  copies that stage a batch into the step's inputs, the replay and
  ``torch.cuda.synchronize()``.
* **Closed loop**: the per-cell state machine :class:`CellLoop` (numpy
  logic: Poisson arrivals, per-user queues, HARQ IR combining, OLLA over
  an MCS ladder) driven by :class:`SlotScheduler` through per-rung
  pipelines.

Slot construction is injectable (``slot_factory=``): a factory is called
as ``factory(seed, scenario, batch, rv=..., info=...)`` with the integer
the cell's numpy stream draws for the slot (the integer the reference
turns into ``jax.random.PRNGKey``).  The default
(:class:`TorchSlotFactory`) seeds a :class:`torch.Generator` with it; a
parity run passes a factory that draws the reference's slot from the same
integer, so both packages replay one trajectory.

Steps are acquired ahead of the first TTI (``SlotScheduler(prebuild=
True)``, ``PhyServeEngine.run(warmup=True)``) from template batches; the
reports' compile fields (``compile_time_s``, ``executables_compiled``,
``cache_hits``) are the runners' merged :class:`ExecStats`.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.phy import coding
from repro_torch.phy import link as _link
from repro_torch.serve.exec_registry import (
    ExecStats, get_registry, slot_schema, template_batch,
)

# slot keys with a leading per-user batch axis; everything else is
# scenario-static side info shared by every user
BATCHED_KEYS = ("y_time", "y", "x", "h", "bits", "info_bits", "rv",
                "prior_llr")

# the slot-mean metrics every serving report aggregates
METRIC_KEYS = ("ber", "che_mse", "bler", "decode_iters")

TTI_S = 1e-3  # the paper's slot deadline


@dataclasses.dataclass
class SlotRequest:
    """One user's uplink slot awaiting processing."""
    user_id: int
    slot: dict  # link-slot dict with batch dim 1 on BATCHED_KEYS
    metrics: Optional[dict] = None
    done: bool = False


@dataclasses.dataclass
class PhyServeReport:
    pipeline: str
    scenario: str
    n_slots: int
    n_batches: int
    batch_size: int
    wall_s: float
    slots_per_sec: float
    ber: Optional[float]
    che_mse: Optional[float]
    tti: dict  # pipeline.tti_report(batch=batch_size); may be empty
    stage_cycles: dict  # per-stage BlockCycles; may be empty
    bler: Optional[float] = None
    info_bits_per_sec: Optional[float] = None
    decode_iters: Optional[float] = None
    precision: str = "fp32"
    energy_uj_per_slot: Optional[float] = None
    gops_per_watt: Optional[float] = None
    l1_residency: Optional[float] = None
    compile_time_s: float = 0.0
    executables_compiled: int = 0
    cache_hits: int = 0
    first_tick_s: Optional[float] = None
    steady_tick_s: Optional[float] = None

    def summary(self) -> str:
        parts = [
            f"{self.pipeline}: {self.n_slots} slots in {self.wall_s:.3f}s "
            f"({self.slots_per_sec:.1f} slots/s, batch={self.batch_size})"
        ]
        if self.ber is not None:
            parts.append(f"BER={self.ber:.4f}")
        if self.bler is not None:
            parts.append(f"BLER={self.bler:.4f}")
        if self.info_bits_per_sec is not None:
            parts.append(
                f"goodput={self.info_bits_per_sec/1e6:.2f} Mbit/s"
            )
        if self.decode_iters is not None:
            parts.append(f"dec-iters={self.decode_iters:.1f}")
        if self.che_mse is not None:
            parts.append(f"CHE-MSE={self.che_mse:.4f}")
        util = self.tti.get("tti_utilization") if self.tti else None
        if util is not None:
            parts.append(
                f"TTI util={util:.3f} (fits={self.tti.get('fits_tti')})"
            )
        if self.gops_per_watt is not None:
            parts.append(
                f"{self.precision}: {self.gops_per_watt:.0f} GOPS/W "
                f"(L1 res={self.l1_residency:.2f})"
            )
        return "  ".join(parts)


class SlotLedger:
    """Monotone user-id allocation + request construction."""

    def __init__(self):
        self._next_uid = 0

    def new_request(self, slot: dict,
                    user_id: Optional[int] = None) -> SlotRequest:
        if user_id is None:
            user_id = self._next_uid
        self._next_uid = max(self._next_uid, user_id) + 1
        return SlotRequest(user_id=user_id, slot=slot)


def validate_slots(slots: list, keys=BATCHED_KEYS) -> None:
    """Check a batch's slots agree on keys, trailing shapes and dtypes,
    naming the offending slot and key."""
    head = slots[0]
    for i, s in enumerate(slots[1:], 1):
        extra, missing = set(s) - set(head), set(head) - set(s)
        if extra or missing:
            raise ValueError(
                f"slot {i} keys differ from slot 0: "
                f"missing {sorted(missing)}, unexpected {sorted(extra)} "
                "— all slots in a batch must come from the same scenario/"
                "slot builder"
            )
        for k in keys:
            if k not in head:
                continue
            a, b = tuple(np.shape(head[k])), tuple(np.shape(s[k]))
            if a[1:] != b[1:]:
                raise ValueError(
                    f"slot {i} key {k!r}: shape {b} != {a} of slot 0 "
                    "(trailing dims are scenario-static and must match; "
                    "check grid/code/MCS consistency of the batch)"
                )
            da = getattr(head[k], "dtype", None)
            db = getattr(s[k], "dtype", None)
            if da != db:
                raise ValueError(
                    f"slot {i} key {k!r}: dtype {db} != {da} of slot 0"
                )


def stack_slots(slots: list, pad: int = 0, keys=BATCHED_KEYS) -> dict:
    """Stack per-user slots (batch dim 1 each) into one batched slot on
    the device of ``slots[0]["y"]``; ``pad`` repeats ``slots[0]`` to reach
    a fixed batch size.  Host arrays (HARQ priors) move to that device."""
    validate_slots(slots, keys)
    slots = list(slots) + [slots[0]] * pad
    batch = dict(slots[0])
    dev = batch["y"].device
    for k in keys:
        if k in batch:
            batch[k] = torch.cat(
                [torch.as_tensor(s[k], device=dev) for s in slots], dim=0
            )
    return batch


def cell_rng(seed: int, cell: int = 0) -> np.random.Generator:
    """One deterministic numpy Generator per (seed, cell index): the single
    stream behind arrivals, SNR spread and slot seeds."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), int(cell)])
    )


def slot_seed(rng: np.random.Generator) -> int:
    """Draw the next slot seed from a cell stream: the integer the
    reference draws for ``jax.random.PRNGKey``."""
    return int(rng.integers(0, 2**31 - 1))


class TorchSlotFactory:
    """The default slot builder: the scenario's coded slot drawn from a
    :class:`torch.Generator` seeded with the cell stream's integer."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def __call__(self, seed: int, scenario, batch: int, *, rv=None,
                 info=None) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return coding.make_coded_slot(gen, scenario, batch, rv=rv,
                                      info=info)


def make_traffic(scenario, rng, n: int, device: DeviceLike = None) -> list:
    """Simulate ``n`` independent single-slot arrivals of ``scenario``.

    ``rng`` is an int seed or a :class:`numpy.random.Generator` (one slot
    seed drawn per arrival, as the reference draws one key), or a
    :class:`torch.Generator` drawn from directly.
    """
    if isinstance(rng, torch.Generator):
        return [scenario.make_batch(rng, 1) for _ in range(n)]
    if isinstance(rng, (int, np.integer)):
        rng = cell_rng(int(rng))
    dev = resolve_device(device)
    out = []
    for _ in range(n):
        gen = torch.Generator(device=dev)
        gen.manual_seed(slot_seed(rng))
        out.append(scenario.make_batch(gen, 1))
    return out


def slot_metric_means(metric_dicts) -> dict:
    """Slot-weighted means of the standard per-slot metrics (absent
    metrics aggregate to None)."""
    out = {}
    vals = {k: [] for k in METRIC_KEYS}
    for m in metric_dicts:
        if not m:
            continue
        for k in METRIC_KEYS:
            if k in m:
                vals[k].append(m[k])
    for k, v in vals.items():
        out[k] = float(np.mean(v)) if v else None
    return out


def first_steady(times) -> tuple:
    """``(first, steady)``: the first duration vs the median of the rest."""
    times = [float(t) for t in times]
    if not times:
        return None, None
    first = times[0]
    steady = float(np.median(times[1:])) if len(times) > 1 else first
    return first, steady


def build_serve_report(pipeline: _link.ReceiverPipeline, scenario,
                       metric_dicts, *, n_slots: int, n_batches: int,
                       batch_size: int, wall_s: float,
                       exec_stats: Optional[ExecStats] = None,
                       batch_times=()) -> PhyServeReport:
    """Aggregate served-slot metrics into a :class:`PhyServeReport`."""
    means = slot_metric_means(metric_dicts)
    wall_safe = max(wall_s, 1e-9)
    goodput = None
    if means["bler"] is not None and scenario.code is not None:
        goodput = coding.goodput_bits(
            scenario, means["bler"], n_slots
        ) / wall_safe
    energy = gops_w = l1_res = None
    if pipeline.stage_cycles():
        er = pipeline.energy_report()
        energy = er.total_j * 1e6
        gops_w = er.gops_per_watt
        l1_res = er.l1_residency
    first_s, steady_s = first_steady(batch_times)
    return PhyServeReport(
        pipeline=pipeline.name,
        scenario=scenario.name,
        n_slots=n_slots,
        n_batches=n_batches,
        batch_size=batch_size,
        wall_s=wall_s,
        slots_per_sec=n_slots / wall_safe,
        ber=means["ber"],
        che_mse=means["che_mse"],
        tti=pipeline.tti_report(batch=batch_size),
        stage_cycles=pipeline.stage_cycles(),
        bler=means["bler"],
        info_bits_per_sec=goodput,
        decode_iters=means["decode_iters"],
        precision=pipeline.precision,
        energy_uj_per_slot=energy,
        gops_per_watt=gops_w,
        l1_residency=l1_res,
        compile_time_s=exec_stats.compile_time_s if exec_stats else 0.0,
        executables_compiled=(
            exec_stats.executables_compiled if exec_stats else 0
        ),
        cache_hits=exec_stats.cache_hits if exec_stats else 0,
        first_tick_s=first_s,
        steady_tick_s=steady_s,
    )


class BatchRunner:
    """One pipeline + timed fixed-shape batch execution.

    Stacks up to ``batch_size`` requests (padding by repetition, so each
    slot schema has one step shape), runs the step of the process's
    :class:`~repro_torch.serve.exec_registry.ExecRegistry` for the batch's
    schema (a CUDA graph replay on the card) with the timed window closed
    by a device synchronize, and records per-request metrics.

    :meth:`prepare` / :meth:`warmup` *acquire* the step (capturing it
    outside the timed window) without serving anything.  Capture
    accounting lands in ``exec_stats``; per-batch latencies in
    ``batch_times``.
    """

    def __init__(self, pipeline: _link.ReceiverPipeline, batch_size: int,
                 *, registry=None):
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.registry = registry if registry is not None else get_registry()
        self.exec_stats = ExecStats()
        self.wall_s = 0.0
        self.n_batches = 0
        self.batch_times: list = []
        self._steps: dict = {}  # slot schema -> CapturedStep

    def prepare(self, batch: dict):
        """Acquire the step for ``batch``'s slot schema (no serving).
        Idempotent per schema; the registry satisfies repeat acquisitions
        in memory."""
        schema = slot_schema(batch)
        step = self._steps.get(schema)
        if step is None:
            step = self.registry.acquire_pipeline_step(
                self.pipeline, batch, batch=self.batch_size,
                stats=self.exec_stats,
            )
            self._steps[schema] = step
        return step

    def warmup(self, reqs: list) -> None:
        self.prepare(stack_slots(
            [r.slot for r in reqs], self.batch_size - len(reqs)
        ))

    def _step(self, batch: dict) -> dict:
        """Stage ``batch`` into its step's inputs and run the step
        (acquiring it first if a caller skipped :meth:`prepare`)."""
        return self.prepare(batch)(batch)

    def _execute(self, batch: dict) -> dict:
        """One stacked batch inside the timed window: the staging copies,
        the replay and the synchronize."""
        t0 = time.perf_counter()
        state = self._step(batch)
        if self.pipeline.device.type == "cuda":
            torch.cuda.synchronize(self.pipeline.device)
        dt = time.perf_counter() - t0
        self.wall_s += dt
        self.batch_times.append(dt)
        return state

    def run_batch(self, reqs: list) -> dict:
        """Serve one chunk of requests; returns the raw pipeline state and
        marks each request done with its per-slot metrics.

        On CUDA the state's tensors are the step's graph outputs and
        static inputs: they hold this batch until the same step's next
        call overwrites them, so read them (as the scheduler reads
        ``crc_ok`` and ``cw_llr`` to the host) before serving the next
        batch of that schema."""
        batch = stack_slots(
            [r.slot for r in reqs], self.batch_size - len(reqs)
        )
        state = self._execute(batch)
        self.n_batches += 1
        metrics = _link.slot_metrics(
            state, self.pipeline.scenario, per_slot=True
        )
        metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
        for j, r in enumerate(reqs):
            r.metrics = {k: float(v[j]) for k, v in metrics.items()}
            r.done = True
        return state

    def drain(self, reqs: list, warmup: bool = True) -> int:
        """Serve ``reqs`` in fixed-size chunks; returns the chunk count."""
        chunks = [
            reqs[i : i + self.batch_size]
            for i in range(0, len(reqs), self.batch_size)
        ]
        if warmup and chunks:
            self.warmup(chunks[0])
        for chunk in chunks:
            self.run_batch(chunk)
        return len(chunks)


# ---------------------------------------------------------------------------
# Closed-loop TTI scheduling: the per-cell state machine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HarqProcess:
    """Soft state of one in-flight slot's transport blocks: ``prior`` is
    the combined channel-LLR buffer (1, C, n_mother), allocated on the
    first NACK's feedback and freed on delivery or exhaustion; ``info``
    holds the payloads exactly as the slot builder drew them."""
    mcs: int
    info: object  # (1, C, k_info) transport-block payloads
    prior: np.ndarray  # (1, C, n_mother) combined channel LLRs
    acked: np.ndarray  # (C,) bool
    n_tx: int = 0
    rv: int = 0  # redundancy version of the *next* transmission


@dataclasses.dataclass
class _Job:
    """One pending transmission in a user's queue."""
    enq_tick: int
    job_id: int = -1
    harq: Optional[HarqProcess] = None  # None until first serve


@dataclasses.dataclass
class UserState:
    """Per-user closed-loop state: queue, channel and link adaptation."""
    user_id: int
    snr_db: float
    mcs: int
    olla: float = 0.0
    backlog: collections.deque = dataclasses.field(
        default_factory=collections.deque
    )


@dataclasses.dataclass
class TickStats:
    """What one TTI tick did."""
    tick: int
    n_arrivals: int = 0
    n_served: int = 0
    n_miss: int = 0
    backlog_after: int = 0


@dataclasses.dataclass
class ClosedLoopReport:
    """Aggregate report of one closed-loop serving run (one cell); the
    reference's fields, one for one."""
    ladder: str
    receiver: str
    n_users: int
    n_ticks: int
    batch_size: int
    max_retx: int
    deadline_ttis: int
    adapt: bool
    n_slots: int
    n_batches: int
    wall_s: float
    slots_per_sec: float
    n_arrivals: int
    deadline_miss_rate: float
    first_tx_bler: Optional[float]
    residual_bler: Optional[float]
    mean_harq_rounds: Optional[float]
    blocks_delivered: int
    blocks_lost: int
    goodput_bits_per_sec: float
    goodput_bits_per_tti: float
    mcs_occupancy: dict
    backlog_left: int
    harq_open: int
    precision: str = "fp32"
    energy_uj_per_slot: Optional[float] = None
    gops_per_watt: Optional[float] = None
    l1_residency: Optional[float] = None
    cell: str = ""
    handover_in: int = 0
    handover_out: int = 0
    jobs_shed: int = 0
    faults: int = 0
    degraded_batches: int = 0
    quarantined_batches: int = 0
    quarantine_ticks: int = 0
    crashes: int = 0
    jobs_failed: int = 0
    compile_time_s: float = 0.0
    executables_compiled: int = 0
    cache_hits: int = 0
    first_tick_s: Optional[float] = None
    steady_tick_s: Optional[float] = None

    def summary(self) -> str:
        parts = [
            f"closed-loop[{self.ladder}]: {self.n_slots} slots / "
            f"{self.n_ticks} TTIs in {self.wall_s:.3f}s "
            f"({self.slots_per_sec:.1f} slots/s, batch={self.batch_size})",
            f"miss={self.deadline_miss_rate:.3f}",
        ]
        if self.first_tx_bler is not None:
            parts.append(f"1tx-BLER={self.first_tx_bler:.4f}")
        if self.residual_bler is not None:
            parts.append(f"resid-BLER={self.residual_bler:.4f}")
        if self.mean_harq_rounds is not None:
            parts.append(f"rounds={self.mean_harq_rounds:.2f}")
        parts.append(f"goodput={self.goodput_bits_per_sec/1e6:.2f} Mbit/s")
        if self.gops_per_watt is not None:
            parts.append(
                f"{self.precision}: {self.gops_per_watt:.0f} GOPS/W"
            )
        occ = " ".join(
            f"{name}:{frac:.2f}"
            for name, frac in sorted(self.mcs_occupancy.items())
        )
        parts.append(f"occ[{occ}]")
        return "  ".join(parts)


class JobCounter:
    """Monotone transport-block-job id allocator (``n`` issued so far)."""

    def __init__(self):
        self.n = 0

    def __next__(self) -> int:
        i = self.n
        self.n += 1
        return i

    def __iter__(self):
        return self


def resolve_ladder(ladder):
    """Accept an MCSLadder, a registered ladder name, or a single coded
    LinkScenario (a one-rung ladder); return ``(name, rung scenarios)``."""
    from repro_torch.phy.scenarios import (
        LinkScenario, MCSLadder, get_ladder, get_scenario,
    )

    if isinstance(ladder, str):
        try:
            ladder = get_ladder(ladder)
        except KeyError:
            ladder = get_scenario(ladder)
    if isinstance(ladder, LinkScenario):
        if ladder.code is None:
            raise ValueError(f"{ladder.name}: the closed loop needs a "
                             "channel code (CRC ACK/NACK feedback)")
        return ladder.name, [ladder]
    if not isinstance(ladder, MCSLadder):
        raise TypeError(f"not a ladder or coded scenario: {ladder!r}")
    return ladder.name, ladder.scenarios()


def occupancy_energy(occupancy, pipelines):
    """Occupancy-weighted modeled energy over rung pipelines:
    ``(energy_uj_per_slot, gops_per_watt, l1_residency)`` or Nones."""
    rung_reps = [
        (n, p.energy_report())
        for n, p in zip(occupancy, pipelines)
        if n > 0 and p.stage_cycles()
    ]
    if not rung_reps:
        return None, None, None
    tot_j = sum(n * er.total_j for n, er in rung_reps)
    tot_ops = sum(n * er.ops for n, er in rung_reps)
    tot_l1 = sum(n * er.l1_bytes for n, er in rung_reps)
    tot_dma = sum(n * er.dma_bytes for n, er in rung_reps)
    n_slots = sum(n for n, _ in rung_reps)
    return (
        tot_j / n_slots * 1e6,
        tot_ops / tot_j * 1e-9 if tot_j > 0 else 0.0,
        tot_l1 / (tot_l1 + tot_dma) if tot_l1 + tot_dma else 0.0,
    )


class CellLoop:
    """The per-cell closed-loop state machine (numpy logic, no execution).

    Owns per-user queues and link-adaptation state, Poisson arrivals,
    HARQ soft buffers and ACK/NACK feedback, batch planning under the
    per-TTI capacity, and the counters behind :class:`ClosedLoopReport`.
    All randomness draws from the single ``rng`` stream; slots come from
    ``slot_factory`` (default :class:`TorchSlotFactory` on ``device``).
    """

    def __init__(self, rungs, *, name: str = "cell0",
                 rng: np.random.Generator, n_users: int = 4,
                 batch_size: int = 4, arrival_rate: float = 1.0,
                 max_retx: int = 2, deadline_ttis: int = 4,
                 max_batches_per_tick: Optional[int] = None,
                 adapt: bool = True, target_bler: float = 0.1,
                 olla_step: float = 0.1, init_mcs: int = 0,
                 snr_db: Optional[float] = None,
                 snr_spread_db: float = 0.0,
                 interferer_db: tuple = (), uid_base: int = 0,
                 job_ids=None, slot_factory: Optional[Callable] = None,
                 device: DeviceLike = None):
        self.name = name
        self.rungs = list(rungs)
        self.rng = rng
        self.device = resolve_device(device)  # where HARQ payloads live
        self.slot_factory = (slot_factory if slot_factory is not None
                             else TorchSlotFactory(self.device))
        self.interferer_db = tuple(interferer_db)
        self.batch_size = batch_size
        self.arrival_rate = arrival_rate
        self.max_retx = max_retx
        self.deadline_ttis = deadline_ttis
        self.max_batches_per_tick = max_batches_per_tick
        self.adapt = adapt and len(self.rungs) > 1
        self.target_bler = target_bler
        self.olla_up = olla_step
        self.olla_down = olla_step * (1.0 - target_bler) / target_bler
        self._job_ids = JobCounter() if job_ids is None else job_ids

        init_mcs = min(init_mcs, len(self.rungs) - 1)
        base_snr = self.rungs[init_mcs].snr_db if snr_db is None else snr_db
        self.users = [
            UserState(
                user_id=uid_base + i,
                snr_db=float(base_snr + self.rng.uniform(
                    -snr_spread_db, snr_spread_db
                )),
                mcs=init_mcs,
            )
            for i in range(n_users)
        ]
        self.now = 0
        self.tick_log: list = []
        self.n_batches = 0
        self._arrivals = 0
        self._served = 0
        self._missed = 0
        self._first_tx_blocks = 0
        self._first_tx_errors = 0
        self._delivered = [0] * len(self.rungs)  # blocks per rung
        self._lost = 0
        self._rounds: list = []  # per finalized process
        self._occupancy = [0] * len(self.rungs)  # served slots per rung
        self.finalized_jobs: list = []
        self.handover_in = 0
        self.handover_out = 0
        self.jobs_shed = 0

    # -- traffic ----------------------------------------------------------
    def next_seed(self) -> int:
        return slot_seed(self.rng)

    def _new_job(self) -> _Job:
        self._arrivals += 1
        return _Job(enq_tick=self.now, job_id=next(self._job_ids))

    def inject_backlog(self, n_per_user: int) -> None:
        """Enqueue ``n_per_user`` new-data jobs for every user now."""
        for u in self.users:
            for _ in range(n_per_user):
                u.backlog.append(self._new_job())

    def arrive(self, stats: TickStats) -> None:
        if self.arrival_rate <= 0:
            return
        for u in self.users:
            for _ in range(int(self.rng.poisson(self.arrival_rate))):
                u.backlog.append(self._new_job())
                stats.n_arrivals += 1

    # -- slot construction ------------------------------------------------
    def make_slot(self, user: UserState, job: _Job, mcs: int) -> dict:
        """Build the (re)transmission slot for one job: new data draws
        fresh blocks at the planned rung and opens the HARQ process;
        retransmissions re-encode the process's blocks at its next RV over
        a fresh channel, with the combined-LLR buffer as the prior."""
        if job.harq is None:
            scn = self.rungs[mcs]
            n_cw = coding.codewords_per_slot(scn)
            slot = self.slot_factory(
                self.next_seed(), self._tx_scenario(scn, user), 1, rv=0
            )
            job.harq = HarqProcess(
                mcs=mcs,
                info=slot["info_bits"],
                prior=np.zeros((1, n_cw, scn.code.n_mother), np.float32),
                acked=np.zeros(n_cw, bool),
            )
        else:
            h = job.harq
            scn = self.rungs[h.mcs]  # retx pins the MCS of the first tx
            slot = self.slot_factory(
                self.next_seed(), self._tx_scenario(scn, user), 1,
                rv=h.rv, info=h.info,
            )
        slot["prior_llr"] = job.harq.prior
        return slot

    def _tx_scenario(self, scn, user: UserState):
        """The rung at the user's SNR, plus cell-level interference."""
        if self.interferer_db:
            return scn.replace(
                snr_db=user.snr_db,
                interferer_db=tuple(scn.interferer_db) + self.interferer_db,
            )
        return scn.replace(snr_db=user.snr_db)

    # -- feedback ---------------------------------------------------------
    def serve_feedback(self, user: UserState, job: _Job, mcs: int,
                       crc_ok: np.ndarray, cw_llr: np.ndarray,
                       stats: TickStats) -> None:
        """Record one served slot and ACK/NACK its transport blocks."""
        self._occupancy[mcs] += 1
        self._served += 1
        stats.n_served += 1
        if self.now - job.enq_tick > self.deadline_ttis:
            self._missed += 1
            stats.n_miss += 1
        self._feedback(user, job, crc_ok, cw_llr)

    def _feedback(self, user: UserState, job: _Job, crc_ok: np.ndarray,
                  cw_llr: np.ndarray) -> None:
        h = job.harq
        h.n_tx += 1
        first_tx = h.n_tx == 1
        ok = h.acked | crc_ok
        if first_tx:
            self._first_tx_blocks += crc_ok.size
            self._first_tx_errors += int((~crc_ok).sum())
            if self.adapt:
                self._olla(user, bool(crc_ok.all()))
        if ok.all():
            self._delivered[h.mcs] += int(ok.size)
            self._rounds.append(h.n_tx)
            self.finalized_jobs.append(job.job_id)
            job.harq = None  # buffer freed
        elif h.n_tx > self.max_retx:
            self._delivered[h.mcs] += int(ok.sum())
            self._lost += int((~ok).sum())
            self._rounds.append(h.n_tx)
            self.finalized_jobs.append(job.job_id)
            job.harq = None  # block lost, buffer freed
        else:
            h.acked = ok
            h.prior = np.asarray(cw_llr, np.float32)
            h.rv += 1
            # retransmissions queue ahead of the user's new data
            user.backlog.appendleft(
                dataclasses.replace(job, enq_tick=self.now)
            )

    def _olla(self, user: UserState, ack: bool) -> None:
        """Outer-loop link adaptation: crossing +-1 walks one rung."""
        user.olla += self.olla_up if ack else -self.olla_down
        if user.olla >= 1.0:
            if user.mcs < len(self.rungs) - 1:
                user.mcs += 1
            user.olla = 0.0
        elif user.olla <= -1.0:
            if user.mcs > 0:
                user.mcs -= 1
            user.olla = 0.0

    # -- planning ---------------------------------------------------------
    def plan_batches(self) -> list:
        """This tick's transmissions (one per user, its oldest job) grouped
        by (MCS, SNR) into batches, oldest first, capped at
        ``max_batches_per_tick``; jobs that do not fit go back to the head
        of their user's queue."""
        active = [u for u in self.users if u.backlog]
        active.sort(key=lambda u: u.backlog[0].enq_tick)
        by_key: dict = {}
        for u in active:
            job = u.backlog.popleft()
            mcs = job.harq.mcs if job.harq is not None else u.mcs
            by_key.setdefault((mcs, u.snr_db), []).append((u, job))
        batches = []
        for (mcs, _snr), pairs in by_key.items():
            for i in range(0, len(pairs), self.batch_size):
                batches.append((mcs, pairs[i : i + self.batch_size]))
        batches.sort(key=lambda b: min(j.enq_tick for _, j in b[1]))
        cap = self.max_batches_per_tick
        if cap is not None and len(batches) > cap:
            for _mcs, pairs in batches[cap:]:
                for u, job in pairs:
                    u.backlog.appendleft(job)
            batches = batches[:cap]
        return batches

    def end_tick(self, stats: TickStats) -> TickStats:
        stats.backlog_after = self.backlog
        self.tick_log.append(stats)
        self.now += 1
        return stats

    # -- mobility (driven by the mesh scheduler) --------------------------
    def pending_jobs(self) -> int:
        return sum(len(u.backlog) for u in self.users)

    def capacity_jobs(self) -> float:
        """Jobs this cell can serve within its deadline budget: the
        saturation threshold of the mesh's handover and shedding.  An
        unlimited pool (``max_batches_per_tick=None``) never saturates."""
        if self.max_batches_per_tick is None:
            return float("inf")
        return (self.max_batches_per_tick * self.batch_size
                * (self.deadline_ttis + 1))

    def shed_tail(self, n: int) -> list:
        """Drop up to ``n`` not-yet-started jobs from the backlog tails,
        longest queue first.  Only new-data jobs are shed: a job with a
        HARQ process in flight has soft state that must finalize through
        feedback.  The shed ids finalize here, so finalized + queued ids
        stay the issued ids exactly.  Returns the shed ids."""
        shed = []
        for u in sorted(self.users, key=lambda u: -len(u.backlog)):
            while len(shed) < n and u.backlog and \
                    u.backlog[-1].harq is None:
                shed.append(u.backlog.pop().job_id)
        self.finalized_jobs.extend(shed)
        self.jobs_shed += len(shed)
        return shed

    # -- reporting --------------------------------------------------------
    @property
    def backlog(self) -> int:
        return sum(len(u.backlog) for u in self.users)

    @property
    def harq_open(self) -> int:
        """HARQ soft buffers currently allocated (in-flight processes)."""
        return sum(
            1 for u in self.users for j in u.backlog if j.harq is not None
        )

    def good_bits(self) -> float:
        return sum(
            d * s.code.k_info for d, s in zip(self._delivered, self.rungs)
        )

    def report(self, *, ladder_name: str, receiver: str, pipelines,
               wall_s: float, n_batches: int) -> ClosedLoopReport:
        wall_safe = max(wall_s, 1e-9)
        finalized = self._lost + sum(self._delivered)
        good_bits = self.good_bits()
        total_occ = max(sum(self._occupancy), 1)
        energy, gops_w, l1_res = occupancy_energy(
            self._occupancy, pipelines
        )
        return ClosedLoopReport(
            ladder=ladder_name,
            receiver=receiver,
            n_users=len(self.users),
            n_ticks=self.now,
            batch_size=self.batch_size,
            max_retx=self.max_retx,
            deadline_ttis=self.deadline_ttis,
            adapt=self.adapt,
            n_slots=self._served,
            n_batches=n_batches,
            wall_s=wall_s,
            slots_per_sec=self._served / wall_safe,
            n_arrivals=self._arrivals,
            deadline_miss_rate=(
                self._missed / self._served if self._served else 0.0
            ),
            first_tx_bler=(
                self._first_tx_errors / self._first_tx_blocks
                if self._first_tx_blocks else None
            ),
            residual_bler=(
                self._lost / finalized if finalized else None
            ),
            mean_harq_rounds=(
                float(np.mean(self._rounds)) if self._rounds else None
            ),
            blocks_delivered=int(sum(self._delivered)),
            blocks_lost=self._lost,
            goodput_bits_per_sec=good_bits / wall_safe,
            goodput_bits_per_tti=good_bits / max(self.now, 1),
            mcs_occupancy={
                s.name: self._occupancy[i] / total_occ
                for i, s in enumerate(self.rungs)
            },
            backlog_left=self.backlog,
            harq_open=self.harq_open,
            precision=pipelines[0].precision,
            energy_uj_per_slot=energy,
            gops_per_watt=gops_w,
            l1_residency=l1_res,
            cell=self.name,
            handover_in=self.handover_in,
            handover_out=self.handover_out,
            jobs_shed=self.jobs_shed,
        )


# ---------------------------------------------------------------------------
# Single-cell closed-loop frontend
# ---------------------------------------------------------------------------

class SlotScheduler:
    """TTI-clocked closed-loop slot scheduler over an MCS ladder: a thin
    execution frontend over one :class:`CellLoop` that runs each tick's
    batches through per-rung :class:`BatchRunner`\\ s and feeds the CRC
    results back.

    Parameters are the reference's (``ladder``, ``n_users``,
    ``batch_size``, ``receiver``/``options``, ``pipelines``,
    ``arrival_rate``, ``max_retx``, ``deadline_ttis``,
    ``max_batches_per_tick``, ``adapt``/``target_bler``/``olla_step``,
    ``init_mcs``, ``snr_db``/``snr_spread_db``, ``interferer_db``,
    ``seed``, ``prebuild``, ``registry``), plus ``device`` (None -> CUDA;
    the pipelines and default slots live there) and ``slot_factory`` (see
    the module doc).

    prebuild: acquire every rung's step (its CUDA graph on the card) from
        a template HARQ batch before the first TTI; ``False`` defers each
        rung to its first served batch.  On CUDA the kernels are built at
        construction either way, outside every timed window.
    registry: explicit :class:`~repro_torch.serve.exec_registry.
        ExecRegistry` (default: the process-wide registry, shared with
        every other engine in the process).
    """

    def __init__(self, ladder, *, n_users: int = 4, batch_size: int = 4,
                 receiver: str = "classical", options: Optional[dict] = None,
                 pipelines: Optional[list] = None,
                 arrival_rate: float = 1.0, max_retx: int = 2,
                 deadline_ttis: int = 4,
                 max_batches_per_tick: Optional[int] = None,
                 adapt: bool = True, target_bler: float = 0.1,
                 olla_step: float = 0.1, init_mcs: int = 0,
                 snr_db: Optional[float] = None,
                 snr_spread_db: float = 0.0,
                 interferer_db: tuple = (), seed: int = 0,
                 prebuild: bool = True, registry=None,
                 device: DeviceLike = None,
                 slot_factory: Optional[Callable] = None):
        self.ladder_name, self.rungs = resolve_ladder(ladder)
        self.receiver = receiver
        self.batch_size = batch_size
        self.device = resolve_device(device)

        if pipelines is None:
            pipelines = [
                _link.build_pipeline(receiver, s, device=self.device,
                                     **(options or {}))
                for s in self.rungs
            ]
        if len(pipelines) != len(self.rungs):
            raise ValueError(f"{len(pipelines)} pipelines for "
                             f"{len(self.rungs)} rungs")
        self.runners = [
            BatchRunner(p, batch_size, registry=registry) for p in pipelines
        ]
        if self.device.type == "cuda":
            from repro_torch.kernels import _build

            _build.build_all()
        self.tick_times: list = []
        if prebuild:
            # every rung's step before the first TTI, from the schema a
            # closed-loop batch has (HARQ: rv + prior_llr)
            for scn, runner in zip(self.rungs, self.runners):
                runner.prepare(template_batch(scn, batch_size, harq=True,
                                              device=self.device))

        self.loop = CellLoop(
            self.rungs, rng=cell_rng(seed), n_users=n_users,
            batch_size=batch_size, arrival_rate=arrival_rate,
            max_retx=max_retx, deadline_ttis=deadline_ttis,
            max_batches_per_tick=max_batches_per_tick, adapt=adapt,
            target_bler=target_bler, olla_step=olla_step,
            init_mcs=init_mcs, snr_db=snr_db,
            snr_spread_db=snr_spread_db, interferer_db=interferer_db,
            slot_factory=slot_factory, device=self.device,
        )
        self.ledger = SlotLedger()

    # delegation: the state machine is the source of truth
    @property
    def users(self):
        return self.loop.users

    @property
    def tick_log(self):
        return self.loop.tick_log

    @property
    def now(self) -> int:
        return self.loop.now

    @property
    def max_retx(self) -> int:
        return self.loop.max_retx

    @property
    def adapt(self) -> bool:
        return self.loop.adapt

    @property
    def harq_open(self) -> int:
        return self.loop.harq_open

    def inject_backlog(self, n_per_user: int) -> None:
        self.loop.inject_backlog(n_per_user)

    # -- the TTI loop -----------------------------------------------------
    def tick(self) -> TickStats:
        """Advance one TTI: arrivals, batched serving, HARQ feedback.
        The only host reads are each batch's metrics, ``crc_ok`` and
        ``cw_llr``, as in the reference; they copy the state to the host
        before the next batch, whose replay overwrites it."""
        loop = self.loop
        stats = TickStats(tick=loop.now)
        loop.arrive(stats)

        served_before = sum(r.wall_s for r in self.runners)
        n_before = sum(r.n_batches for r in self.runners)
        for mcs, pairs in loop.plan_batches():
            runner = self.runners[mcs]
            reqs = [
                self.ledger.new_request(
                    loop.make_slot(u, job, mcs), user_id=u.user_id
                )
                for u, job in pairs
            ]
            state = runner.run_batch(reqs)
            loop.n_batches += 1
            crc_ok = state["crc_ok"].cpu().numpy()
            cw_llr = state["cw_llr"].cpu().numpy()
            for j, (u, job) in enumerate(pairs):
                loop.serve_feedback(
                    u, job, mcs, crc_ok[j].astype(bool),
                    cw_llr[j : j + 1], stats,
                )
        if sum(r.n_batches for r in self.runners) > n_before:
            self.tick_times.append(
                sum(r.wall_s for r in self.runners) - served_before
            )
        return loop.end_tick(stats)

    def run(self, n_ticks: int) -> ClosedLoopReport:
        for _ in range(n_ticks):
            self.tick()
        return self.report()

    # -- reporting --------------------------------------------------------
    def report(self) -> ClosedLoopReport:
        rep = self.loop.report(
            ladder_name=self.ladder_name,
            receiver=self.receiver,
            pipelines=[r.pipeline for r in self.runners],
            wall_s=sum(r.wall_s for r in self.runners),
            n_batches=sum(r.n_batches for r in self.runners),
        )
        stats = ExecStats()
        for r in self.runners:
            stats.merge(r.exec_stats)
        first_s, steady_s = first_steady(self.tick_times)
        return dataclasses.replace(
            rep,
            compile_time_s=stats.compile_time_s,
            executables_compiled=stats.executables_compiled,
            cache_hits=stats.cache_hits,
            first_tick_s=first_s,
            steady_tick_s=steady_s,
        )
