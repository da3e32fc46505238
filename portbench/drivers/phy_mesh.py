"""Driver of the PHY cells: the port's multi-cell closed loop
(``repro_torch.serve.cell_mesh.MeshSlotScheduler``) on one device, fed by
the benchmark's slot pools.

The run's seed draws the slot pools (channels, noise, payloads) and the
compared sample.  The cells' arrivals come from the mix's
``arrival_seed``, the same in every run: the mesh's handover makes the
work a tick serves depend on them for thousands of ticks, so a seed of
their own would change the work.  A neural receiver's weights come from
the configuration's ``weight_seed``.  Set-up builds the scheduler from the mix's cells and
the configuration's ladder and receiver (every (rung, lane bucket) step
captured ahead, ``prebuild=True``, in a registry of its own), checks
that the program's rungs are the configuration's, and runs the mix's
warm-up ticks, so HARQ, the backlogs and the handovers are past their
start before the window.  The window runs ``tick()`` back to back for
the run's seconds.  The harness reaches the program only through its
public surface: the slot factory the loops call, and each cell loop's
``serve_feedback``, through which every served slot's CRC flags and
combined LLRs pass to :class:`Sampler`, which keeps a seeded sample of
jobs, each with all its transmissions in the window, for the comparison
with the plain reference.  A traced run then serves ``trace_ticks`` more
ticks under CUPTI, with the benchmark's spans around ``tick()`` and
around its slot factory.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from harness import trace
from harness.spec import Cell
from harness.traffic import SlotPools


@dataclasses.dataclass
class Sampled:
    """One job kept for the comparison: its rung, the pool entry of its
    first transmission (its payloads), and what the program returned for
    each of its transmissions in the window, in order: the CRC flags
    ``(C,)`` and the combined LLR buffer ``(1, C, n_mother)`` that HARQ
    carries to the next one."""
    job_id: int
    mcs: int
    origin: tuple  # (RV-0 pool key, entry)
    crc_ok: list
    cw_llr: list


class Sampler:
    """A reservoir of ``per_rung`` jobs of each rung, drawn from ``rng``
    (the run's seed) over every job whose first transmission the window
    serves; a kept job's later transmissions in the window are kept
    with it."""

    def __init__(self, pools: SlotPools, rng: np.random.Generator,
                 per_rung: int):
        self.pools = pools
        self.rng = rng
        self.per_rung = per_rung
        self.seen: collections.Counter = collections.Counter()
        self.kept: dict = {}  # rung -> [Sampled]
        self._by_id: dict = {}  # job id -> Sampled

    def observe(self, loop, user, job, mcs: int, crc_ok, cw_llr) -> None:
        """One served slot as the cell's loop is handed it, before the
        loop acts on it."""
        if job.harq.n_tx == 0:  # a first transmission
            self.seen[mcs] += 1
            kept = self.kept.setdefault(mcs, [])
            j = len(kept) if len(kept) < self.per_rung else int(
                self.rng.integers(self.seen[mcs]))
            if j < self.per_rung:
                rec = Sampled(job.job_id, mcs,
                              self.pools.origin(job.harq.info), [], [])
                if j < len(kept):
                    del self._by_id[kept[j].job_id]
                    kept[j] = rec
                else:
                    kept.append(rec)
                self._by_id[job.job_id] = rec
        rec = self._by_id.get(job.job_id)
        if rec is not None:
            rec.crc_ok.append(np.array(crc_ok, bool).reshape(-1))
            rec.cw_llr.append(np.array(cw_llr, np.float32))

    def records(self) -> list:
        return [r for mcs in sorted(self.kept) for r in self.kept[mcs]]


def _cells(cell: Cell) -> list:
    from repro_torch.serve.cell_mesh import closed_cell

    options = dict(cell.config.get("options", {}))
    if cell.config.get("weights") == "seeded":
        options["seed"] = cell.config["weight_seed"]
    return [closed_cell(c["name"], cell.config["ladder"], cell.receiver,
                        n_users=c["n_users"], arrival_rate=c["arrival_rate"],
                        snr_db=c["snr_db"], **options)
            for c in cell.mix["cells"]]


def check_rungs(cell: Cell, sched) -> None:
    """Raise unless the program serves the configuration's rungs: the
    same grid, modem, SNR, channel and code, field for field."""
    (group,) = sched.groups
    got = group.rungs
    if [s.name for s in got] != [r.name for r in cell.rungs]:
        raise ValueError(f"the program's ladder {cell.config['ladder']} is "
                         f"{[s.name for s in got]}, the configuration's "
                         f"{[r.name for r in cell.rungs]}")
    for s, r in zip(got, cell.rungs):
        have = {
            "grid": {f: getattr(s.grid, f) for f in
                     dataclasses.asdict(r.grid)},
            "modem": (s.modem.bits_per_symbol, tuple(s.modem.levels),
                      float(s.modem.norm)),
            "link": (float(s.snr_db), float(s.doppler_rho),
                     tuple(s.interferer_db), s.user_power_db),
            "code": (s.code.z, s.code.k_b, s.code.m_b, s.code.p_tx_b,
                     s.code.info_edges, s.code.crc_bits),
        }
        want = {
            "grid": dataclasses.asdict(r.grid),
            "modem": (r.modem.bits_per_symbol, r.modem.levels,
                      r.modem.norm),
            "link": (r.snr_db, r.doppler_rho, r.interferer_db,
                     r.user_power_db),
            "code": (r.code.z, r.code.k_b, r.code.m_b, r.code.p_tx_b,
                     r.code.info_edges, r.code.crc_bits),
        }
        for k in want:
            if have[k] != want[k]:
                raise ValueError(f"rung {r.name}: the program's {k} "
                                 f"{have[k]} is not the configuration's "
                                 f"{want[k]}")


class PhyMesh:
    """One run of a PHY cell: set-up, window, optional traced slice."""

    def __init__(self, cell: Cell, seed: int, device):
        from repro_torch.serve.cell_mesh import MeshSlotScheduler
        from repro_torch.serve.exec_registry import ExecRegistry

        mix = cell.mix
        pool_seed, sample_seed = (
            int(s) for s in np.random.SeedSequence(int(seed)).generate_state(
                2, np.uint32))
        self.cell = cell
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.pools = SlotPools(cell, pool_seed, self.device,
                               mix["pool_payloads"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pool_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.sched = MeshSlotScheduler(
            _cells(cell), batch_size=mix["batch_size"],
            max_retx=mix["max_retx"], deadline_ttis=mix["deadline_ttis"],
            max_batches_per_tick=mix["max_batches_per_tick"],
            adapt=mix["adapt"], target_bler=mix["target_bler"],
            olla_step=mix["olla_step"], seed=mix["arrival_seed"],
            registry=ExecRegistry(), prebuild=True, device=self.device,
            slot_factory=self.pools)
        self.build_s = time.perf_counter() - t0
        check_rungs(cell, self.sched)
        self.sampler = Sampler(self.pools, np.random.default_rng(sample_seed),
                               mix["sample_jobs_per_rung"])
        t0 = time.perf_counter()
        for _ in range(mix["warmup_ticks"]):
            self.sched.tick()
        self.warmup_s = time.perf_counter() - t0
        # what set-up built lives to the end of the run: keep it out of
        # the collector's full passes in the window
        gc.collect()
        gc.freeze()

    @contextlib.contextmanager
    def _served(self, on_slot):
        """Call ``on_slot(loop, user, job, mcs, crc_ok, cw_llr)`` for every
        slot served inside the block, as its cell's loop is handed the
        slot's feedback (``CellLoop.serve_feedback``) and before the loop
        acts on it."""
        loops = self.sched.loops
        for loop in loops:
            def observed(user, job, mcs, crc_ok, cw_llr, stats,
                         _loop=loop, _serve=loop.serve_feedback):
                on_slot(_loop, user, job, mcs, crc_ok, cw_llr)
                return _serve(user, job, mcs, crc_ok, cw_llr, stats)
            loop.serve_feedback = observed
        try:
            yield
        finally:
            for loop in loops:
                del loop.serve_feedback

    def window(self, seconds: float) -> dict:
        """Serve ticks back to back for ``seconds``; every tick's wall,
        and the window's slots, bits, steps and step time."""
        sched = self.sched
        bits0 = sum(loop.good_bits() for loop in sched.loops)
        wall0, steps0 = sched.wall_s, sched.n_steps
        caps0 = sched.exec_stats.executables_compiled
        ticks, served = [], []
        with self._served(self.sampler.observe):
            t_first = t = time.perf_counter()
            t_end = t_first + seconds
            while t < t_end:
                t0 = t
                stats = sched.tick()
                t = time.perf_counter()
                ticks.append(t - t0)
                served.append(sum(st.n_served for st in stats))
        return {
            "t_first": t_first, "wall_s": t - t_first, "tick_s": ticks,
            "ticks": len(ticks), "slots": sum(served), "served": served,
            "good_bits": sum(loop.good_bits() for loop in sched.loops)
            - bits0,
            "step_s": sched.wall_s - wall0, "steps": sched.n_steps - steps0,
            "captures": sched.exec_stats.executables_compiled - caps0,
        }

    def traced_slice(self, n_ticks: int, symbols) -> dict:
        """``n_ticks`` more ticks under CUPTI, with the benchmark's spans
        around ``tick()`` and around its slot factory.  Each (tick, rung)
        bucket's shape for the yardstick's arithmetic comes from the slots
        served in it: its real slots, their distinct noise values, the
        lanes they fill (one a cell: one batch a cell a tick) and the lane
        bucket the scheduler's policy maps them onto, and the combined
        LLRs the decoder was handed."""
        sched = self.sched
        spans = trace.Spans()
        served: dict = {}  # (tick, rung) -> {cell: [(snr, cw_llr)]}
        now = [0]

        def record(loop, user, job, mcs, crc_ok, cw_llr):
            served.setdefault((now[0], mcs), {}).setdefault(
                loop.name, []).append((user.snr_db,
                                       np.array(cw_llr, np.float32)))

        steps0, slots = sched.n_steps, 0
        self.pools.spans = spans
        try:
            with self._served(record), trace.traced(self.device) as rec:
                t0 = trace.CLOCK()
                for i in range(n_ticks):
                    now[0] = i
                    with spans.span("tick"):
                        stats = sched.tick()
                    slots += sum(st.n_served for st in stats)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t1 = trace.CLOCK()
        finally:
            self.pools.spans = None
        batch = sched.batch_size
        buckets = []
        for (_, mcs), cells in sorted(served.items()):
            lanes = sum(-(-len(v) // batch) for v in cells.values())
            rows = [r for v in cells.values() for r in v]
            buckets.append({
                "mcs": mcs, "lanes": sched.bucket_policy.bucket_for(lanes),
                "batch": batch, "real_slots": len(rows),
                "distinct_nv": len({snr for snr, _ in rows}),
                "cw_llr": np.concatenate([c for _, c in rows]),
            })
        out = trace.summarize(rec["records"], spans, t0, t1, symbols)
        out.update(slots=slots, ticks=n_ticks, buckets=buckets,
                   steps=sched.n_steps - steps0, read_s=rec["read_s"])
        return out

    def release(self) -> list:
        """Drop the program's state (scheduler, registry, graphs); the
        sampled jobs stay."""
        records = self.sampler.records()
        self.sampler = None
        self.sched = None
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        return records


@dataclasses.dataclass
class Run:
    """What the metric readers read (``portbench/metrics``)."""
    cell: Cell
    setup_s: float
    window: dict
    slice: dict  # None unless traced
    verdict: dict
    memory_peak_bytes: int
    notes: dict


def run(cell: Cell, *, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> Run:
    """Set up, measure ``seconds``, trace a slice if ``traced``, free the
    program, compare the sampled jobs with the plain reference.
    ``t_start`` is the process's start on ``time.time()``'s clock."""
    from harness import arith, compare

    dev = torch.device(device)
    mesh = PhyMesh(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - t_start
    window = mesh.window(seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    sliced = None
    if traced:
        symbols = [s for s in (arith.load("ops", st).SYMBOL
                               for st in cell.config["stages"]) if s]
        sliced = mesh.traced_slice(cell.mix["trace_ticks"], symbols)
    notes = {"pools_s": mesh.pool_s, "scheduler_s": mesh.build_s,
             "warmup_s": mesh.warmup_s,
             "pool_bytes": mesh.pools.device_bytes,
             "pool_calls": mesh.pools.calls,
             "captures_in_window": window["captures"],
             "jobs_seen": dict(mesh.sampler.seen)}
    records = mesh.release()
    t0 = time.perf_counter()
    verdict = compare.judge(cell, mesh.pools, records, device=dev,
                            control=control)
    notes["reference_s"] = time.perf_counter() - t0
    if sliced is not None:
        compare.count_iterations(cell, sliced["buckets"], device=dev)
        notes.update(trace_read_s=sliced["read_s"],
                     host_self_s=sliced["host_self_s"],
                     slice_buckets=len(sliced["buckets"]),
                     slice_steps=sliced["steps"])
    return Run(cell, setup_s, window, sliced, verdict, peak, notes)
