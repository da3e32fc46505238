"""Batched PHY slot-serving engine, open loop, single cell (port of
:mod:`repro.serve.phy_engine`).

A thin frontend over the shared core in :mod:`repro_torch.serve.runtime`:
submit bookkeeping on :class:`SlotLedger`, batching and the timed loop on
:class:`BatchRunner` (each batch a step of the executable registry, a
CUDA graph replay on the card), the report on :func:`build_serve_report`.
``supervised=True`` serves through the guarded
:class:`~repro_torch.serve.supervisor.SupervisedBatchRunner`: bounded
retry on step exceptions, and a batch with non-finite outputs rerun once
on the fp32 unfused reference pipeline.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.device import DeviceLike
from repro_torch.phy import link as _link
from repro_torch.serve.runtime import (
    BatchRunner, PhyServeReport, SlotLedger, SlotRequest,
    build_serve_report, make_traffic,
)


class PhyServeEngine:
    """Drain a queue of per-user slots through one ReceiverPipeline in
    fixed-size batches (the last one padded by repeating its first user).
    """

    def __init__(self, pipeline: _link.ReceiverPipeline, batch_size: int,
                 *, supervised: bool = False, receiver: str = "classical",
                 max_retries: int = 2, backoff_s: float = 0.0):
        self.pipeline = pipeline
        self.batch_size = batch_size
        # supervised serving guards every batch (repro_torch.serve.
        # supervisor): bounded retry on step exceptions, non-finite outputs
        # degrade once to the fp32 unfused reference pipeline
        self.supervised = supervised
        self.receiver = receiver
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self._queue: list = []
        self._ledger = SlotLedger()

    @classmethod
    def from_scenario(cls, scenario, receiver: str = "classical",
                      batch_size: int = 4, device: DeviceLike = None,
                      *, supervised: bool = False,
                      **options) -> "PhyServeEngine":
        """Build the pipeline (on ``device``, None -> CUDA) and the engine;
        ``options`` pass to the pipeline builder (e.g. ``fused=True``);
        ``supervised=True`` serves through the guarded
        :class:`~repro_torch.serve.supervisor.SupervisedBatchRunner`."""
        from repro_torch.phy.scenarios import get_scenario

        if isinstance(scenario, str):
            scenario = get_scenario(scenario)
        return cls(
            _link.build_pipeline(receiver, scenario, device=device,
                                 **options),
            batch_size=batch_size, supervised=supervised,
            receiver=receiver,
        )

    def _make_runner(self) -> BatchRunner:
        if not self.supervised:
            return BatchRunner(self.pipeline, self.batch_size)
        # lazy import: the supervisor imports the serving core, not the
        # other way round
        from repro_torch.serve.supervisor import SupervisedBatchRunner

        return SupervisedBatchRunner(
            self.pipeline, self.batch_size, receiver=self.receiver,
            max_retries=self.max_retries, backoff_s=self.backoff_s,
        )

    # -- traffic ----------------------------------------------------------
    def submit(self, slot: dict, user_id: Optional[int] = None
               ) -> SlotRequest:
        req = self._ledger.new_request(slot, user_id)
        self._queue.append(req)
        return req

    def submit_traffic(self, rng, n_users: int) -> list:
        """Simulate ``n_users`` independent single-slot arrivals on the
        pipeline's device (``rng``: int seed, numpy or torch Generator)."""
        return [
            self.submit(slot)
            for slot in make_traffic(self.pipeline.scenario, rng, n_users,
                                     device=self.pipeline.device)
        ]

    # -- serving ----------------------------------------------------------
    def run(self, warmup: bool = True) -> PhyServeReport:
        """Serve every queued slot; returns the throughput/quality report.

        ``warmup=True`` acquires the step from the process-wide executable
        registry before the timed window opens: on the card its CUDA graph
        is captured there, or found resident, and no batch is served
        twice.  Capture accounting and first/steady batch latency land on
        the report."""
        reqs = self._queue
        self._queue = []
        runner = self._make_runner()
        n_batches = runner.drain(reqs, warmup=warmup)
        return build_serve_report(
            self.pipeline, self.pipeline.scenario,
            [r.metrics for r in reqs],
            n_slots=len(reqs), n_batches=n_batches,
            batch_size=self.batch_size, wall_s=runner.wall_s,
            exec_stats=runner.exec_stats, batch_times=runner.batch_times,
        )
