"""Batched PHY slot-serving engine, open loop, single cell (port of
:mod:`repro.serve.phy_engine`, unsupervised; supervision waits for ROADMAP
queue 1, item 8).

A thin frontend over the shared core in :mod:`repro_torch.serve.runtime`:
submit bookkeeping on :class:`SlotLedger`, batching and the timed loop on
:class:`BatchRunner` (each batch a step of the executable registry, a
CUDA graph replay on the card), the report on :func:`build_serve_report`.
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

    def __init__(self, pipeline: _link.ReceiverPipeline, batch_size: int):
        self.pipeline = pipeline
        self.batch_size = batch_size
        self._queue: list = []
        self._ledger = SlotLedger()

    @classmethod
    def from_scenario(cls, scenario, receiver: str = "classical",
                      batch_size: int = 4, device: DeviceLike = None,
                      **options) -> "PhyServeEngine":
        """Build the pipeline (on ``device``, None -> CUDA) and the engine;
        ``options`` pass to the pipeline builder (e.g. ``fused=True``)."""
        from repro_torch.phy.scenarios import get_scenario

        if isinstance(scenario, str):
            scenario = get_scenario(scenario)
        return cls(
            _link.build_pipeline(receiver, scenario, device=device,
                                 **options),
            batch_size=batch_size,
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
        runner = BatchRunner(self.pipeline, self.batch_size)
        n_batches = runner.drain(reqs, warmup=warmup)
        return build_serve_report(
            self.pipeline, self.pipeline.scenario,
            [r.metrics for r in reqs],
            n_slots=len(reqs), n_batches=n_batches,
            batch_size=self.batch_size, wall_s=runner.wall_s,
            exec_stats=runner.exec_stats, batch_times=runner.batch_times,
        )
