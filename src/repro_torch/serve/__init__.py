"""PHY serving on the port: the shared slot-scheduler core and the
closed-loop TTI runtime (:mod:`repro_torch.serve.runtime`) and the open-loop
single-cell engine (:mod:`repro_torch.serve.phy_engine`)."""
from repro_torch.serve.runtime import (
    BatchRunner, CellLoop, ClosedLoopReport, JobCounter, PhyServeReport,
    SlotLedger, SlotRequest, SlotScheduler, TorchSlotFactory,
    build_serve_report, cell_rng, make_traffic, slot_metric_means,
    slot_seed, stack_slots, validate_slots,
)
from repro_torch.serve.phy_engine import PhyServeEngine
