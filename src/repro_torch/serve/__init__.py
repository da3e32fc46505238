"""Serving on the port: LM request batching (:class:`ServeEngine`, its
decode step one captured CUDA graph, :mod:`repro_torch.serve.engine`), and
PHY serving: the shared slot-scheduler core and the
closed-loop TTI runtime (:mod:`repro_torch.serve.runtime`), the open-loop
single-cell engine (:mod:`repro_torch.serve.phy_engine`), multi-cell
serving with its lanes folded into the kernels' batch axis, open loop
(:class:`CellMeshEngine`) and closed loop (:class:`MeshSlotScheduler`)
(:mod:`repro_torch.serve.cell_mesh`), and the registry of captured serving
steps (:mod:`repro_torch.serve.exec_registry`).  Fault tolerance rides on
top: deterministic fault injection (:class:`FaultPlan` /
:class:`FaultInjector`, :mod:`repro_torch.serve.faults`) and the
supervised runtime (:class:`Supervisor`, :class:`SupervisedBatchRunner`,
:mod:`repro_torch.serve.supervisor`) with non-finite guards, bounded
retries, cell quarantine and checkpointed crash recovery."""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.exec_registry import (
    BucketPolicy, CapturedStep, CostModelBuckets, ExecKey, ExecRegistry,
    ExecStats, FixedBuckets, PowerOfTwoBuckets, exec_key_for, get_registry,
    set_registry, slot_schema, template_batch, template_slot,
)
from repro_torch.serve.runtime import (
    BatchRunner, CellLoop, ClosedLoopReport, JobCounter, PhyServeReport,
    SlotLedger, SlotRequest, SlotScheduler, TorchSlotFactory,
    build_serve_report, cell_rng, make_traffic, slot_metric_means,
    slot_seed, stack_slots, validate_slots,
)
from repro_torch.serve.phy_engine import PhyServeEngine
from repro_torch.serve.cell_mesh import (
    CellMeshEngine, CellSpec, ClosedCellSpec, MeshClosedLoopReport,
    MeshServeReport, MeshSlotScheduler, cell, closed_cell,
)
from repro_torch.serve.faults import (
    FAULT_KINDS, FaultEvent, FaultInjector, FaultPlan, InjectedFault,
)
from repro_torch.serve.supervisor import (
    SupervisedBatchRunner, Supervisor, restore_cell_loop,
    snapshot_cell_loop,
)
