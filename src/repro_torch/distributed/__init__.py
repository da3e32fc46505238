"""Placement of the port's multi-cell PHY steps
(:mod:`repro_torch.distributed.sharding`; the LM sharding rules of the
reference's module wait for the LM stack)."""
from repro_torch.distributed.sharding import LaneCheck, cell_slot_placement
