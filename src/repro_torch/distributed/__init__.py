"""Sharding rules and placements of the port
(:mod:`repro_torch.distributed.sharding`): the LM rules on DTensor, and
the multi-cell PHY step's placement."""
from repro_torch.distributed.sharding import LaneCheck, cell_slot_placement
