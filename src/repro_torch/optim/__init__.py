"""Optimizer pieces (port of :mod:`repro.optim`)."""
from repro_torch.optim import adamw, compression
