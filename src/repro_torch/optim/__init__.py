"""Optimizer pieces (port of :mod:`repro.optim`)."""
