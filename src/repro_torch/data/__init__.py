"""Synthetic LM data (port of :mod:`repro.data`)."""
from repro_torch.data.pipeline import TokenStream, make_stream, shard_batch
