"""Deterministic, resumable synthetic data pipeline (port of
:mod:`repro.data.pipeline`).

Batches are a pure function of (seed, step): resuming from a checkpoint at
step N reproduces the exact remaining stream with no iterator state to
save.  ``TokenStream.batch_at`` is the reference's numpy Philox code, so
both packages draw the same bytes for any seed and step.  ``shard_batch``
places a host batch on devices: each key on its device in ``placements``,
every other key on the default device (CUDA), as the reference's
``jnp.asarray`` puts a key without a sharding on its default device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Deterministic batch for a given step (Philox keyed by seed+step)."""
        rng = np.random.Generator(np.random.Philox(key=self.seed + (step << 20)))
        b, s, v = self.global_batch, self.seq_len, self.vocab_size
        # structured synthetic text: piecewise-linear token walks + noise, so
        # next-token prediction is learnable (loss decreases)
        base = rng.integers(0, v, size=(b, 1), dtype=np.int64)
        stride = rng.integers(1, 7, size=(b, 1), dtype=np.int64)
        walk = (base + stride * np.arange(s + 1)[None, :]) % v
        noise = rng.integers(0, v, size=(b, s + 1))
        noisy = rng.random((b, s + 1)) < 0.05
        seq = np.where(noisy, noise, walk).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def iterate(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_stream(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                batch_override: Optional[int] = None) -> TokenStream:
    return TokenStream(
        vocab_size=cfg.vocab_size,
        global_batch=batch_override or shape.global_batch,
        seq_len=shape.seq_len,
        seed=seed,
    )


def shard_batch(batch: dict, placements: dict) -> dict:
    """Place a host batch: ``batch[k]`` as a tensor on ``placements[k]``
    (a device) where given, else on the default device (CUDA)."""
    return {
        k: torch.as_tensor(v).to(resolve_device(placements.get(k)))
        for k, v in batch.items()
    }
