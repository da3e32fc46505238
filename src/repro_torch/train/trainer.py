"""Fault-tolerant training driver (port of :mod:`repro.train.trainer`).

Features:
  * a functional step over a plain state dict (``train.step``)
  * checkpoint every N steps (async, atomic), auto-resume from latest,
    through :class:`repro_torch.checkpoint.CheckpointManager`, whose
    layout either package loads
  * preemption handling: SIGTERM/SIGINT triggers a final checkpoint + clean
    exit with a resumable step counter
  * deterministic data: batch is a pure function of (seed, step), so a
    restart replays the exact stream
  * step-time watchdog: logs straggler steps (> 3 x median)

The step's one host sync is the read of its metrics (the reference's
``device_get``).  The reference's ``mesh`` / ``state_shardings`` /
``batch_shardings`` shard the step over devices; the port runs on one
card, and those arguments raise ``NotImplementedError`` (ROADMAP item 14e
and item 7 part 3).
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.registry import Model
from repro_torch.train import step as step_lib

PyTree = Any


class Trainer:
    def __init__(
        self,
        model: Model,
        tc: TrainConfig,
        stream: TokenStream,
        mesh=None,
        state_shardings: Optional[PyTree] = None,
        batch_shardings: Optional[dict] = None,
        extra_batch: Optional[Callable[[int], dict]] = None,
        device: DeviceLike = None,
    ):
        if (mesh is not None or state_shardings is not None
                or batch_shardings is not None):
            raise NotImplementedError(
                "a sharded train step needs the LM sharding rules and "
                "several cards (ROADMAP item 14e and item 7 part 3); the "
                "port trains on one card")
        self.model = model
        self.tc = tc
        self.stream = stream
        self.extra_batch = extra_batch
        self.device = resolve_device(device)
        self._preempted = False
        self.step_times: list[float] = []
        self.step_fn = step_lib.make_train_step(model, tc)

        self.ckpt = (
            CheckpointManager(
                tc.checkpoint_dir, keep=tc.keep_checkpoints,
                async_save=tc.async_checkpoint,
            )
            if tc.checkpoint_dir
            else None
        )

    # -- preemption ------------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # -- init / resume ----------------------------------------------------------
    def init_or_resume(self, seed: int = 0) -> tuple[dict, int]:
        """A fresh state drawn from ``torch.Generator(device).
        manual_seed(seed)`` (the reference draws from ``PRNGKey(seed)``,
        which torch cannot replay: carry its parameters across with
        ``params_from_numpy`` for the same weights), replaced by the
        latest checkpoint where there is one."""
        start_step = 0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        state = step_lib.init_state(self.model, gen)
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                state = self.ckpt.restore(latest, state)
                start_step = latest
        return state, start_step

    def _device_batch(self, batch: dict) -> dict:
        """The host batch on the card: staged through pinned memory and
        copied without waiting, so the step's only sync stays its metrics
        read."""
        if self.device.type != "cuda":
            return {k: torch.as_tensor(v) for k, v in batch.items()}
        return {k: torch.as_tensor(v).pin_memory().to(self.device,
                                                      non_blocking=True)
                for k, v in batch.items()}

    @staticmethod
    def _host_metrics(metrics: dict) -> dict:
        """Every metric read to the host in one copy (numpy fp32
        scalars)."""
        keys = list(metrics)
        vals = torch.stack([metrics[k].detach().to(torch.float32)
                            for k in keys]).cpu().numpy()
        return dict(zip(keys, vals))

    # -- main loop ----------------------------------------------------------------
    def run(self, state: dict, start_step: int, num_steps: int,
            log_every: int = 10, log_fn=print):
        metrics_hist = []
        step = start_step
        for step in range(start_step, start_step + num_steps):
            t0 = time.perf_counter()
            batch = self.stream.batch_at(step)
            if self.extra_batch is not None:
                batch = {**batch, **self.extra_batch(step)}
            batch = self._device_batch(batch)
            state, metrics = self.step_fn(state, batch)
            metrics = self._host_metrics(metrics)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            # straggler watchdog
            if len(self.step_times) > 5:
                med = float(np.median(self.step_times[-50:]))
                if dt > 3.0 * med:
                    log_fn(f"[watchdog] step {step}: {dt:.2f}s > 3x median "
                           f"{med:.2f}s (straggler)")
            metrics_hist.append(metrics)
            if step % log_every == 0:
                log_fn(
                    f"step {step}: loss={float(metrics['loss']):.4f} "
                    f"ce={float(metrics['ce']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.2f} {dt*1e3:.0f}ms"
                )
            if self.ckpt and (step + 1) % self.tc.checkpoint_every == 0:
                self.ckpt.save(step + 1, state)
            if self._preempted:
                log_fn(f"[preempt] caught signal at step {step}; checkpointing")
                if self.ckpt:
                    self.ckpt.save(step + 1, state)
                    self.ckpt.wait()
                return state, step + 1, metrics_hist
        if self.ckpt:
            self.ckpt.save(step + 1, state)
            self.ckpt.wait()
        return state, step + 1, metrics_hist
