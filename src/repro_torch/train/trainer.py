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
``device_get``).

Sharded training: ``mesh`` (a ``DeviceMesh`` of :mod:`repro_torch.launch.
mesh`) with ``state_shardings`` (``{"params": param_shardings(...), "opt":
opt_state_shardings(...)}``) places the state as DTensors at
:meth:`Trainer.init_or_resume` and again after every step (the
reference's ``out_shardings``); ``batch_shardings`` places each batch
(without it the batch stays a plain tensor, taken as replicated, and the
models' ``constrain`` shards it, as the reference's unspecified input
sharding does).  The step runs under ``activation_mesh(mesh, mode)``, the
mode the one installed around the run (``launch/train.py`` installs
``--mode``, as the reference's launcher does).
Checkpoints hold the full tensors (every rank gathers; rank 0 writes), so
either package, sharded or not, resumes them.
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
from repro_torch.distributed import sharding as shd
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
        if (state_shardings is not None or batch_shardings is not None) \
                and mesh is None:
            raise ValueError("state or batch shardings need their mesh")
        self.model = model
        self.tc = tc
        self.stream = stream
        self.extra_batch = extra_batch
        self.device = resolve_device(device)
        self.mesh = mesh
        self.state_shardings = state_shardings
        self.batch_shardings = batch_shardings
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
        return self._placed(state), start_step

    def _placed(self, state: dict) -> dict:
        """``state`` as DTensors placed by ``state_shardings`` (as it is
        without them)."""
        if self.state_shardings is None:
            return state
        return shd.distribute(state, self.state_shardings)

    def _save(self, step: int, state: dict) -> None:
        """Checkpoint the full tensors: every rank gathers, rank 0
        writes."""
        import torch.distributed as dist

        if self.mesh is not None:
            state = shd.full_tensor(state)
            if dist.get_rank() != 0:
                return
        self.ckpt.save(step, state)

    def _device_batch(self, batch: dict) -> dict:
        """The host batch on the card: staged through pinned memory and
        copied without waiting, so the step's only sync stays its metrics
        read; placed by ``batch_shardings`` where there are some."""
        if self.device.type != "cuda":
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        else:
            batch = {k: torch.as_tensor(v).pin_memory().to(
                self.device, non_blocking=True) for k, v in batch.items()}
        if self.batch_shardings is not None:
            batch = shd.distribute(batch, {k: self.batch_shardings[k]
                                           for k in batch})
        return batch

    def train_step(self, state: dict, batch: dict) -> tuple:
        """One step under the trainer's activation mesh, in the sharding
        mode installed at the time (the launcher's ``activation_mesh``);
        the new state placed as the old."""
        with shd.activation_mesh(self.mesh, shd.sharding_mode()):
            state, metrics = self.step_fn(state, batch)
            return self._placed(state), metrics

    @staticmethod
    def _host_metrics(metrics: dict) -> dict:
        """Every metric read to the host in one copy (numpy fp32
        scalars)."""
        keys = list(metrics)
        metrics = shd.full_tensor(metrics)
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
            state, metrics = self.train_step(state, batch)
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
                self._save(step + 1, state)
            if self._preempted:
                log_fn(f"[preempt] caught signal at step {step}; checkpointing")
                if self.ckpt:
                    self._save(step + 1, state)
                    self.ckpt.wait()
                return state, step + 1, metrics_hist
        if self.ckpt:
            self._save(step + 1, state)
            self.ckpt.wait()
        return state, step + 1, metrics_hist
