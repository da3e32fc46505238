"""Training launcher (port of :mod:`repro.launch.train`).

Smoke run (reduced config) on the card, or on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 20 --device cpu

Sharded run on a host mesh of N gloo CPU processes, one thread each (the
counterpart of the reference's ``--xla_force_host_platform_device_count``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --host-devices 8 --mesh 4x2 --steps 20

Sharded run on one card, a one-rank NCCL group (no socket):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --mesh 1x1 --steps 20
"""
import argparse
import contextlib
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

from repro_torch.configs import TrainConfig, get_config, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.distributed import sharding as shd
from repro_torch.models import get_model
from repro_torch.train import Trainer

_RANK, _WORLD, _PORT = "REPRO_HOST_RANK", "REPRO_HOST_WORLD", "REPRO_HOST_PORT"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_host_ranks(n: int, argv: list) -> int:
    """Run this launcher as ``n`` gloo CPU processes; the largest exit
    code."""
    port = str(_free_port())
    procs = []
    for r in range(n):
        env = dict(os.environ, **{_RANK: str(r), _WORLD: str(n),
                                  _PORT: port, "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv],
            env=env))
    return max(p.wait() for p in procs)


def _start_group(device: str) -> None:
    """The process group of this process: a host rank's gloo group, or a
    one-rank NCCL (card) / gloo (CPU) group over an in-memory store."""
    if _RANK in os.environ:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{os.environ[_PORT]}",
            rank=int(os.environ[_RANK]), world_size=int(os.environ[_WORLD]))
    else:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--full-config", action="store_true",
                    help="published size instead of the reduced smoke config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--host-devices", type=int, default=0,
                    help="run as this many gloo CPU processes (one thread "
                         "each) on the CPU; without --mesh, an Nx1 mesh")
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 => (data, model)")
    ap.add_argument("--mode", default="base",
                    choices=["base", "sp", "fsdp"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; --host-devices: cpu)")
    args = ap.parse_args(argv)

    if args.host_devices and _RANK not in os.environ:
        sys.exit(_spawn_host_ranks(args.host_devices, argv))
    device = "cpu" if args.host_devices else args.device
    if args.host_devices and not args.mesh:
        # the ranks shard one run (data-parallel), not N copies of it
        args.mesh = f"{args.host_devices}x1"

    cfg = get_config(args.arch) if args.full_config else \
        get_smoke_config(args.arch)
    model = get_model(cfg)
    tc = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        microbatches=args.microbatches, checkpoint_dir=args.checkpoint_dir,
    )
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0)

    mesh = state_sh = None
    rank = 0
    if args.mesh:
        _start_group(device or "cuda")
    try:
        if args.mesh:
            from repro_torch.launch.mesh import make_mesh

            rank = dist.get_rank()
            shape = tuple(int(x) for x in args.mesh.split("x"))
            mesh = make_mesh(shape, ("data", "model")[: len(shape)])
            pshard = shd.param_shardings(model, mesh, mode=args.mode)
            state_sh = {"params": pshard,
                        "opt": shd.opt_state_shardings(pshard, mesh)}
        log = print if rank == 0 else (lambda *a, **k: None)
        trainer = Trainer(model, tc, stream, mesh=mesh,
                          state_shardings=state_sh, device=device)
        trainer.install_signal_handlers()
        state, start = trainer.init_or_resume()
        ctx = (shd.activation_mesh(mesh, mode=args.mode) if mesh is not None
               else contextlib.nullcontext())
        with ctx:
            state, end, hist = trainer.run(state, start, args.steps,
                                           log_fn=log)
        log(f"done: steps {start}..{end}, loss {float(hist[0]['loss']):.4f} "
            f"-> {float(hist[-1]['loss']):.4f}")
    finally:
        if args.mesh:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
