#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload deeprx-cluster8 --seed 7 \
        --seconds 10 --trace 0

Run from the root of a checkout.  The kernels' build cache is the port's
own ``build/repro_torch_kernels/`` in the checkout; the autotuner's cache
is pointed at ``build/portbench/tune.json`` there, which the benchmark
never writes, so every launch takes the kernels' heuristic choice.
"""
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """This process's start on ``time.time()``'s clock (Linux /proc; the
    interpreter's first line elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src")]
os.environ["REPRO_TUNE_CACHE"] = str(ROOT / "build" / "portbench"
                                     / "tune.json")
os.environ["USE_FLAX"] = "0"

if __name__ == "__main__":
    import torch

    torch.set_num_threads(1)  # load from one process with few threads
    from harness import cli

    sys.exit(cli.main(sys.argv[1:], T_START))
