"""The controls on the card, at each cell's own size: the plain
reference in its lower precision put in the program's place must come
out not correct on every seed, and the program itself correct.  Besides
the benchmark's cells, the classical configuration on the cells' mix,
which ``BENCHMARK.json`` does not hold (its served work changes with the
seed).  Run on the chip with ``python -m pytest -q -m cuda
portbench/tests``."""
import time

import pytest
import torch

import small
from harness import arith, spec

SEEDS = (3_000_000_101, 3_000_000_202, 3_000_000_303)
CELLS = ("deeprx-cluster8", "classical")


def _cell(workload: str):
    if workload != "classical":
        return spec.load_cell(workload)
    return spec.make_cell(
        "classical-cluster8", 1,
        spec.read_json(small.BENCH / "configs" / "siso-classical.json"),
        spec.read_json(small.BENCH / "mixes" / "cluster8-urban.json"))


def _run(workload: str, seed: int, control: bool):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = _cell(workload)
    driver = arith.load("drivers", cell.config["driver"])
    return driver.run(cell, seed=seed, seconds=2.0, traced=False,
                      device="cuda:0", t_start=time.time(), control=control)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, seed):
    run = _run(workload, seed, control=True)
    assert not run.verdict["correct"], run.verdict


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct(workload):
    run = _run(workload, SEEDS[0], control=False)
    assert run.verdict["correct"], run.verdict
