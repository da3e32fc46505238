"""A run of each cell on the CPU at a shrunk grid, past the harness's
look for a card, with the program sound and then broken underneath:
``correct`` comes out true, then false under each fault the cells can
have.  The served step's faults break its outputs
(``CapturedStep.replay``); the HARQ faults break the prior a cell's loop
stages with a retransmission (``CellLoop.make_slot``).  Both cells run on
one device, so no exchange between chips exists to leave out."""
import time

import numpy as np
import pytest
import torch

import small
from harness import arith

from repro_torch.serve import exec_registry, runtime


def unchanged(out, static):
    """The step returns the HARQ state it was handed: the prior as the
    combined buffer, no block decoded."""
    out["cw_llr"] = static["prior_llr"].clone()
    out["crc_ok"] = torch.zeros_like(out["crc_ok"])
    out["decode_iters"] = torch.zeros_like(out["decode_iters"])


def half_the_batch(out, static):
    """Half of each lane's slots left out: the first half's results
    stand for the rest."""
    for k in ("cw_llr", "crc_ok", "decode_iters"):
        b = out[k].shape[1]
        out[k] = out[k].clone()
        out[k][:, b - b // 2:] = out[k][:, : b // 2]


def one_answer_altered(out, static):
    """One slot's answer altered where it is produced: its combined LLRs
    negated."""
    out["cw_llr"] = out["cw_llr"].clone()
    out["cw_llr"][0, 0] = -out["cw_llr"][0, 0]


def one_verdict_altered(out, static):
    """One slot's first codeword's CRC verdict flipped where it is
    produced."""
    out["crc_ok"] = out["crc_ok"].clone()
    out["crc_ok"][0, 0, 0] = ~out["crc_ok"][0, 0, 0]


def prior_dropped(slot, job, jobs):
    """A retransmission staged without its HARQ prior."""
    slot["prior_llr"] = np.zeros_like(slot["prior_llr"])


def prior_doubled(slot, job, jobs):
    """A retransmission's prior combined twice."""
    slot["prior_llr"] = 2.0 * slot["prior_llr"]


def another_jobs_prior(slot, job, jobs):
    """A retransmission staged with the prior of the job last
    retransmitted before it."""
    if "last" in jobs and jobs["last"].shape == slot["prior_llr"].shape:
        slot["prior_llr"], jobs["last"] = jobs["last"], slot["prior_llr"]
    else:
        jobs["last"] = slot["prior_llr"]


STEP_FAULTS = [unchanged, half_the_batch, one_answer_altered,
               one_verdict_altered]
HARQ_FAULTS = [prior_dropped, prior_doubled, another_jobs_prior]


def _run(cell, monkeypatch, fault=None):
    if fault in STEP_FAULTS:
        replay = exec_registry.CapturedStep.replay

        def broken(self):
            out = replay(self)
            fault(out, self.static)
            return out
        monkeypatch.setattr(exec_registry.CapturedStep, "replay", broken)
    elif fault in HARQ_FAULTS:
        make_slot = runtime.CellLoop.make_slot
        jobs: dict = {}

        def broken(self, user, job, mcs):
            slot = make_slot(self, user, job, mcs)
            if job.harq.n_tx > 0:
                fault(slot, job, jobs)
            return slot
        monkeypatch.setattr(runtime.CellLoop, "make_slot", broken)
    driver = arith.load("drivers", cell.config["driver"])
    return driver.run(cell, seed=3_000_000_019, seconds=1.0, traced=False,
                      device="cpu", t_start=time.time())


@pytest.mark.parametrize("name", ["siso-classical", "siso-deeprx"])
def test_a_sound_run_is_correct(monkeypatch, name):
    run = _run(small.small_cell(name, monkeypatch), monkeypatch)
    assert run.verdict["correct"], run.verdict
    assert run.verdict["slots"] > run.verdict["jobs"] > 0  # retransmissions
    assert run.window["captures"] == 0
    assert run.notes["pool_calls"] > 0


@pytest.mark.parametrize("fault", STEP_FAULTS + HARQ_FAULTS,
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", ["siso-classical", "siso-deeprx"])
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    run = _run(small.small_cell(name, monkeypatch), monkeypatch, fault)
    assert not run.verdict["correct"], run.verdict
