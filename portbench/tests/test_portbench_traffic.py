"""The benchmark's traffic on the CPU at a shrunk grid: the frozen
generator against the port's, the pools' retransmissions, and the
factory's payload mapping through the port's closed loop."""
import numpy as np
import pytest
import torch

import small  # noqa: F401  (puts portbench and src on the path)
from harness import generator, spec
from harness.traffic import SlotPools, pool_key

from repro_torch.phy import coding, scenarios
from repro_torch.serve.runtime import CellLoop, TickStats


@pytest.fixture
def cell(monkeypatch):
    return small.small_cell("siso-classical", monkeypatch)


@pytest.mark.parametrize("rv,given", [(None, False), (0, False), (1, True),
                                      (2, True)])
def test_frozen_generator_draws_the_ports_slots(cell, rv, given):
    for rung in cell.rungs:
        port = scenarios.get_scenario(rung.name).replace(snr_db=9.5)
        ours = rung.replace(snr_db=9.5)
        info = None
        if given:
            g = torch.Generator().manual_seed(3)
            info = torch.randint(0, 2, (3, ours.codewords_per_slot,
                                        ours.code.k_info), generator=g,
                                 dtype=torch.int32)
        want = coding.make_coded_slot(torch.Generator().manual_seed(11),
                                      port, 3, rv=rv, info=info)
        got = generator.make_coded_slot(torch.Generator().manual_seed(11),
                                        ours, 3, rv=rv, info=info)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), (rung.name, k)


def _tx_bits(rung, slot) -> torch.Tensor:
    """The codeword bits a slot carries on its data REs (filler cut)."""
    sym, sc = spec.data_re_index(rung.grid)
    flat = slot["bits"][:, sym, sc].reshape(slot["bits"].shape[0], -1)
    c, e = rung.codewords_per_slot, rung.code.e_bits
    return flat[:, : c * e].reshape(-1, c, e)


def test_a_retransmission_carries_its_payload_at_the_asked_rv(cell):
    pools = SlotPools(cell, seed=5, device="cpu", n_payloads=4)
    rung = cell.rungs[1]
    scn = scenarios.get_scenario(rung.name).replace(snr_db=9.5)
    first = pools(123456, scn, 1, rv=0)
    assert (pools.locate(first)) == (pool_key(1, 9.5, (), 0), 123456 % 4)
    for rv in (1, 2):
        again = pools(99, scn, 1, rv=rv, info=first["info_bits"])
        assert torch.equal(again["info_bits"], first["info_bits"])
        assert again["rv"].tolist() == [rv]
        code = rung.code
        crc = torch.cat([first["info_bits"],
                         generator.crc_of(first["info_bits"],
                                          code.crc_bits)], -1)
        want = generator.rate_match(code, generator.encode(code, crc), rv)
        assert torch.equal(_tx_bits(rung, again), want)
        # a channel of its own: not the first transmission's
        assert not torch.equal(again["h"], first["h"])
    with pytest.raises(KeyError):
        pools(1, scn.replace(snr_db=12.25), 1, rv=0)
    with pytest.raises(ValueError):
        pools(1, scn, 2, rv=0)


def test_the_payload_mapping_survives_a_harq_round_trip(cell):
    pools = SlotPools(cell, seed=8, device="cpu", n_payloads=4)
    rungs = [scenarios.get_scenario(r.name) for r in cell.rungs]
    loop = CellLoop(rungs, rng=np.random.default_rng(1), n_users=1,
                    batch_size=1, snr_db=8.0, slot_factory=pools,
                    device="cpu", adapt=False)
    user = loop.users[0]
    loop.inject_backlog(1)
    job = user.backlog.popleft()
    first = loop.make_slot(user, job, 0)
    key0, p = pools.locate(first)
    assert pools.origin(job.harq.info) == (key0, p)
    n_cw = coding.codewords_per_slot(rungs[0])
    for rv in (1, 2):
        loop.serve_feedback(user, job, 0, np.zeros(n_cw, bool),
                            np.ones((1, n_cw, rungs[0].code.n_mother),
                                    np.float32) * rv, TickStats(0))
        job = user.backlog.popleft()
        again = loop.make_slot(user, job, 0)
        assert pools.locate(again) == (key0[:3] + (rv,), p)
        assert torch.equal(again["info_bits"], first["info_bits"])
        assert float(again["prior_llr"].max()) == rv
