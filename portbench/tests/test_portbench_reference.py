"""The frozen plain references against the port's plain twins on the CPU
at a shrunk grid, on HARQ batches (a prior, a redundancy version a
slot), and their controls."""
import pytest
import torch

import small  # noqa: F401  (puts portbench and src on the path)
from harness import chain, arith, generator

from repro_torch.phy import link, scenarios


def _batch(rung, n: int, seed: int) -> tuple:
    """``n`` slots at two SNRs and mixed RVs, with random priors: the
    reference's batch and the port's."""
    slots = [generator.make_coded_slot(
        torch.Generator().manual_seed(seed + i),
        rung.replace(snr_db=rung.snr_db + 2.0 * (i % 2)), 1, rv=i % 3)
        for i in range(n)]
    g = torch.Generator().manual_seed(seed)
    prior = torch.randn(n, rung.codewords_per_slot, rung.code.n_mother,
                        generator=g) * 2.0
    ref = {"y_time": torch.cat([s["y_time"] for s in slots]),
           "noise_var": torch.stack([s["noise_var"] for s in slots]),
           "rv": torch.cat([s["rv"] for s in slots]),
           "prior_llr": prior}
    return slots, ref


def _port(pipe, slots, ref) -> dict:
    """The port's pipeline slot by slot (one noise value a call)."""
    outs = []
    for i, s in enumerate(slots):
        b = dict(s)
        b["prior_llr"] = ref["prior_llr"][i:i + 1]
        outs.append(pipe.run(b))
    return {k: torch.cat([o[k] for o in outs]) for k in ("cw_llr", "crc_ok")}


@pytest.mark.parametrize("name,receiver,kw", [
    ("siso-classical", "classical", {"fused": False}),
    ("siso-deeprx", "deeprx", {"seed": 0}),
])
def test_the_reference_matches_the_ports_plain_twins(monkeypatch, name,
                                                     receiver, kw):
    cell = small.small_cell(name, monkeypatch)
    ref = arith.load("reference", cell.config["reference"])
    for rung in cell.rungs:
        pipe = link.build_pipeline(receiver, scenarios.get_scenario(
            rung.name), device="cpu", **kw)
        slots, batch = _batch(rung, 4, 21)
        want = _port(pipe, slots, batch)
        got = ref.receive(cell, rung, batch)
        assert torch.equal(got["crc_ok"], want["crc_ok"])
        scale = want["cw_llr"].abs().max()
        assert float((got["cw_llr"] - want["cw_llr"]).abs().max()) \
            <= 1e-5 * float(scale)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0 - 2.0 ** -9,
                      1.0 + 2.0 ** -11 + 2.0 ** -20])
    assert chain.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0,
                                      -3.0 - 2.0 ** -9, 1.0 + 2.0 ** -10]
    z = torch.complex(x, -x)
    assert torch.equal(chain.tf32(z), torch.complex(chain.tf32(x),
                                                    chain.tf32(-x)))


def test_the_tf32_control_leaves_the_llr_limit(monkeypatch):
    """The classical control, the Wiener operator's and the detector's
    products with TF32 operands, reads above the configuration's
    ``llr_gap`` limit (DeepRx's TF32 control is read on the card,
    ``test_portbench_cuda.py``)."""
    cell = small.small_cell("siso-classical", monkeypatch)
    ref = arith.load("reference", cell.config["reference"])
    for rung in cell.rungs:
        _, batch = _batch(rung, 4, 5)
        want = ref.receive(cell, rung, batch)
        low = ref.receive(cell, rung, batch, lower=True)
        w = want["cw_llr"].reshape(4, -1)
        gap = ((low["cw_llr"].reshape(4, -1) - w).abs().amax(1)
               / w.abs().amax(1)).max()
        assert float(gap) > cell.config["correctness"]["limits"]["llr_gap"]
