"""Port vs reference: the classical receiver end to end.

``build_classical(fused=True)`` and ``build_classical(fused=False)`` of
both packages receive the same JAX-drawn coded slots (the port gets them
through ``slot_from_numpy``) for each ``siso-coded`` rung at the
registered grid and for the 2x2 rung; the port runs on the CPU, where its
kernel wrappers take their plain twins.

Gates (the reference's own, ROADMAP port conventions): CRC flags and
per-codeword iteration counts equal, decoded payloads equal on every
codeword whose CRC passes, and the port's decoder, fed the reference's own
combined codeword LLRs (``cw_llr``), gives the reference's hard bits and
iteration counts on every codeword, the non-converged ones included (a
tolerated LLR difference may move the hard bits of a codeword that never
converges, and the CPU receiver's reduction order depends on the thread
count, so the payloads of failed codewords are held through the decoder
instead of through the receiver); at most 2 hard LLR flips
per pipeline (borderline LLRs near zero) and LLR values within rtol 1e-3 /
atol 1e-5 of the largest |LLR|; channel estimates within rtol 1e-4 (the
Wiener smoother's 256x256 solve rounds in another order); TTI and energy
reports equal.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.phy import coding as ref_coding
from repro.phy import link as ref_link
from repro.phy import scenarios as ref_scn
from repro_torch.kernels import ldpc
from repro_torch.phy import coding, link, ofdm, scenarios
from _port_share import port_share  # noqa: F401

_NAMES = ["siso-qpsk-r12-snr8", "siso-qam16-r12-snr15",
          "siso-qam16-r34-snr18", "mimo2x2-qam16-r12-snr17"]


# slot keys with a leading batch axis; the rest (masks, pilot sequence,
# noise_var) are shared by the whole batch
_PER_SLOT = ("bits", "h", "info_bits", "x", "y", "y_time")


@functools.lru_cache(maxsize=None)
def _draw_one(name: str):
    """The reference's generator for one slot of ``name``, jitted: one
    compile per scenario instead of hundreds of eager op compiles, shared
    by every batch size."""
    scn = ref_scn.get_scenario(name)
    # warm the reference's cached data-RE index eagerly so tracing does
    # not capture it
    ref_coding._data_re_index(scn.grid)
    return jax.jit(lambda key: ref_coding.make_coded_slot(key, scn, 1))


def jax_slots(name: str, batch: int, seed: int) -> dict:
    """``batch`` JAX-drawn coded slots of ``name`` (keys ``seed``,
    ``seed + 1``, ...) stacked into one batch of numpy values."""
    draw = _draw_one(name)
    slots = [{k: np.asarray(v) for k, v in
              draw(jax.random.PRNGKey(seed + i)).items()}
             for i in range(batch)]
    out = dict(slots[0])
    for k in _PER_SLOT:
        out[k] = np.concatenate([s[k] for s in slots])
    return out


def assert_decode_matches_reference(name: str, got: dict, want: dict):
    """The receiver: CRC flags and iteration counts equal, payloads equal
    on every codeword whose CRC passes.  The decoder: the reference's own
    ``cw_llr`` through the port's LDPC decoder and CRC check reproduces
    the reference's payload bits, CRC flags and iteration counts on every
    codeword, converged or not."""
    assert np.array_equal(got["crc_ok"], want["crc_ok"])
    assert np.array_equal(got["decode_iters"], want["decode_iters"])
    ok = want["crc_ok"].astype(bool)
    assert np.array_equal(got["info_bits_hat"][ok], want["info_bits_hat"][ok])

    code = scenarios.get_scenario(name).code
    b, c, n = want["cw_llr"].shape
    post, iters = ldpc.ldpc_decode(
        torch.tensor(want["cw_llr"]).reshape(b * c, n), code)
    hard = (post[:, : code.k] > 0).to(torch.int32)
    assert np.array_equal(
        hard[:, : code.k_info].reshape(b, c, -1).numpy(),
        want["info_bits_hat"])
    assert np.array_equal(
        coding.crc_check(hard, code.crc_bits).reshape(b, c).numpy(),
        want["crc_ok"])
    assert np.array_equal(iters.reshape(b, c).numpy(), want["decode_iters"])


@pytest.fixture(scope="module")
def slots():
    """One JAX-drawn batch-2 coded slot per scenario."""
    return {name: jax_slots(name, 2, 17 + i)
            for i, name in enumerate(_NAMES)}


@pytest.fixture(scope="module")
def runs(slots):
    """Memoized (ref pipeline, port pipeline, ref state, port state) per
    (scenario, fused): each reference pipeline compiles once."""
    memo = {}

    def run(name, fused):
        if (name, fused) not in memo:
            ref_p = ref_link.build_classical(ref_scn.get_scenario(name),
                                             fused=fused)
            port_p = link.build_classical(scenarios.get_scenario(name),
                                          fused=fused, device="cpu")
            slot = slots[name]
            memo[name, fused] = (
                ref_p, port_p, ref_p.run(slot),
                port_p.run(ofdm.slot_from_numpy(slot, "cpu")),
            )
        return memo[name, fused]

    return run


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", _NAMES)
def test_pipeline_matches_reference(runs, name, fused):
    ref_p, port_p, ref_state, port_state = runs(name, fused)
    assert port_p.name == ref_p.name
    want = {k: np.asarray(v) for k, v in ref_state.items()}
    got = {k: v.numpy() for k, v in port_state.items()}

    assert_decode_matches_reference(name, got, want)
    assert got["llr"].shape == want["llr"].shape
    assert int(np.sum((got["llr"] > 0) != (want["llr"] > 0))) <= 2
    np.testing.assert_allclose(got["llr"], want["llr"], rtol=1e-3,
                               atol=1e-5 * float(np.abs(want["llr"]).max()))
    # rtol 1e-4; the atol covers deep-fade taps (|h| << 1), where the
    # smoother solve's absolute rounding (~1e-6 of max |h|) dominates
    np.testing.assert_allclose(got["h_hat"], want["h_hat"], rtol=1e-4,
                               atol=1e-5)

    assert port_p.tti_report(batch=8) == ref_p.tti_report(batch=8)
    assert dataclasses.asdict(port_p.energy_report()) == \
        dataclasses.asdict(ref_p.energy_report())
    assert {k: dataclasses.asdict(v) for k, v in
            port_p.stage_cycles().items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_p.stage_cycles().items()}


def test_slot_metrics_match_reference(runs):
    name = "siso-qam16-r12-snr15"
    _, _, ref_state, port_state = runs(name, True)
    want = ref_link.slot_metrics(ref_state, ref_scn.get_scenario(name),
                                 per_slot=True)
    got = link.slot_metrics(port_state, scenarios.get_scenario(name),
                            per_slot=True)
    assert sorted(got) == sorted(want)
    for k in ("bler", "decode_iters", "ber"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("che_mse", "evm"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3)
