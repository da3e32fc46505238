"""The port's hand-written CUDA kernels against their plain PyTorch twins,
on the card.  Every test here is marked ``cuda`` and skips without one.

This file imports neither JAX nor the reference package, so it also runs
on a machine that has only PyTorch (``tests/conftest.py`` imports JAX, so
there it runs without the conftest):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.kernels import _build, ldpc, rx_fused
from repro_torch.phy import coding, ofdm, scenarios

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["siso-qam16-r12-snr15",
                                  "mimo2x2-qam16-r12-snr17",
                                  "mimo4x8-qam64-snr24",
                                  "siso-qam256-r34-snr28"])
def test_rx_kernels_match_twins(dev, name):
    scn = scenarios.get_scenario(name)
    g = scn.grid
    slot = scn.make_batch(ofdm.make_generator(4, dev), 4)
    y = torch.fft.fft(slot["y_time"], dim=2).contiguous()
    op = torch.from_numpy(rx_fused.make_ls_interp_operator(
        g.n_subcarriers, g.n_tx, g.pilot_stride,
        ofdm.pilot_sequence_np(g))).to(dev)
    n0 = _build.launches["ls_che"]
    h = rx_fused.ls_che(y, g.pilot_symbols, g.pilot_stride, op)
    assert _build.launches["ls_che"] == n0 + 1
    h_t = rx_fused.ls_che_torch(y, g.pilot_symbols, g.pilot_stride, op)
    torch.testing.assert_close(h, h_t, rtol=1e-5, atol=1e-6)

    args = (y, slot["h"][:, 0].contiguous(), slot["noise_var"], scn.modem)
    x, nve, llr = rx_fused.mmse_detect_demap(*args)
    x_t, nve_t, llr_t = rx_fused.mmse_detect_demap_torch(*args)
    torch.testing.assert_close(x, x_t, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(nve, nve_t, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(llr, llr_t, rtol=1e-5, atol=1e-5)
    assert float((torch.sign(llr) == torch.sign(llr_t)).float().mean()) \
        >= 0.999


@pytest.mark.parametrize("rate,snr_db", [("r12", 3.0), ("r12", -6.0),
                                         ("r34", 6.0), ("r34", -6.0)])
def test_ldpc_kernel_matches_twin_exactly(dev, rate, snr_db):
    code = coding.make_code(rate)
    gen = ofdm.make_generator(7, dev)
    bits = torch.randint(0, 2, (216, code.k), generator=gen, device=dev)
    tx = coding.rate_match(code, coding.encode(code, bits)).float()
    s2 = 10.0 ** (-snr_db / 10.0)
    y = (2 * tx - 1) + math.sqrt(s2) * torch.randn(tx.shape, generator=gen,
                                                   device=dev)
    llr = coding.derate_match(code, 2.0 * y / s2).contiguous()
    post, iters = ldpc.ldpc_decode(llr, code)
    post_t, iters_t = ldpc.ldpc_decode_torch(llr, code)
    assert torch.equal(iters, iters_t)
    assert torch.equal(post > 0, post_t > 0)
    torch.testing.assert_close(post, post_t, rtol=0, atol=1e-4)


def test_wrappers_reject_bad_inputs_on_card(dev):
    code = coding.make_code("r12")
    with pytest.raises(TypeError):
        ldpc.ldpc_decode(torch.zeros(2, code.n_mother, dtype=torch.float64,
                                     device=dev), code)
    y = torch.zeros(1, 14, 256, 1, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="operator"):
        rx_fused.ls_che(y, (2, 11), 4, torch.zeros(
            1, 32, 256, dtype=torch.complex64, device=dev))
