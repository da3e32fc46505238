"""Port vs reference: the fused classical-receiver kernels' plain twins.

``ls_che`` and ``mmse_detect_demap`` on a CPU tensor run their plain
PyTorch twins; here those are held to the reference's jnp twins (its
numerical reference off-TPU) and, at one small shape each, to the Pallas
kernels in interpret mode, on the same inputs drawn with numpy.

Tolerances: LS CHE is one small complex GEMM in fp32, rtol 1e-5 / atol
1e-6.  Detect+demap runs a division-heavy elimination whose fp32 rounding
differs where XLA contracts multiply-adds: x_hat and nv_eff rtol 1e-4 /
atol 1e-5; LLR values rtol 1e-3 / atol 1e-5 of the largest |LLR| (the
max-log distances, ``scale`` and the ``max(ne*norm, 1e-6)`` division are
held by value, not only by sign), and LLR signs agree on at least 99.9% of
bits (borderline LLRs near zero may flip).  The CUDA kernels are checked
against these twins on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rx_fused as ref_rx
from repro.phy import ofdm as ref_ofdm
from repro_torch.kernels import rx_fused
from repro_torch.phy import ofdm
from _port_share import port_share  # noqa: F401

_SHAPES = [(1, 1), (2, 2), (4, 4), (8, 4)]
_MODEMS = ["qpsk", "qam16", "qam64", "qam256"]
# every modem at the shapes with compiled kernel instances, one each at
# shapes the kernels take by their runtime-sized route, and a 1024-QAM
# modem (5 bits per axis, no compiled instance) at SISO, 2x2 and 3x3
_DEMAP_CASES = [(r, t, m) for r, t in _SHAPES for m in _MODEMS] + [
    (2, 1, "qpsk"), (4, 2, "qam16"), (3, 3, "qam64"), (8, 6, "qam16"),
    (1, 1, "qam1024"), (2, 2, "qam1024"), (3, 3, "qam1024")]
_N_SC = 64
_PSYM = (2, 11)


@functools.lru_cache(maxsize=None)
def qam1024_modems() -> tuple:
    """(reference, port) 1024-QAM modems, built by hand in both packages
    the way ``qam256`` is: binary-reflected Gray over 32 amplitudes,
    ``levels[gray(k)] = 2k - 31``, norm ``2 (32^2 - 1) / 3 = 682``."""
    levels = [0.0] * 32
    for k in range(32):
        levels[k ^ (k >> 1)] = 2.0 * k - 31.0
    args = ("qam1024", 10, tuple(levels), 682.0)
    return ref_ofdm.Modem(*args), ofdm.Modem(*args)


def ref_modem(name: str):
    """The reference's registered modem, or the hand-built 1024-QAM one."""
    if name == "qam1024":
        return qam1024_modems()[0]
    return ref_ofdm.make_modem(name)


def port_modem(name: str):
    """The port's counterpart of :func:`ref_modem`."""
    if name == "qam1024":
        return qam1024_modems()[1]
    return ofdm.make_modem(name)


def _cgauss(rng, shape) -> np.ndarray:
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            / np.sqrt(2.0)).astype(np.complex64)


def _detect_inputs(n_rx, n_tx, modem_name, seed, b=1, n_sc=_N_SC,
                   snr_db=22.0):
    """y = H x + n on a (b, 14, n_sc) grid with H flat in time."""
    rng = np.random.default_rng(seed)
    modem = ref_modem(modem_name)
    h = _cgauss(rng, (b, n_sc, n_rx, n_tx))
    bits = rng.integers(0, 2, (b, 14, n_sc, n_tx, modem.bits_per_symbol))
    x = np.asarray(modem.mod(jnp.asarray(bits)))
    nv = np.float32(n_tx * 10.0 ** (-snr_db / 10.0))
    y = (np.einsum("bsrt,bmst->bmsr", h, x)
         + np.sqrt(nv) * _cgauss(rng, (b, 14, n_sc, n_rx))).astype(
             np.complex64)
    return y, h, nv


def _port_detect(y, h, nv, modem_name):
    out = rx_fused.mmse_detect_demap(
        torch.from_numpy(y), torch.from_numpy(h), torch.tensor(nv),
        port_modem(modem_name))
    return [o.numpy() for o in out]


def _assert_detect_close(got, want):
    x, nve, llr = got
    xr, nver, llrr = (np.asarray(a) for a in want)
    np.testing.assert_allclose(x, xr, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(nve, nver, rtol=1e-4, atol=1e-5)
    assert llr.shape == llrr.shape
    np.testing.assert_allclose(llr, llrr, rtol=1e-3,
                               atol=1e-5 * float(np.abs(llrr).max()))
    assert np.mean(np.sign(llr) == np.sign(llrr)) >= 0.999


@pytest.mark.parametrize("n_rx,n_tx,modem_name", _DEMAP_CASES)
def test_detect_demap_twin_matches_jnp(n_rx, n_tx, modem_name):
    y, h, nv = _detect_inputs(n_rx, n_tx, modem_name, seed=n_rx * 10 + n_tx)
    want = ref_rx.mmse_detect_demap_jnp(
        jnp.asarray(y), jnp.asarray(h), jnp.float32(nv),
        ref_modem(modem_name))
    _assert_detect_close(_port_detect(y, h, nv, modem_name), want)


def test_detect_demap_twin_matches_pallas_interpret():
    y, h, nv = _detect_inputs(2, 2, "qam16", seed=5, b=1)
    want = ref_rx.mmse_detect_demap_pallas(
        jnp.asarray(y), jnp.asarray(h), jnp.float32(nv),
        ref_ofdm.make_modem("qam16"), interpret=True)
    _assert_detect_close(_port_detect(y, h, nv, "qam16"), want)


def _ls_inputs(n_tx, n_rx, seed, b=2, n_sc=_N_SC, n_sym=14):
    rng = np.random.default_rng(seed)
    y = _cgauss(rng, (b, n_sym, n_sc, n_rx))
    g = ref_ofdm.GridConfig(n_subcarriers=n_sc, fft_size=n_sc, n_tx=n_tx,
                            n_rx=n_rx)
    seq = np.asarray(ref_ofdm.pilot_sequence(g))
    op = rx_fused.make_ls_interp_operator(n_sc, n_tx, g.pilot_stride, seq)
    return y, op, g.pilot_stride


@pytest.mark.parametrize("n_rx,n_tx", _SHAPES)
def test_ls_che_twin_matches_jnp(n_rx, n_tx):
    y, op, stride = _ls_inputs(n_tx, n_rx, seed=n_rx + 7 * n_tx, n_sc=256)
    got = rx_fused.ls_che(torch.from_numpy(y), _PSYM, stride,
                          torch.from_numpy(op)).numpy()
    want = np.asarray(ref_rx.ls_che_jnp(jnp.asarray(y), _PSYM, stride,
                                        jnp.asarray(op)))
    assert got.shape == want.shape == (2, 256, n_rx, n_tx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ls_che_twin_matches_jnp_past_symbol_31():
    """Pilot symbols at any index: a slot of 40 symbols with a pilot at
    symbol 35 (the CUDA wrapper hands the kernel a mask of n_sym bits) is
    held to the reference like any other."""
    psym = (3, 35)
    y, op, stride = _ls_inputs(2, 2, seed=35, n_sc=256, n_sym=40)
    got = rx_fused.ls_che(torch.from_numpy(y), psym, stride,
                          torch.from_numpy(op)).numpy()
    want = np.asarray(ref_rx.ls_che_jnp(jnp.asarray(y), psym, stride,
                                        jnp.asarray(op)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ls_che_twin_matches_pallas_interpret():
    y, op, stride = _ls_inputs(2, 2, seed=3)
    got = rx_fused.ls_che(torch.from_numpy(y), _PSYM, stride,
                          torch.from_numpy(op)).numpy()
    want = np.asarray(ref_rx.ls_che_pallas(
        jnp.asarray(y), _PSYM, stride, jnp.asarray(op), block_rows=2,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    y, h, nv = _detect_inputs(1, 1, "qpsk", seed=1, b=1)
    # a quantized precision runs on the CPU and returns LLRs on the grid
    *_, llr = rx_fused.mmse_detect_demap(
        torch.from_numpy(y), torch.from_numpy(h), torch.tensor(nv),
        ofdm.make_modem("qpsk"), precision="fp8")
    codes = llr.numpy() / np.float32(20.0 / 127.0)
    np.testing.assert_allclose(codes, np.rint(codes), atol=1e-3)
    assert np.abs(codes).max() <= 127 + 1e-3
    # a CPU tensor never reaches a kernel launch: the CUDA entry checks
    # device, dtype and layout before anything else
    with pytest.raises(ValueError, match="CUDA"):
        rx_fused.mmse_detect_demap_cuda(
            torch.from_numpy(y), torch.from_numpy(h), torch.tensor(nv),
            ofdm.make_modem("qpsk"))
    # any antenna shape and any bits per axis (1024-QAM: 5) reach the same
    # device check (no shape or modem cap)
    with pytest.raises(ValueError, match="CUDA"):
        rx_fused.mmse_detect_demap_cuda(
            torch.zeros(1, 14, 8, 3, dtype=torch.complex64),
            torch.zeros(1, 8, 3, 3, dtype=torch.complex64),
            torch.tensor(0.1), ofdm.make_modem("qpsk"))
    for entry in (rx_fused.mmse_detect_demap_cuda,
                  rx_fused.sic_detect_demap_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            entry(torch.zeros(1, 14, 8, 3, dtype=torch.complex64),
                  torch.zeros(1, 8, 3, 3, dtype=torch.complex64),
                  torch.tensor(0.1), port_modem("qam1024"))
    # SIC runs its plain twin on a CPU tensor, and its CUDA entry refuses
    # CPU tensors like the joint one's
    out = rx_fused.sic_detect_demap(torch.from_numpy(y), torch.from_numpy(h),
                                    torch.tensor(nv), ofdm.make_modem("qpsk"))
    assert [tuple(o.shape) for o in out] == [
        (1, 14, _N_SC, 1), (1, 14, _N_SC, 1), (1, 14, _N_SC, 1, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        rx_fused.sic_detect_demap_cuda(
            torch.from_numpy(y), torch.from_numpy(h), torch.tensor(nv),
            ofdm.make_modem("qpsk"))



# ---------------------------------------------------------------------------
# the port's unfused oracles (kernels/ref.py)
# ---------------------------------------------------------------------------

def _assert_llr_gate(llr, llrr):
    """The port's LLR gate: >= 99.9% sign agreement, values within rtol
    1e-3, atol 1e-5 of the largest |LLR|."""
    llr, llrr = np.asarray(llr), np.asarray(llrr)
    assert llr.shape == llrr.shape
    assert np.mean((llr > 0) == (llrr > 0)) >= 0.999
    np.testing.assert_allclose(llr, llrr, rtol=1e-3,
                               atol=1e-5 * float(np.abs(llrr).max()))


@pytest.mark.parametrize("n_rx,n_tx,modem_name,sic", [
    (1, 1, "qam16", False), (2, 2, "qam16", False), (8, 4, "qam64", False),
    (4, 4, "qam16", True), (2, 2, "qpsk", True), (8, 6, "qam16", True)])
def test_demap_oracles_match_reference_and_twins(n_rx, n_tx, modem_name,
                                                 sic):
    """``mmse_detect_demap_ref`` / ``sic_detect_demap_ref`` of the port
    (the linalg-solve detector and the modem's demapper, composed) equal
    the reference's on shared inputs, and the fused twins equal them, at
    the LLR gate (x_hat and nv_eff at the reference's own rtol 1e-3,
    atol 1e-4)."""
    from repro.kernels import ref as ref_ref
    from repro_torch.kernels import ref

    y, h, nv = _detect_inputs(n_rx, n_tx, modem_name, seed=40 + n_rx + n_tx,
                              b=1)
    fn, ref_fn, twin = (
        (ref.sic_detect_demap_ref, ref_ref.sic_detect_demap_ref,
         rx_fused.sic_detect_demap) if sic else
        (ref.mmse_detect_demap_ref, ref_ref.mmse_detect_demap_ref,
         rx_fused.mmse_detect_demap))
    args = (torch.from_numpy(y), torch.from_numpy(h), torch.tensor(nv),
            port_modem(modem_name))
    got = [o.numpy() for o in fn(*args)]
    want = [np.asarray(o) for o in ref_fn(
        jnp.asarray(y), jnp.asarray(h), jnp.float32(nv),
        ref_modem(modem_name))]
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)
    _assert_llr_gate(got[2], want[2])
    _assert_llr_gate(twin(*args)[2].numpy(), got[2])


@pytest.mark.parametrize("n_rx,n_tx", [(1, 1), (2, 2), (4, 4)])
def test_ls_che_oracle_matches_reference_and_twin(n_rx, n_tx):
    """``ls_che_ref`` (the staggered-comb LS + clamped interpolation) of
    the port equals the reference's on a shared grid, and the fused twin
    equals it, at rtol 1e-4."""
    from repro.kernels import ref as ref_ref
    from repro_torch.kernels import ref

    y, op, stride = _ls_inputs(n_tx, n_rx, seed=60 + n_rx, n_sc=256)
    g = ref_ofdm.GridConfig(n_subcarriers=256, fft_size=256, n_tx=n_tx,
                            n_rx=n_rx)
    seq = np.array(ref_ofdm.pilot_sequence(g))
    masks = ref_ofdm.link_pilot_masks_np(g)
    got = ref.ls_che_ref(torch.from_numpy(y), torch.from_numpy(seq),
                         torch.from_numpy(masks), stride).numpy()
    want = np.asarray(ref_ref.ls_che_ref(jnp.asarray(y), jnp.asarray(seq),
                                         jnp.asarray(masks), stride))
    assert got.shape == want.shape == (2, 256, n_rx, n_tx)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))
    twin = rx_fused.ls_che(torch.from_numpy(y), g.pilot_symbols, stride,
                           torch.from_numpy(op)).numpy()
    np.testing.assert_allclose(twin, got, rtol=1e-4,
                               atol=1e-5 * float(np.abs(got).max()))
