"""Port vs reference: the uncoded grid and its oracle helpers.

* Static geometry, byte for byte: ``pilot_mask``, the slot's ``pilots``
  and ``dense_parity_matrix`` of the registered codes.
* Modem: ``qam16_mod`` / ``qam16_demod_llr`` on shared bits and symbols.
* Estimation and detection on JAX-drawn slots: ``ls_channel_estimate``
  (rtol 1e-5) and ``mimo_mmse_detect`` (rtol 1e-4: small complex solves
  in LAPACK and XLA round differently).
* CFFT: ``cfft_radix2`` and ``cfft_auto(prefer_butterfly=True)`` at the
  reference's own gate, rtol 1e-4 / atol 1e-3, on every axis.
* The port's own slot draws (a ``torch.Generator`` cannot replay
  ``jax.random``), held statistically: channel power, the noise variance
  of ``y - x h``, data REs equal to ``qam16_mod(bits)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.phy import classical as ref_classical
from repro.phy import coding as ref_coding
from repro.phy import ofdm as ref_ofdm
from repro_torch.phy import classical, coding, ofdm
from _port_share import port_share  # noqa: F401

KEY = jax.random.PRNGKey(0)
GRID = dict(n_subcarriers=64, fft_size=64, pilot_stride=4)
# the reference under jit: one compile a shape, not one an eager op
_ref_slot = jax.jit(ref_ofdm.make_slot, static_argnums=(1, 2, 3))
_ref_mimo_slot = jax.jit(ref_ofdm.make_mimo_slot, static_argnums=(1, 2, 3))
_ref_ls = jax.jit(ref_classical.ls_channel_estimate, static_argnums=3)
_ref_cfft_auto = jax.jit(ref_classical.cfft_auto, static_argnums=(1, 2))


def _grids(**kw):
    return ref_ofdm.GridConfig(**kw), ofdm.GridConfig(**kw)


def _numpy(slot):
    return {k: np.asarray(v) for k, v in slot.items()}


@pytest.mark.parametrize("kw", [GRID, dict(n_subcarriers=128, fft_size=128,
                                           pilot_stride=4),
                                dict(n_subcarriers=60, fft_size=64,
                                     pilot_stride=3, pilot_symbols=(0, 7))])
def test_pilot_mask_and_pilots_identical(kw):
    rg, pg = _grids(**kw)
    want = np.asarray(ref_ofdm.pilot_mask(rg))
    got = ofdm.pilot_mask(pg, "cpu").numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # make_slot's pilots are pilot_sequence's expression; eager, as here,
    # they are its bytes (under jit XLA's exp may round one ulp away)
    ref_pilots = np.asarray(ref_ofdm.pilot_sequence(rg))
    pilots = ofdm.make_slot(ofdm.make_generator(0, "cpu"), pg, 1,
                            0.0)["pilots"].numpy()
    assert pilots.dtype == ref_pilots.dtype
    assert pilots.tobytes() == ref_pilots.tobytes()
    np.testing.assert_allclose(
        pilots, np.asarray(_ref_slot(KEY, rg, 1, 0.0)["pilots"]), rtol=1e-6)


@pytest.mark.parametrize("rate", ["r12", "r34"])
def test_dense_parity_matrix_identical(rate):
    want = ref_coding.dense_parity_matrix(ref_coding.make_code(rate))
    got = coding.dense_parity_matrix(coding.make_code(rate))
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_qam16_mod_and_llrs_agree():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (512, 4)).astype(np.int32)
    s_ref = np.asarray(ref_ofdm.qam16_mod(jnp.asarray(bits)))
    s = ofdm.qam16_mod(torch.from_numpy(bits)).numpy()
    assert s.dtype == s_ref.dtype
    np.testing.assert_allclose(s, s_ref, rtol=1e-6, atol=0)
    y = (s_ref + 0.3 * (rng.standard_normal(512)
                        + 1j * rng.standard_normal(512))).astype(np.complex64)
    for nv in (0.01, 0.5):
        want = np.asarray(ref_ofdm.qam16_demod_llr(
            jnp.asarray(y), jnp.asarray(nv, jnp.float32)))
        got = ofdm.qam16_demod_llr(torch.from_numpy(y),
                                   torch.tensor(nv)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    llr = ofdm.qam16_demod_llr(torch.from_numpy(s), torch.tensor(0.01))
    assert torch.equal((llr > 0).to(torch.int32), torch.from_numpy(bits))


@pytest.mark.parametrize("snr_db", [0.0, 8.0])
def test_ls_channel_estimate_matches_reference(snr_db):
    rg, pg = _grids(**GRID)
    slot = _ref_slot(KEY, rg, 8, snr_db)
    want = _ref_ls(slot["y"], slot["pilots"], slot["pilot_mask"],
                   rg.pilot_stride)
    ps = ofdm.slot_from_numpy(_numpy(slot), "cpu")
    got = classical.ls_channel_estimate(ps["y"], ps["pilots"],
                                        ps["pilot_mask"], pg.pilot_stride)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_mimo_mmse_detect_matches_reference():
    rg, _ = _grids(**GRID, n_tx=4, n_rx=8)
    slot = _ref_mimo_slot(KEY, rg, 4, 18.0)
    want = np.asarray(jax.jit(ref_classical.mimo_mmse_detect)(
        slot["y"], slot["h"], slot["noise_var"]))
    ps = ofdm.slot_from_numpy(_numpy(slot), "cpu")
    got = classical.mimo_mmse_detect(ps["y"], ps["h"], ps["noise_var"])
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,axis", [((4, 128), -1), ((4, 128), 1),
                                        ((16, 3, 5), 0), ((2, 32, 3), 1)])
def test_cfft_butterflies_match_reference(shape, axis):
    rng = np.random.default_rng(len(shape) + axis)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want = np.asarray(_ref_cfft_auto(jnp.asarray(x), axis, True))
    got = classical.cfft_auto(torch.from_numpy(x), axis=axis,
                              prefer_butterfly=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(classical.cfft(torch.from_numpy(x),
                                              axis=axis).numpy(),
                               np.fft.fft(x, axis=axis), rtol=1e-4,
                               atol=1e-3)
    if axis in (-1, len(shape) - 1):  # the reference's own call
        np.testing.assert_allclose(
            classical.cfft_radix2(torch.from_numpy(x)).numpy(), want,
            rtol=1e-4, atol=1e-3)


def test_cfft_auto_other_lengths_and_radix2_refusal():
    x = torch.randn(3, 12, dtype=torch.complex64)
    torch.testing.assert_close(classical.cfft_auto(x, prefer_butterfly=True),
                               torch.fft.fft(x))
    with pytest.raises(ValueError, match="power-of-two"):
        classical.cfft_radix2(x)


def test_make_slot_statistics():
    """The port's own draw: keys, shapes and dtypes as the reference's;
    unit channel power, the noise variance of y - x h, data REs equal
    to qam16_mod(bits) and pilots on the mask."""
    rg, pg = _grids(**GRID)
    ref = _ref_slot(KEY, rg, 2, 3.0)
    slot = ofdm.make_slot(ofdm.make_generator(1, "cpu"), pg, 256, 3.0)
    assert set(slot) == set(ref)
    for k, v in ref.items():
        assert tuple(slot[k].shape[1:]) == tuple(v.shape[1:]), k
        assert str(slot[k].dtype).split(".")[-1] == str(v.dtype), k
    nv = float(slot["noise_var"])
    assert nv == pytest.approx(10 ** -0.3, rel=1e-6)
    assert float(torch.mean(torch.abs(slot["h"]) ** 2)) == pytest.approx(
        1.0, rel=0.05)
    resid = slot["y"] - slot["x"] * slot["h"][:, None, :]
    assert float(torch.mean(torch.abs(resid) ** 2)) == pytest.approx(
        nv, rel=0.02)
    pm = slot["pilot_mask"]
    data = ofdm.qam16_mod(slot["bits"])
    assert torch.equal(slot["x"][:, ~pm], data[:, ~pm])
    assert torch.equal(slot["x"][:, pm],
                       slot["pilots"].expand(pm.shape)[pm].expand(256, -1))


def test_make_mimo_slot_statistics():
    rg, pg = _grids(**GRID, n_tx=4, n_rx=8)
    ref = _ref_mimo_slot(KEY, rg, 2, 18.0)
    slot = ofdm.make_mimo_slot(ofdm.make_generator(2, "cpu"), pg, 64, 18.0)
    assert set(slot) == set(ref)
    for k, v in ref.items():
        assert tuple(slot[k].shape[1:]) == tuple(v.shape[1:]), k
        assert str(slot[k].dtype).split(".")[-1] == str(v.dtype), k
    nv = float(slot["noise_var"])
    assert nv == pytest.approx(4 * 10 ** -1.8, rel=1e-6)
    assert float(torch.mean(torch.abs(slot["h"]) ** 2)) == pytest.approx(
        1.0, rel=0.05)
    resid = slot["y"] - torch.einsum("bsrt,bst->bsr", slot["h"], slot["x"])
    assert float(torch.mean(torch.abs(resid) ** 2)) == pytest.approx(
        nv, rel=0.05)
    assert torch.equal(slot["x"], ofdm.qam16_mod(slot["bits"]))
    # MMSE detection recovers the symbols, as the reference's test gates
    xhat = classical.mimo_mmse_detect(slot["y"], slot["h"],
                                      slot["noise_var"])
    assert float(torch.mean(torch.abs(xhat - slot["x"]) ** 2)) < 0.1
