"""Port vs reference: the quantization core (``kernels/quant.py``).

Every function is held to :mod:`repro.kernels.quant`, called eagerly, on
the same numpy-drawn inputs, and must agree exactly: precision names and
storage dtypes, int8 codes and fp8 (e4m3) codes, scales, dequantized and
fake-quantized values, the fixed LLR grid (including round-half-to-even
and saturation at +-``LLR_CLIP``), ``sat8`` and ``scale_q8``.  (Under
``jax.jit`` XLA turns the LLR grid's division by the constant step into a
multiply by its reciprocal, which can move a value sitting on a half step
by one code; the pipeline tests allow for that, these eager calls do not
need to.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant as ref_quant
from repro_torch.kernels import quant
from _port_share import port_share  # noqa: F401

_AXES = [None, 0, -1, (0, 2)]


def _x(seed: int, shape=(6, 5, 33), scale=3.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _np(t) -> np.ndarray:
    """A torch or jax array as numpy float32 (fp8 codes by value)."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("p", list(quant.PRECISIONS) + [None, "e4m3",
                                                         "float16"])
def test_precision_registry_matches_reference(p):
    assert quant.resolve_precision(p) == ref_quant.resolve_precision(p)
    assert quant.is_quantized(p) == ref_quant.is_quantized(p)
    assert quant.itemsize(p) == ref_quant.itemsize(p)
    dt, ref_dt = quant.storage_dtype(p), ref_quant.storage_dtype(p)
    assert quant.dtype_name(dt) == ref_quant.dtype_name(ref_dt)
    assert quant.precision_of_dtype(dt) == \
        ref_quant.precision_of_dtype(ref_dt)
    with pytest.raises(ValueError):
        quant.resolve_precision("int4")


@pytest.mark.parametrize("axis", _AXES, ids=str)
@pytest.mark.parametrize("p", ["int8", "fp8"])
def test_quantize_matches_reference(p, axis):
    x = _x(1)
    q, s = quant.quantize(torch.from_numpy(x), p, axis=axis)
    q_r, s_r = ref_quant.quantize(jnp.asarray(x), p, axis=axis)
    assert q.dtype == quant.storage_dtype(p)
    assert quant.dtype_name(q.dtype) == ref_quant.dtype_name(q_r.dtype)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(_np(q), _np(q_r))
    np.testing.assert_array_equal(
        quant.dequantize(q, s).numpy(),
        np.asarray(ref_quant.dequantize(q_r, s_r)))


@pytest.mark.parametrize("p", quant.PRECISIONS)
def test_fake_quant_matches_reference(p):
    x = _x(2)
    x[0, 0] = 0.0  # an all-zero slice keeps a finite scale
    x[1] = 0.0
    got = quant.fake_quant(torch.from_numpy(x), p, axis=(1, 2))
    want = ref_quant.fake_quant(jnp.asarray(x), p, axis=(1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llr_grid_matches_reference():
    rng = np.random.default_rng(3)
    # inside the grid, beyond the clip, and values on exact grid codes
    llr = np.concatenate([
        (8.0 * rng.standard_normal(4000)).astype(np.float32),
        np.float32([-1e3, -20.0, -19.99, 19.99, 20.0, 31.0, 1e3, 0.0]),
        (np.arange(-127, 128, dtype=np.float32)
         * np.float32(quant.llr_scale())),
    ])
    assert quant.llr_scale() == ref_quant.llr_scale()
    q, s = quant.quantize_llr(torch.from_numpy(llr))
    q_r, s_r = ref_quant.quantize_llr(jnp.asarray(llr))
    assert q.dtype == torch.int8 and float(s) == float(s_r)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    assert int(q.max()) == 127 and int(q.min()) == -127
    np.testing.assert_array_equal(
        quant.dequantize_llr(q, s).numpy(),
        np.asarray(ref_quant.dequantize_llr(q_r, s_r)))
    for p in quant.PRECISIONS:
        np.testing.assert_array_equal(
            quant.fake_quant_llr(torch.from_numpy(llr), p).numpy(),
            np.asarray(ref_quant.fake_quant_llr(jnp.asarray(llr), p)))


def test_llr_grid_rounds_half_to_even():
    # clip 127 makes the step exactly 1, so these sit on half steps
    llr = np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 300.0])
    q, _ = quant.quantize_llr(torch.from_numpy(llr), clip=127.0)
    q_r, _ = ref_quant.quantize_llr(jnp.asarray(llr), clip=127.0)
    np.testing.assert_array_equal(q.numpy(), [0, 2, 2, 0, -2, -2, 126, 127])
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))


def test_saturating_integer_helpers_match_reference():
    x = np.arange(-3000, 3001, 7, dtype=np.int32)
    np.testing.assert_array_equal(
        quant.sat8(torch.from_numpy(x)).numpy(),
        np.asarray(ref_quant.sat8(jnp.asarray(x))))
    mag = np.abs(x)
    for factor in (0.8, 0.5, 0.75, 0.9):
        np.testing.assert_array_equal(
            quant.scale_q8(torch.from_numpy(mag), factor).numpy(),
            np.asarray(ref_quant.scale_q8(jnp.asarray(mag), factor)))
    assert quant.q8_factor(0.8) == 205


def test_divisions_are_true_divisions():
    # a Python-scalar divisor would be a reciprocal multiply on the card;
    # true_div divides by a tensor on the operand's device instead
    x = torch.from_numpy(_x(4, (5000,), 30.0))
    step = quant.llr_scale()
    np.testing.assert_array_equal(
        quant.true_div(x, step).numpy(),
        x.numpy() / np.float32(step))
