"""Port vs reference: the quantized TE GEMM and the quantized flash MHA
(kernel rows 7 and 9), at the reference's own test shapes and gates
(``tests/test_precision.py``).

Each is checked in two parts, as the reference splits it (quantize, then
the ``pallas_call`` on the codes):

* **Kernel level.**  The reference's own codes and scales
  (``quantize_gemm_operands`` / ``quantize_mha_operands``, eager) go
  through the port's function on codes (``te_gemm_quantized`` /
  ``mha_quantized``, the plain twin on the CPU) and are held to the
  reference's Pallas kernel in interpret mode: rtol 1e-5, atol 1e-5.
* **Quantization.**  The port's codes and scales equal the reference's
  eager ones exactly.  Under ``jax.jit`` (as ``repro.kernels.ops`` runs
  it) XLA divides by the reciprocal of the scale, so its scales may sit
  one ulp off and a code on a rounding boundary may move by one step: the
  jitted scales are held to 1 ulp and each differing code to such a
  straddle.

The public wrappers ``ops.te_gemm_quant`` / ``ops.mha_quant`` are then
held to the reference's jitted ``ops`` at the kernel gate on every output
that no straddling code feeds.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import mha as ref_mha
from repro.kernels import ops as ref_ops
from repro.kernels import te_gemm as ref_te
from repro_torch.kernels import mha, ops, quant, te_gemm
from _port_share import port_share  # noqa: F401

_PRECISIONS = ["int8", "fp8"]
_EPILOGUES = [("none", False), ("relu", True), ("softmax", False)]


def _to_torch(a) -> torch.Tensor:
    """A reference array (int8, float8_e4m3fn or float32) as a torch
    tensor of the same values and type."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.astype(np.float32)).to(quant.FP8_DTYPE)
    return torch.from_numpy(np.array(a))


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _codes(v: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "int8":
        return torch.clamp(torch.round(v), -127, 127)
    return v.to(quant.FP8_DTYPE).to(torch.float32)


def _straddles(x, port_scale, ref_scale, precision) -> np.ndarray:
    """Where ``x / port_scale``, ``x / ref_scale`` and ``x * (1 /
    ref_scale)`` do not all land on one code: the roundings XLA's rewrite
    and a scale one ulp off can pick between."""
    xt = torch.from_numpy(x)
    ps, rs = (torch.from_numpy(np.array(s, np.float32)) for s in
              (port_scale, ref_scale))
    ps, rs = (s.reshape(s.shape + (1,) * (xt.ndim - s.ndim))
              for s in (ps, rs))
    a, b, c = (_codes(v, precision) for v in (xt / ps, xt / rs,
                                              xt * (1.0 / rs)))
    return ((a != b) | (a != c)).numpy()


def _assert_jit_quantization(port_ops, jit_ops, xs, precision):
    """The jitted reference's scales within one ulp of the port's, codes
    equal except straddles, and those one step apart; returns each
    operand's differing positions."""
    n = len(xs)
    diffs = []
    for i, x in enumerate(xs):
        p_s, j_s = port_ops[n + i].numpy(), np.asarray(jit_ops[n + i])
        np.testing.assert_array_max_ulp(p_s, j_s, maxulp=1)
        a = port_ops[i].to(torch.float32).numpy()
        b = _to_torch(jit_ops[i]).to(torch.float32).numpy()
        diff = a != b
        assert np.all(_straddles(x, p_s, j_s, precision)[diff])
        if precision == "int8":
            assert np.all(np.abs(a - b)[diff] <= 1)
        diffs.append(diff)
    return diffs


# ---------------------------------------------------------------------------
# row 7: te_gemm_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epilogue,with_bias", _EPILOGUES,
                         ids=[e for e, _ in _EPILOGUES])
@pytest.mark.parametrize("precision", _PRECISIONS)
def test_te_gemm_quantized_matches_reference_kernel(precision, epilogue,
                                                    with_bias):
    x, w, b = _rand(1, (128, 128), (128, 128), (128,))
    bias = b if with_bias else None
    codes = ref_te.quantize_gemm_operands(jnp.asarray(x), jnp.asarray(w),
                                          precision)
    want = np.asarray(ref_te.te_gemm_quant(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias), precision=precision,
        epilogue=epilogue, block_shape=(64, 128, 64), interpret=True))
    got = te_gemm.te_gemm_quantized(
        *(_to_torch(a) for a in codes),
        None if bias is None else torch.from_numpy(bias), epilogue=epilogue,
        out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (128, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", _PRECISIONS)
def test_quantize_gemm_operands_matches_reference(precision):
    x, w = _rand(2, (128, 128), (128, 128))
    port = te_gemm.quantize_gemm_operands(torch.from_numpy(x),
                                          torch.from_numpy(w), precision)
    assert port[0].dtype == quant.storage_dtype(precision)
    assert tuple(port[2].shape) == (128, 1) and \
        tuple(port[3].shape) == (1, 128)
    eager = ref_te.quantize_gemm_operands(jnp.asarray(x), jnp.asarray(w),
                                          precision)
    for p, r in zip(port, eager):
        assert torch.equal(p.to(torch.float32),
                           _to_torch(r).to(torch.float32))
    jitted = jax.jit(ref_te.quantize_gemm_operands, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(w), precision)
    _assert_jit_quantization(port, jitted, (x, w), precision)


@pytest.mark.parametrize("epilogue,with_bias", _EPILOGUES,
                         ids=[e for e, _ in _EPILOGUES])
@pytest.mark.parametrize("precision", _PRECISIONS)
def test_ops_te_gemm_quant_matches_reference(precision, epilogue,
                                             with_bias):
    x, w, b = _rand(3, (128, 128), (128, 128), (128,))
    bias = b if with_bias else None
    want = np.asarray(ref_ops.te_gemm_quant(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias), precision=precision,
        epilogue=epilogue))
    got = ops.te_gemm_quant(torch.from_numpy(x), torch.from_numpy(w),
                            None if bias is None else torch.from_numpy(bias),
                            precision=precision, epilogue=epilogue).numpy()
    assert got.dtype == np.float32
    dx, dw = _assert_jit_quantization(
        te_gemm.quantize_gemm_operands(torch.from_numpy(x),
                                       torch.from_numpy(w), precision),
        jax.jit(ref_te.quantize_gemm_operands, static_argnums=2)(
            jnp.asarray(x), jnp.asarray(w), precision),
        (x, w), precision)
    rows, cols = dx.any(axis=1), dw.any(axis=0)
    if epilogue == "softmax":  # a row mixes every column
        cols = np.full_like(cols, cols.any())
    keep = ~rows[:, None] & ~cols[None, :]
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-5)


def test_te_gemm_quant_twin_is_its_two_halves():
    x, w, b = _rand(4, (50, 70), (70, 33), (33,))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    for precision in _PRECISIONS:
        codes = te_gemm.quantize_gemm_operands(xt, wt, precision)
        want = te_gemm.te_gemm_quantized_torch(*codes, bt, epilogue="silu")
        assert torch.equal(te_gemm.te_gemm_quant(
            xt, wt, bt, precision=precision, epilogue="silu"), want)
        assert torch.equal(te_gemm.te_gemm_quant_torch(
            xt, wt, bt, precision=precision, epilogue="silu"), want)
    with pytest.raises(ValueError, match="int8/fp8"):
        te_gemm.te_gemm_quant(xt, wt, precision="bf16")


# ---------------------------------------------------------------------------
# row 9: mha_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("precision", _PRECISIONS)
def test_mha_quantized_matches_reference_kernel(precision, causal):
    q, k, v = _rand(5, *[(2, 128, 64)] * 3)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    codes = ref_mha.quantize_mha_operands(*jq, precision)
    want = np.asarray(ref_mha.mha_quant(*jq, precision=precision,
                                        causal=causal, bq=64, bkv=64,
                                        interpret=True))
    got = mha.mha_quantized(*(_to_torch(a) for a in codes), causal=causal,
                            out_dtype=torch.float32)
    assert tuple(got.shape) == (2, 128, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [48, 80])
@pytest.mark.parametrize("precision", _PRECISIONS)
def test_mha_quantized_padded_head_dim_matches_reference_kernel(precision, d):
    """A head dimension of no earlier kernel instance: the codes through
    ``mha.pad_head_dim`` (as the CUDA wrapper does; both D already have a
    16-byte row) and the twin at the true D's scale, against the reference
    kernel at D."""
    q, k, v = _rand(20 + d, *[(2, 64, d)] * 3)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    codes = [_to_torch(a) for a in
             ref_mha.quantize_mha_operands(*jq, precision)]
    want = np.asarray(ref_mha.mha_quant(*jq, precision=precision,
                                        causal=True, bq=32, bkv=32,
                                        interpret=True))
    padded = mha.pad_head_dim(*codes[:3])
    assert padded[0].shape[-1] == {48: 48, 80: 80}[d]
    got = mha.mha_quantized_torch(*padded, *codes[3:], causal=True,
                                  scale=d ** -0.5)[..., :d]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", _PRECISIONS)
def test_mha_quantized_wide_head_dim_matches_reference_kernel(precision):
    """D = 300, wider than one output slab: the CUDA wrapper pads the codes
    to 304 (a 16-byte row) and the kernel splits the output's D into slabs
    of 128, each with the whole D's scores; the twin on the padded codes
    cut back to D, and each slab of it, against the reference."""
    q, k, v = _rand(40, *[(2, 64, 300)] * 3)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    codes = [_to_torch(a) for a in
             ref_mha.quantize_mha_operands(*jq, precision)]
    want = np.asarray(ref_mha.mha_quant(*jq, precision=precision,
                                        causal=True, bq=32, bkv=32,
                                        interpret=True))
    padded = mha.pad_head_dim(*codes[:3])
    assert padded[0].shape[-1] == 304
    got = mha.mha_quantized_torch(*padded, *codes[3:], causal=True,
                                  scale=300 ** -0.5)[..., :300]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got = mha.mha_quantized(*codes, causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for d0 in (0, 128, 256):
        slab = mha.mha_quantized_torch(
            padded[0], padded[1], padded[2][..., d0:d0 + 128].contiguous(),
            *codes[3:], causal=True, scale=300 ** -0.5)
        np.testing.assert_allclose(
            slab.numpy()[..., :min(128, 300 - d0)], want[..., d0:d0 + 128],
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [20, 100])
@pytest.mark.parametrize("precision", _PRECISIONS)
def test_mha_quantized_code_pitch_padding_matches_reference_jnp(precision,
                                                                d):
    """The CUDA wrapper's D padding (to a multiple of 16 codes, the TMA
    copies' 16-byte row pitch; the kernel's 32-code k-steps read zeros past
    it): the padded codes through the twin at the true D's scale, cut back
    to D, against the reference's ``mha_quant_jnp`` on the unpadded
    operands, causal with Sq != Sk."""
    q, k, v = _rand(60 + d, (3, 40, d), (3, 72, d), (3, 72, d))
    jq = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(ref_mha.mha_quant_jnp(*jq, precision=precision,
                                            causal=True))
    codes = mha.quantize_mha_operands(
        *(torch.from_numpy(a) for a in (q, k, v)), precision)
    padded = mha.pad_head_dim(*codes[:3])
    assert padded[0].shape[-1] == -(-d // 16) * 16
    assert not padded[1][..., d:].to(torch.float32).any()
    got = mha.mha_quantized_torch(*padded, *codes[3:], causal=True,
                                  scale=d ** -0.5)[..., :d]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", _PRECISIONS)
def test_quantize_mha_operands_matches_reference(precision):
    q, k, v = _rand(6, *[(2, 128, 64)] * 3)
    port = mha.quantize_mha_operands(
        *(torch.from_numpy(a) for a in (q, k, v)), precision)
    assert all(tuple(s.shape) == (2, 1) for s in port[3:])
    eager = ref_mha.quantize_mha_operands(
        *(jnp.asarray(a) for a in (q, k, v)), precision)
    for p, r in zip(port, eager):
        assert torch.equal(p.to(torch.float32),
                           _to_torch(r).to(torch.float32))
    jitted = jax.jit(ref_mha.quantize_mha_operands, static_argnums=3)(
        *(jnp.asarray(a) for a in (q, k, v)), precision)
    _assert_jit_quantization(port, jitted, (q, k, v), precision)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("precision", _PRECISIONS)
def test_ops_mha_quant_matches_reference(precision, causal):
    q, k, v = _rand(7, *[(2, 128, 64)] * 3)
    jq = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(ref_ops.mha_quant(*jq, precision=precision,
                                        causal=causal))
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    got = ops.mha_quant(*tq, precision=precision, causal=causal).numpy()
    dq, dk, dv = _assert_jit_quantization(
        mha.quantize_mha_operands(*tq, precision),
        jax.jit(ref_mha.quantize_mha_operands, static_argnums=3)(
            *jq, precision), (q, k, v), precision)
    # a differing k or v code reaches every row of its head, a q code its
    # own row
    heads = (dk | dv).any(axis=(1, 2))
    keep = ~heads[:, None, None] & ~dq.any(axis=2, keepdims=True)
    keep = np.broadcast_to(keep, got.shape)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-5)


def test_mha_quant_twin_is_its_two_halves():
    q, k, v = (torch.from_numpy(a) for a in _rand(8, (3, 50, 32),
                                                  (3, 70, 32), (3, 70, 32)))
    for precision in _PRECISIONS:
        codes = mha.quantize_mha_operands(q, k, v, precision)
        want = mha.mha_quantized_torch(*codes, causal=False)
        assert torch.equal(mha.mha_quant(q, k, v, precision=precision,
                                         causal=False), want)
        assert torch.equal(mha.mha_quant_torch(q, k, v, precision=precision,
                                               causal=False), want)
        # dequantized, the codes stay close to the float attention
        np.testing.assert_allclose(
            want.numpy(), mha.mha_torch(q, k, v, causal=False).numpy(),
            atol=0.05 if precision == "int8" else 0.2)
