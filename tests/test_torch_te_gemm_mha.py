"""Port vs reference: the TE GEMM and flash-MHA kernels' plain twins.

On the CPU the port's wrappers take their plain twins (the kernels run on
the card, ``tests/test_torch_cuda.py``), so here the twins are held to the
reference's Pallas kernels in interpret mode on shared numpy inputs, with
block shapes that make the reference walk several K and key tiles:

* ``te_gemm``: every epilogue, with and without bias, fp32 and bf16, and a
  ragged shape (K = 54, N = 2, which the reference's kernel cannot tile)
  against the reference oracle ``te_gemm_ref``.  fp32 to rtol 1e-5 / atol
  1e-6 of the largest |out| (the sums run in another order); bf16 outputs
  to one bf16 rounding step (rtol 2**-7).
* ``mha``: causal and not, to rtol 1e-5 / atol 1e-6 (a flash softmax over
  tiles against the twin's whole-row softmax).

Two routes the CUDA wrappers add around their kernels are checked here by
their arithmetic: a softmax row of N = 600 (the kernel ends rows wider
than its column tile in a second pass; the twin against the reference
kernel holding the whole row), and head dimensions with no kernel
instance (48, 80: ``mha.pad_head_dim``, which keeps them, then the twin
at the true D's scale, against the reference kernel), to rtol 1e-5.
So is ``mha``'s route for D = 300 (rows aligned to 16 bytes, output
slabs of the whole D's scores), to rtol 1e-5.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import mha as ref_mha
from repro.kernels import ref as ref_oracle
from repro.kernels import te_gemm as ref_te
from repro_torch.kernels import _build, mha, te_gemm
from _port_share import port_share  # noqa: F401

_BF16_RTOL = 2.0 ** -7  # one rounding step of bf16's 8-bit significand


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype)


def _to_jax(a: np.ndarray, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16
                       else jnp.float32)


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("epilogue", te_gemm.EPILOGUES)
def test_te_gemm_twin_matches_reference_kernel(epilogue, with_bias, dtype):
    rng = np.random.default_rng(3)
    m, k, n = 128, 64, 32
    x, w, b = _rand(rng, m, k), _rand(rng, k, n), _rand(rng, n)
    if dtype == torch.bfloat16:  # operands on the bf16 grid in both
        x, w, b = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (x, w, b))
    want = ref_te.te_gemm(
        _to_jax(x, dtype), _to_jax(w, dtype),
        _to_jax(b, dtype) if with_bias else None, epilogue=epilogue,
        block_shape=(64, n, 32), interpret=True,
    )
    got = te_gemm.te_gemm(_to_torch(x, dtype), _to_torch(w, dtype),
                          _to_torch(b, dtype) if with_bias else None,
                          epilogue=epilogue)
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    want, got = _as_f32(want), _as_f32(got)
    scale = float(np.abs(want).max())
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=_BF16_RTOL,
                                   atol=1e-6 * scale)
    if epilogue == "softmax":
        np.testing.assert_allclose(got.sum(axis=-1), 1.0,
                                   rtol=3 * _BF16_RTOL)


@pytest.mark.parametrize("epilogue", te_gemm.EPILOGUES)
def test_te_gemm_twin_ragged_shape_matches_oracle(epilogue):
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, 50, 54), _rand(rng, 54, 2), _rand(rng, 2)
    want = np.asarray(ref_oracle.te_gemm_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), epilogue=epilogue))
    got = te_gemm.te_gemm(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), epilogue=epilogue).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [(4, 64, 16), (2, 128, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mha_twin_matches_reference_kernel(shape, causal):
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    want = np.asarray(ref_mha.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=32, bkv=32, interpret=True))
    got = mha.mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    ref = np.asarray(ref_oracle.mha_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref).max()))


def test_mha_twin_bf16_rounds_once():
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, 2, 64, 16).astype(ml_dtypes.bfloat16)
               .astype(np.float32) for _ in range(3))
    want = np.asarray(ref_mha.mha(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=False,
        bq=32, bkv=32, interpret=True)).astype(np.float32)
    got = mha.mha(*(torch.from_numpy(a).to(torch.bfloat16)
                    for a in (q, k, v)), causal=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=_BF16_RTOL,
                               atol=1e-6 * float(np.abs(want).max()))


def test_cpu_tensors_take_the_twins_without_launching():
    _build.reset_launches()
    x = torch.ones(4, 8)
    assert torch.equal(te_gemm.te_gemm(x, torch.ones(8, 3)),
                       torch.full((4, 3), 8.0))
    q = torch.zeros(1, 4, 16)
    assert torch.equal(mha.mha(q, q, q), q)
    assert sum(_build.launches.values()) == 0
    with pytest.raises(ValueError, match="epilogue"):
        te_gemm.te_gemm(x, torch.ones(8, 3), epilogue="gelu")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mha_twin_ragged_lengths_match_oracle(causal):
    rng = np.random.default_rng(11)
    q, k, v = _rand(rng, 3, 50, 32), _rand(rng, 3, 70, 32), \
        _rand(rng, 3, 70, 32)
    want = np.asarray(ref_oracle.mha_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    got = mha.mha(torch.from_numpy(q), torch.from_numpy(k),
                  torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_te_gemm_twin_wide_softmax_matches_reference_kernel(dtype):
    rng = np.random.default_rng(13)
    m, k, n = 16, 32, 600
    x, w, b = _rand(rng, m, k), _rand(rng, k, n) / 4.0, _rand(rng, n)
    if dtype == torch.bfloat16:  # operands on the bf16 grid in both
        x, w, b = (a.astype(ml_dtypes.bfloat16).astype(np.float32)
                   for a in (x, w, b))
    want = _as_f32(ref_te.te_gemm(
        _to_jax(x, dtype), _to_jax(w, dtype), _to_jax(b, dtype),
        epilogue="softmax", block_shape=(16, n, 32), interpret=True))
    got = te_gemm.te_gemm(_to_torch(x, dtype), _to_torch(w, dtype),
                          _to_torch(b, dtype), epilogue="softmax")
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    got = _as_f32(got)
    scale = float(np.abs(want).max())
    rtol = 1e-5 if dtype == torch.float32 else _BF16_RTOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=3 * _BF16_RTOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [48, 80])
def test_mha_padded_head_dim_matches_reference_kernel(d, causal):
    rng = np.random.default_rng(17 + d)
    q, k, v = (_rand(rng, 2, 64, d) for _ in range(3))
    want = np.asarray(ref_mha.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=32, bkv=32, interpret=True))
    qp, kp, vp = mha.pad_head_dim(*(torch.from_numpy(a) for a in (q, k, v)))
    assert qp.shape[-1] == {48: 48, 80: 80}[d]
    assert torch.equal(qp[..., :d], torch.from_numpy(q))
    assert not qp[..., d:].any()
    got = mha.mha_torch(qp, kp, vp, causal=causal,
                        scale=d ** -0.5)[..., :d].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def test_pad_head_dim_keeps_instances_and_refuses_wider():
    """A D that is a multiple of 16 (the quantized kernel's 16-byte row
    pitch for its codes) is kept as given, however wide; any other D pads
    to the next multiple of 16."""
    q = torch.ones(1, 4, 64)
    assert mha.pad_head_dim(q, q)[0] is q
    assert mha.pad_head_dim(torch.ones(1, 4, 200))[0].shape[-1] == 208
    wide = torch.ones(1, 4, 384)
    assert mha.pad_head_dim(wide)[0] is wide
    assert mha.pad_head_dim(torch.ones(1, 4, 300))[0].shape[-1] == 304


@pytest.mark.parametrize("dtype,dp", [(torch.float32, 300),
                                      (torch.bfloat16, 304)],
                         ids=["fp32", "bf16"])
def test_align_head_dim_pads_to_16_byte_rows(dtype, dp):
    """``csrc/mha.cu`` takes any D from rows of a multiple of 16 bytes:
    fp32 D = 300 is one already, bf16's gets 4 zero dims."""
    q = torch.randn(2, 8, 300).to(dtype)
    got = mha.align_head_dim(q, q)
    assert got[0].shape[-1] == dp
    assert torch.equal(got[0][..., :300], q) and not got[0][..., 300:].any()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_mha_route_d300_matches_reference_kernel(causal):
    """D = 300, wider than any TPU tile and than one CUDA block's output
    slab: the CUDA wrapper's route (align the rows, then the kernel over
    slabs of D, each with the whole D's scores) is the twin on the
    aligned operands at the true D's scale, cut back to D."""
    rng = np.random.default_rng(31)
    q, k, v = (_rand(rng, 2, 64, 300) for _ in range(3))
    want = np.asarray(ref_mha.mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        bq=32, bkv=32, interpret=True))
    qa, ka, va = mha.align_head_dim(*(torch.from_numpy(a) for a in (q, k, v)))
    got = mha.mha_torch(qa, ka, va, causal=causal,
                        scale=300 ** -0.5)[..., :300].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    # each output slab of the kernel's D split is the slab of the whole
    for d0 in range(0, 300, 128):
        slab = mha.mha_torch(qa, ka, va[..., d0:d0 + 128], causal=causal,
                             scale=300 ** -0.5).numpy()
        np.testing.assert_allclose(slab, want[..., d0:d0 + 128], rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()))
