"""Port vs reference: the paper's three compute blocks (Sec. V-C, Fig. 10)
and the kernel-ops entry point.

* **Kernels 10 and 11.**  ``ops.fc_softmax`` and ``ops.dwconv_block`` (the
  plain twins on the CPU) against the reference's ``ops`` (Pallas in
  interpret mode) and its oracles, at the reference's own test shapes and
  gates (``tests/test_kernels.py``): FC + softmax rtol 2e-4 / atol 5e-5,
  the conv block rtol 5e-4 / atol 5e-4 and ReLU'd.
* **The six plans.**  Each block's sequential plan equals its concurrent
  plan within the reference's gates (``tests/test_pool.py``), and each
  port plan equals the reference's plan on the same inputs within the
  same gate.
* **The cycle model.**  ``fc_block_cycles`` and ``dwconv_block_cycles``
  equal the reference's field for field.
* **Oracles.**  ``repro_torch.kernels.ref`` against ``repro.kernels.ref``.
* **Dispatch.**  Every ``ops`` wrapper, and every plan that goes through
  one, raises on a non-CPU tensor when no kernel can be built, instead of
  falling back to its twin.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pool as ref_pool
from repro.kernels import dwconv_block as ref_dw
from repro.kernels import fc_softmax as ref_fc
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.phy import ofdm as ref_ofdm
from repro_torch.core import pool
from repro_torch.kernels import _build, dwconv_block, fc_softmax, ops, ref
from repro_torch.phy import ofdm
from _port_share import port_share  # noqa: F401


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# rows 10 and 11
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 512), (256, 384, 512)])
def test_fc_softmax_matches_reference(m, k, n):
    x, w, b = _rand(m + k, (m, k), (k, n), (n,))
    got = ops.fc_softmax(*_t(x, w, b)).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    want = np.asarray(ref_ops.fc_softmax(*_j(x, w, b)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)
    oracle = np.asarray(ref_oracle.fc_softmax_ref(*_j(x, w, b)))
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-5)


def test_fc_softmax_twin_wide_row_matches_reference_kernel():
    """N = 600, wider than one cluster of the CUDA kernel holds (there the
    row goes to te_gemm's two-pass softmax): the twin against the
    reference kernel in interpret mode, which holds the whole row."""
    x, w, b = _rand(21, (16, 64), (64, 600), (600,))
    got = fc_softmax.fc_softmax(*_t(x, w, b)).numpy()
    want = np.asarray(ref_fc.fc_softmax(*_j(x, w, b), bm=16, bk=64,
                                        interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-5)


def _dw_inputs(seed, b, h, w, c, f):
    xp, dw, pw, g, be = _rand(seed, (b, h + 2, w + 2, c), (3, 3, c),
                              (c, f), (f,), (f,))
    return xp, dw * 0.2, pw * 0.1, 1.0 + 0.1 * g, 0.1 * be


@pytest.mark.parametrize("h,w,c,f", [(16, 8, 128, 128), (32, 16, 256, 128)])
def test_dwconv_block_matches_reference(h, w, c, f):
    args = _dw_inputs(h + c, 2, h, w, c, f)
    got = ops.dwconv_block(*_t(*args)).numpy()
    assert got.shape == (2, h, w, f) and got.dtype == np.float32
    want = np.asarray(ref_ops.dwconv_block(*_j(*args)))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    oracle = np.asarray(ref_oracle.dwconv_block_ref(*_j(*args)))
    np.testing.assert_allclose(got, oracle, rtol=5e-4, atol=5e-4)
    assert np.all(got >= 0)  # ReLU'd


@pytest.mark.parametrize("c,f", [(128, 1536), (16, 8200)])
def test_dwconv_block_twin_wide_row_matches_reference_kernel(c, f):
    """F = 1536 and 8200, wider than one CUDA cluster normalises (there
    the tiles write pre-norm rows and a second, row-wise pass takes the
    LayerNorm): the twin against the reference kernel in interpret mode,
    which holds the whole row."""
    args = _dw_inputs(15, 1, 4, 4, c, f)
    want = np.asarray(ref_dw.dwconv_block(*_j(*args), interpret=True))
    got = dwconv_block.dwconv_block(*_t(*args)).numpy()
    assert got.shape == (1, 4, 4, f)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    assert np.all(got >= 0)


def test_block_twins_take_ragged_shapes():
    """The kernels mask their edges, so the twins take shapes the
    reference's block grid cannot tile (C = 70, F = 100, M = 37)."""
    args = _dw_inputs(9, 3, 5, 7, 70, 100)
    got = dwconv_block.dwconv_block(*_t(*args))
    want = np.asarray(ref_oracle.dwconv_block_ref(*_j(*args)))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)
    x, w, b = _rand(10, (37, 45), (45, 333), (333,))
    got = fc_softmax.fc_softmax(*_t(x, w, b)).numpy()
    want = np.asarray(ref_oracle.fc_softmax_ref(*_j(x, w, b)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)


# ---------------------------------------------------------------------------
# the six execution plans (reference gates: tests/test_pool.py)
# ---------------------------------------------------------------------------

def _fc_args():
    return _rand(11, (256, 256), (256, 512), (512,))


def _mha_args():
    return _rand(12, (4, 128, 64), (4, 128, 64), (4, 128, 64))


def _dw_args():
    xp, dw, pw = _rand(13, (2, 18, 10, 128), (3, 3, 128), (128, 128))
    return (xp, dw * 0.2, pw * 0.1, np.ones(128, np.float32),
            np.zeros(128, np.float32))


_PLANS = {
    "fc_softmax": (_fc_args, dict(rtol=2e-4, atol=1e-5)),
    "mha": (_mha_args, dict(rtol=2e-5, atol=2e-5)),
    "dwconv": (_dw_args, dict(rtol=5e-4, atol=5e-4)),
}


@pytest.mark.parametrize("block", sorted(_PLANS))
def test_plans_agree_and_match_reference(block):
    make, tol = _PLANS[block]
    args = make()
    seq = getattr(pool, f"{block}_sequential")(*_t(*args)).numpy()
    con = getattr(pool, f"{block}_concurrent")(*_t(*args)).numpy()
    np.testing.assert_allclose(seq, con, **tol)
    for plan, got in (("sequential", seq), ("concurrent", con)):
        want = np.asarray(getattr(ref_pool, f"{block}_{plan}")(*_j(*args)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_mha_plans_take_the_mask_flag(causal):
    q, k, v = _rand(14, (2, 64, 32), (2, 64, 32), (2, 64, 32))
    seq = pool.mha_sequential(*_t(q, k, v), causal=causal).numpy()
    con = pool.mha_concurrent(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(seq, con, rtol=2e-5, atol=2e-5)
    want = np.asarray(ref_pool.mha_sequential(*_j(q, k, v), causal=causal))
    np.testing.assert_allclose(seq, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the cycle model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,shape", [
    ("fc_block_cycles", (512, 512, 512)),
    ("fc_block_cycles", (256, 384, 512)),
    ("dwconv_block_cycles", (32, 16, 512, 512)),
    ("dwconv_block_cycles", (16, 8, 128, 128)),
    ("mha_block_cycles", (4, 128, 512)),
])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_block_cycles_match_reference(fn, shape, dtype_bytes):
    got = getattr(pool, fn)(*shape, dtype_bytes=dtype_bytes)
    want = getattr(ref_pool, fn)(*shape, dtype_bytes=dtype_bytes)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sequential == want.sequential
    assert got.concurrent() == want.concurrent()
    assert got.te_utilization_concurrent == want.te_utilization_concurrent


def test_cycle_model_keeps_the_papers_ordering():
    """Paper Fig. 10: concurrent beats sequential on all three blocks, and
    the PE-heavy conv block has the lowest TE utilization."""
    fc = pool.fc_block_cycles(512, 512, 512)
    dw = pool.dwconv_block_cycles(32, 16, 512, 512)
    mha = pool.mha_block_cycles(4, 128, 512)
    for blk in (fc, dw, mha):
        assert blk.concurrent() < blk.sequential
    assert dw.te_utilization_concurrent < min(
        fc.te_utilization_concurrent, mha.te_utilization_concurrent)


# ---------------------------------------------------------------------------
# the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epilogue", ["none", "relu", "silu", "softmax"])
def test_te_gemm_oracle_matches_reference(epilogue):
    x, w, b = _rand(15, (40, 30), (30, 20), (20,))
    np.testing.assert_allclose(
        ref.te_gemm_ref(*_t(x, w, b), epilogue).numpy(),
        np.asarray(ref_oracle.te_gemm_ref(*_j(x, w, b), epilogue)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_oracles_match_reference(causal):
    q, k, v = _rand(16, (3, 40, 16), (3, 40, 16), (3, 40, 16))
    np.testing.assert_allclose(
        ref.mha_ref(*_t(q, k, v), causal).numpy(),
        np.asarray(ref_oracle.mha_ref(*_j(q, k, v), causal)),
        rtol=1e-5, atol=1e-6)
    x, w, b = _rand(17, (40, 30), (30, 64), (64,))
    np.testing.assert_allclose(
        ref.fc_softmax_ref(*_t(x, w, b)).numpy(),
        np.asarray(ref_oracle.fc_softmax_ref(*_j(x, w, b))),
        rtol=1e-5, atol=1e-7)
    args = _dw_inputs(18, 2, 6, 5, 24, 40)
    np.testing.assert_allclose(
        ref.dwconv_block_ref(*_t(*args)).numpy(),
        np.asarray(ref_oracle.dwconv_block_ref(*_j(*args))),
        rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the remaining ops wrappers, and dispatch
# ---------------------------------------------------------------------------

def test_ops_te_gemm_and_mha_match_reference():
    x, w, b = _rand(19, (128, 64), (64, 128), (128,))
    np.testing.assert_allclose(
        ops.te_gemm(*_t(x, w, b), epilogue="relu").numpy(),
        np.asarray(ref_ops.te_gemm(*_j(x, w, b), epilogue="relu")),
        rtol=1e-5, atol=1e-5)
    q, k, v = _rand(20, (2, 128, 32), (2, 128, 32), (2, 128, 32))
    np.testing.assert_allclose(
        ops.mha(*_t(q, k, v), causal=True).numpy(),
        np.asarray(ref_ops.mha(*_j(q, k, v), causal=True)),
        rtol=1e-5, atol=1e-6)


def test_ops_pick_block_shape_is_the_gemm_picker():
    """The reference's ``ops.pick_block_shape`` alias: here the Hopper
    GEMM's launch-shape picker."""
    from repro_torch.kernels import te_gemm

    assert callable(ref_ops.pick_block_shape)
    assert ops.pick_block_shape is te_gemm.pick_block_shape
    assert ops.pick_block_shape(28672, 32, 288) == \
        te_gemm.pick_block_shape(28672, 32, 288, torch.float32)


def test_ops_receiver_kernels_match_reference():
    from test_torch_rx_fused import _PSYM, _detect_inputs, _ls_inputs

    y, h, nv = _detect_inputs(2, 2, "qam16", seed=21)
    got = ops.mmse_detect_demap(torch.from_numpy(y), torch.from_numpy(h),
                                torch.tensor(nv), ofdm.make_modem("qam16"))
    want = ref_ops.mmse_detect_demap(jnp.asarray(y), jnp.asarray(h),
                                     jnp.float32(nv),
                                     ref_ofdm.make_modem("qam16"))
    for a, b_, rtol in zip(got, want, (1e-4, 1e-4, 1e-3)):
        b_ = np.asarray(b_)
        np.testing.assert_allclose(a.numpy(), b_, rtol=rtol,
                                   atol=1e-5 * max(1.0, np.abs(b_).max()))
    y, op, stride = _ls_inputs(2, 2, seed=22)
    np.testing.assert_allclose(
        ops.ls_che(torch.from_numpy(y), _PSYM, stride,
                   torch.from_numpy(op)).numpy(),
        np.asarray(ref_ops.ls_che(jnp.asarray(y), _PSYM, stride,
                                  jnp.asarray(op))),
        rtol=1e-5, atol=1e-6)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _no_fallback_calls():
    """Each public wrapper and each plan through one, on meta tensors
    (standing in for CUDA tensors: not on the CPU)."""
    modem = ofdm.make_modem("qam16")
    c64 = torch.complex64
    x, w, b = _meta(16, 8), _meta(8, 32), _meta(32)
    q = _meta(2, 64, 16)
    xp, dw, pw, g = _meta(1, 6, 6, 16), _meta(3, 3, 16), _meta(16, 32), \
        _meta(32)
    y, h = _meta(1, 14, 64, 2, dtype=c64), _meta(1, 64, 2, 2, dtype=c64)
    return {
        "te_gemm": lambda: ops.te_gemm(x, w, b),
        "mha": lambda: ops.mha(q, q, q),
        "te_gemm_quant[int8]": lambda: ops.te_gemm_quant(x, w, b),
        "te_gemm_quant[fp8]": lambda: ops.te_gemm_quant(
            x, w, b, precision="fp8"),
        "mha_quant[int8]": lambda: ops.mha_quant(q, q, q),
        "mha_quant[fp8]": lambda: ops.mha_quant(q, q, q, precision="fp8"),
        "mmse_detect_demap": lambda: ops.mmse_detect_demap(
            y, h, _meta(), modem),
        "ls_che": lambda: ops.ls_che(y, (2, 11), 2,
                                     _meta(2, 16, 64, dtype=c64)),
        "fc_softmax": lambda: ops.fc_softmax(x, w, b),
        "dwconv_block": lambda: ops.dwconv_block(xp, dw, pw, g, g),
        "fc_softmax_sequential": lambda: pool.fc_softmax_sequential(x, w, b),
        "fc_softmax_concurrent": lambda: pool.fc_softmax_concurrent(x, w, b),
        "mha_concurrent": lambda: pool.mha_concurrent(q, q, q),
        "dwconv_concurrent": lambda: pool.dwconv_concurrent(xp, dw, pw, g,
                                                            g),
    }


@pytest.mark.parametrize("name", sorted(_no_fallback_calls()))
def test_ops_raise_instead_of_falling_back(monkeypatch, name):
    """With the device check passed (as for a CUDA tensor) and no kernel
    to load (no card, no nvcc), the wrapper raises: it never hands a
    non-CPU tensor to its twin, which would run on these meta tensors."""
    def no_kernel(lib):
        raise RuntimeError(f"no built kernel {lib}")

    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "library", no_kernel)
    _build.reset_launches()
    with pytest.raises(RuntimeError, match="no built kernel"):
        _no_fallback_calls()[name]()
    assert sum(_build.launches.values()) == 0


def test_ops_refuse_non_cpu_tensors_they_cannot_check():
    """Unpatched, a meta tensor fails the wrapper's CUDA check."""
    x, w = _meta(16, 8), _meta(8, 32)
    for fn in (ops.fc_softmax, ops.te_gemm_quant, ops.te_gemm):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(x, w)
