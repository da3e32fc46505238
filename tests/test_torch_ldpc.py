"""Port vs reference: the layered min-sum LDPC decoder.

The plain twin (what ``ldpc_decode`` runs on a CPU tensor) is held to the
reference's jnp path and to its per-codeword numpy oracle, for both
registered codes at three operating points: every codeword converging at
once, a typical waterfall point, and one where nothing converges and the
decoder runs to ``max_iters``.  Hard bits and per-codeword iteration counts
must be equal.  Posteriors: identical to the numpy oracle, and within
1e-4 of the jnp path (XLA contracts multiply-adds on the CPU, so the jnp
posterior differs from both by a few ulps).  The CUDA kernel itself is
checked against the twin on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

The int8 datapath (``precision="int8"|"fp8"``) is integer arithmetic after
the entry quantization, so its twin must equal the reference's jnp path
and its Pallas kernel (interpret mode) bit for bit: posteriors and
iteration counts, at the same operating points and at a saturating one
(channel LLRs far beyond the +-20 clip).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ldpc as ref_ldpc
from repro.kernels import ref
from repro.phy import coding as ref_coding
from repro_torch.kernels import ldpc
from repro_torch.phy import coding
from _port_share import port_share  # noqa: F401

# (rate, snr_db, regime): BPSK-over-AWGN channel LLRs of random codewords
_POINTS = [
    ("r12", 14.0, "entry"), ("r12", 2.0, "typical"), ("r12", -6.0, "never"),
    ("r34", 14.0, "entry"), ("r34", 5.5, "typical"), ("r34", -6.0, "never"),
]


_N_MAX = 16  # codewords per draw at most: one encoder compile per code


@functools.lru_cache(maxsize=None)
def _transmit(rate: str):
    """The reference's encode + RV0 rate matching of ``_N_MAX`` codewords,
    jitted (one compile instead of an eager compile per op and shape)."""
    code = ref_coding.make_code(rate)
    return jax.jit(lambda bits: ref_coding.rate_match(
        code, ref_coding.encode(code, bits)))


def _llrs(rate: str, n: int, snr_db: float, seed: int) -> np.ndarray:
    """(n, n_mother) float32 LLRs (log P(1)/P(0)) of random codewords sent
    at RV0, punctured tail zero, drawn from ``seed``."""
    code = ref_coding.make_code(rate)
    rng = np.random.default_rng(seed)
    bits = np.zeros((_N_MAX, code.k), np.int32)
    bits[:n] = rng.integers(0, 2, (n, code.k))
    tx = np.asarray(_transmit(rate)(jnp.asarray(bits)))[:n]
    s2 = 10.0 ** (-snr_db / 10.0)
    y = (2 * tx - 1) + np.sqrt(s2) * rng.standard_normal(tx.shape)
    llr = (2.0 * y / s2).astype(np.float32)
    pad = np.zeros((n, code.n_mother - code.e_bits), np.float32)
    return np.concatenate([llr, pad], axis=1)


def _twin(llr: np.ndarray, rate: str, max_iters: int = 12):
    post, iters = ldpc.ldpc_decode(torch.from_numpy(llr),
                                   coding.make_code(rate),
                                   max_iters=max_iters)
    return post.numpy(), iters.numpy()


@pytest.fixture(scope="module")
def jnp_runs():
    """Per rate: one decode of all three operating points' codewords
    (16 each, stacked) by the twin and by the jnp path, so the reference's
    decode loop compiles once per code."""
    out = {}
    for rate in ("r12", "r34"):
        llr = np.concatenate([_llrs(rate, 16, snr, seed=3)
                              for r, snr, _ in _POINTS if r == rate])
        post_r, iters_r = ref_ldpc.ldpc_decode_jnp(
            jnp.asarray(llr), ref_coding.make_code(rate))
        out[rate] = (_twin(llr, rate),
                     (np.asarray(post_r), np.asarray(iters_r)))
    return out


@pytest.mark.parametrize("rate,snr_db,regime", _POINTS)
def test_twin_matches_jnp_path(jnp_runs, rate, snr_db, regime):
    i = [p for p in _POINTS if p[0] == rate].index((rate, snr_db, regime))
    rows = slice(16 * i, 16 * (i + 1))
    (post, iters), (post_r, iters_r) = jnp_runs[rate]
    post, iters = post[rows], iters[rows]
    post_r, iters_r = post_r[rows], iters_r[rows]
    assert np.array_equal(iters, iters_r)
    assert np.array_equal(post > 0, post_r > 0)
    np.testing.assert_allclose(post, post_r, rtol=0, atol=1e-4)
    if regime == "entry":
        assert iters.max() <= (0 if rate == "r12" else 1)
    elif regime == "never":
        assert (iters == 12).all()
    else:
        assert 0 < iters.min() and iters.max() <= 12
        assert len(np.unique(iters)) > 2


@pytest.mark.parametrize("rate,snr_db,regime", _POINTS)
def test_twin_matches_numpy_oracle_exactly(rate, snr_db, regime):
    llr = _llrs(rate, 6, snr_db, seed=5)
    post, iters = _twin(llr, rate)
    post_o, iters_o = ref.ldpc_decode_ref(llr, ref_coding.make_code(rate))
    assert np.array_equal(iters, np.asarray(iters_o))
    assert np.array_equal(post, np.asarray(post_o))


def test_twin_matches_pallas_interpret():
    llr = _llrs("r12", 4, 3.5, seed=7)
    post, iters = _twin(llr, "r12")
    post_p, iters_p = ref_ldpc.ldpc_decode_pallas(
        jnp.asarray(llr), ref_coding.make_code("r12"), interpret=True)
    assert np.array_equal(iters, np.asarray(iters_p))
    assert np.array_equal(post > 0, np.asarray(post_p) > 0)
    np.testing.assert_allclose(post, np.asarray(post_p), rtol=0, atol=1e-4)


def test_max_iters_and_cuda_contract():
    llr = _llrs("r12", 6, -6.0, seed=9)
    _, iters = _twin(llr, "r12", max_iters=3)
    assert (iters == 3).all()
    # the quantized precisions run the int8 twin on a CPU tensor
    _, iters = ldpc.ldpc_decode(torch.from_numpy(llr),
                                coding.make_code("r12"), max_iters=3,
                                precision="int8")
    assert (iters == 3).all()
    # both kernels take any z: at z = 64 the int8 CUDA entry refuses a
    # CPU tensor for its device alone
    with pytest.raises(ValueError, match="expected a CUDA device"):
        ldpc.ldpc_decode_cuda(torch.zeros(1, 24 * 64),
                              coding.make_code("r12", z=64),
                              precision="int8")


@pytest.mark.parametrize("z,snr_db,precision", [
    (16, 1.0, None), (16, 1.0, "int8"), (64, 3.0, None), (64, 3.0, "int8"),
], ids=["fp32", "int8", "z64-fp32", "z64-int8"])
def test_twins_decode_z16_as_jnp_path(z, snr_db, precision):
    """Lifting sizes z = 16 (the reference's own tests decode it) and 64
    (past the earlier int8 kernel's z <= 32; the CUDA kernels take both),
    each at an SNR where the codewords stop after different numbers of
    sweeps: iteration counts and hard bits equal to the jnp path's,
    posteriors within 1e-4 for fp32 (XLA contracts multiply-adds) and bit
    for bit for int8."""
    code_r = ref_coding.make_code("r12", z=z)
    code = coding.make_code("r12", z=z)
    assert code.layers() == code_r.layers()
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (16, code.k)).astype(np.int32)
    tx = np.asarray(jax.jit(lambda b: ref_coding.rate_match(
        code_r, ref_coding.encode(code_r, b)))(jnp.asarray(bits)))
    s2 = 10.0 ** (-snr_db / 10.0)
    y = (2 * tx - 1) + np.sqrt(s2) * rng.standard_normal(tx.shape)
    llr = np.concatenate(
        [(2.0 * y / s2).astype(np.float32),
         np.zeros((16, code.n_mother - code.e_bits), np.float32)], axis=1)
    post, iters = ldpc.ldpc_decode(torch.from_numpy(llr), code,
                                   precision=precision)
    post_r, iters_r = ref_ldpc.ldpc_decode_jnp(jnp.asarray(llr), code_r,
                                               precision=precision)
    post, iters = post.numpy(), iters.numpy()
    assert np.array_equal(iters, np.asarray(iters_r))
    assert len(np.unique(iters)) > 1
    assert np.array_equal(post > 0, np.asarray(post_r) > 0)
    if precision is None:
        np.testing.assert_allclose(post, np.asarray(post_r), rtol=0,
                                   atol=1e-4)
    else:
        assert np.array_equal(post, np.asarray(post_r))



# ---------------------------------------------------------------------------
# the int8 datapath
# ---------------------------------------------------------------------------

def _twin_q(llr: np.ndarray, rate: str, precision: str = "int8"):
    post, iters = ldpc.ldpc_decode(torch.from_numpy(llr),
                                   coding.make_code(rate),
                                   precision=precision)
    return post.numpy(), iters.numpy()


@pytest.fixture(scope="module")
def jnp_runs_q():
    """Per rate: the three operating points (16 codewords each) and a
    saturating copy of the waterfall point (LLRs x 8, far beyond the
    clip), decoded at int8 by the twin and by the jnp path in one call."""
    out = {}
    for rate in ("r12", "r34"):
        pts = [_llrs(rate, 16, snr, seed=4) for r, snr, _ in _POINTS
               if r == rate]
        llr = np.concatenate(pts + [8.0 * pts[1]])
        post_r, iters_r = ref_ldpc.ldpc_decode_jnp(
            jnp.asarray(llr), ref_coding.make_code(rate), precision="int8")
        out[rate] = (llr, _twin_q(llr, rate),
                     (np.asarray(post_r), np.asarray(iters_r)))
    return out


@pytest.mark.parametrize("rate", ["r12", "r34"])
@pytest.mark.parametrize("regime", ["entry", "typical", "never",
                                    "saturating"])
def test_int8_twin_matches_jnp_path_exactly(jnp_runs_q, rate, regime):
    i = ["entry", "typical", "never", "saturating"].index(regime)
    rows = slice(16 * i, 16 * (i + 1))
    llr, (post, iters), (post_r, iters_r) = jnp_runs_q[rate]
    assert np.array_equal(iters[rows], iters_r[rows])
    assert np.array_equal(post[rows], post_r[rows])
    step = np.float32(20.0 / 127.0)
    if regime == "never":
        assert (iters[rows] == 12).all()
    if regime == "saturating":
        # channel codes clip at +-127 and check messages saturate at the
        # int8 range; the posterior of a column of degree d stays within
        # 127 * (1 + d) codes, under the 12-bit clip at +-2047
        assert np.abs(llr[rows]).max() > 20.0 * 4
        codes = np.rint(post[rows] / step)
        assert np.abs(codes).max() > 127
        assert np.abs(codes).max() <= 2047


def test_int8_and_fp8_share_one_datapath():
    llr = _llrs("r34", 8, 5.5, seed=6)
    post, iters = _twin_q(llr, "r34", "int8")
    post8, iters8 = _twin_q(llr, "r34", "fp8")
    assert np.array_equal(post, post8) and np.array_equal(iters, iters8)


def test_int8_twin_matches_pallas_interpret_exactly():
    llr = np.concatenate([_llrs("r12", 4, 3.5, seed=8),
                          8.0 * _llrs("r12", 4, 3.5, seed=9)])
    post, iters = _twin_q(llr, "r12")
    post_p, iters_p = ref_ldpc.ldpc_decode_pallas(
        jnp.asarray(llr), ref_coding.make_code("r12"), interpret=True,
        precision="int8")
    assert np.array_equal(iters, np.asarray(iters_p))
    assert np.array_equal(post, np.asarray(post_p))


def test_int8_sweep_saturates_like_reference():
    """One layered sweep from integer states drawn across the whole
    12-bit posterior range and the int8 message range: the posterior clip
    at +-2047 and the message saturation match the reference's sweep (a
    decode cannot reach the posterior clip from +-127 channel codes)."""
    code = coding.make_code("r12")
    rng = np.random.default_rng(10)
    v = rng.integers(-2047, 2048, (code.n_b, code.z, 8), dtype=np.int32)
    c2v = tuple(rng.integers(-127, 128, (len(e), code.z, 8), dtype=np.int32)
                for e in code.layers())
    got_v, got_c = ldpc._layered_iteration_q(
        torch.from_numpy(v), tuple(map(torch.from_numpy, c2v)),
        code.layers(), ldpc.DEFAULT_ALPHA)
    want_v, want_c = ref_ldpc._layered_iteration_q(
        jnp.asarray(v), tuple(map(jnp.asarray, c2v)),
        ref_coding.make_code("r12").layers(), ref_ldpc.DEFAULT_ALPHA)
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.abs(got_v.numpy()).max() == 2047
    for g, w in zip(got_c, want_c):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.abs(g.numpy()).max() == 127


# ---------------------------------------------------------------------------
# the port's numpy oracle (kernels/ref.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,snr_db", [("r12", 2.0), ("r34", 5.5),
                                         ("r12", -6.0)])
def test_port_oracle_equals_reference_oracle(rate, snr_db):
    """``repro_torch.kernels.ref.ldpc_decode_ref`` is the reference's
    per-codeword numpy loop: posteriors and iteration counts bit for bit
    on shared LLRs, returned as tensors; the twin equals it too (the
    kernels are held to it on the card by ``chip_smoke.py``)."""
    from repro_torch.kernels import ref as port_ref

    llr = _llrs(rate, 4, snr_db, seed=21)
    post, iters = port_ref.ldpc_decode_ref(torch.from_numpy(llr),
                                           coding.make_code(rate))
    post_o, iters_o = ref.ldpc_decode_ref(llr, ref_coding.make_code(rate))
    assert isinstance(post, torch.Tensor) and post.dtype == torch.float32
    assert iters.dtype == torch.int32
    assert np.array_equal(iters.numpy(), np.asarray(iters_o))
    assert np.array_equal(post.numpy(), np.asarray(post_o))
    twin_post, twin_iters = _twin(llr, rate)
    assert np.array_equal(twin_iters, iters.numpy())
    assert np.array_equal(twin_post, post.numpy())
