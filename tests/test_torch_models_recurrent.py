"""Port vs reference: the recurrent families of the model zoo
(``repro_torch.models``: ``hybrid`` (zamba2, on ``mamba2``), ``ssm``
(rwkv6) and ``audio`` (whisper)) against ``repro.models`` run live on the
same weights and inputs, as ``tests/test_torch_models.py`` holds the
attention families: forward, prefill and one decode step's logits and
every cache leaf at fp32 (``_lm_parity``), bf16 at its own bound; the
scans' units (``ssd_chunked`` with identity padding and against repeated
``ssd_decode_step``, ``wkv_scan`` with padding, ``_causal_conv`` with a
carried state); the reference's own checks on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as ref_mamba2
from repro.models import rwkv6 as ref_rwkv6
from repro_torch.common import params
from repro_torch.models import get_model, mamba2, rwkv6

import _lm_parity as P
from _port_share import port_share  # noqa: F401

ARCHS = ["zamba2-7b", "rwkv6-1.6b", "whisper-tiny"]


def _ssd_inputs(rng, b=2, s=21, h=4, p=8, g=2, n=6):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, a, bm, cm, s0


@pytest.mark.parametrize("chunk", [8, 7, 64])
def test_ssd_chunked_matches_reference(chunk):
    """21 steps: chunks of 8 and 7 pad with identity steps (none for 7),
    64 is clipped to the sequence."""
    args = _ssd_inputs(np.random.default_rng(chunk))
    x, dt, a, bm, cm, s0 = args
    y_r, st_r = ref_mamba2.ssd_chunked(
        *map(jnp.asarray, (x, dt, a, bm, cm)), chunk=chunk,
        initial_state=jnp.asarray(s0))
    y, st = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                               chunk=chunk,
                               initial_state=torch.from_numpy(s0))
    P.assert_close(y, np.asarray(y_r), P.RTOL, P.ATOL, "ssd y")
    P.assert_close(st, np.asarray(st_r), P.RTOL, P.ATOL, "ssd state")


def test_ssd_chunked_equals_repeated_decode_steps():
    x, dt, a, bm, cm, s0 = map(torch.from_numpy,
                               _ssd_inputs(np.random.default_rng(1)))
    y, st = mamba2.ssd_chunked(x, dt, a, bm, cm, chunk=8, initial_state=s0)
    ys, state = [], s0
    for t in range(x.shape[1]):
        cut = slice(t, t + 1)
        yt, state = mamba2.ssd_decode_step(x[:, cut], dt[:, cut], a,
                                           bm[:, cut], cm[:, cut], state)
        ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, 1), y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(state, st, rtol=1e-4, atol=1e-4)


def test_ssd_decode_step_matches_reference():
    x, dt, a, bm, cm, s0 = _ssd_inputs(np.random.default_rng(2), s=1)
    y_r, st_r = ref_mamba2.ssd_decode_step(
        *map(jnp.asarray, (x, dt, a, bm, cm, s0)))
    y, st = mamba2.ssd_decode_step(*map(torch.from_numpy,
                                        (x, dt, a, bm, cm, s0)))
    P.assert_close(y, np.asarray(y_r), P.RTOL, P.ATOL, "ssd decode y")
    P.assert_close(st, np.asarray(st_r), P.RTOL, P.ATOL, "ssd decode state")


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_reference(carried):
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if carried \
        else None
    y_r, ns_r = ref_mamba2._causal_conv(
        jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st))
    y, ns = mamba2._causal_conv(
        torch.from_numpy(u), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st))
    P.assert_close(y, np.asarray(y_r), P.RTOL, P.ATOL, "conv y")
    assert np.array_equal(ns.numpy(), np.asarray(ns_r))
    if carried:  # one step at a time from the carried state: the same
        state, steps = torch.from_numpy(st), []
        for t in range(u.shape[1]):
            yt, state = mamba2._causal_conv(
                torch.from_numpy(u[:, t:t + 1]), torch.from_numpy(w),
                torch.from_numpy(b), state)
            steps.append(yt)
        torch.testing.assert_close(torch.cat(steps, 1), y, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("s,chunk", [(13, 4), (12, 4), (5, 16)])
def test_wkv_scan_matches_reference(s, chunk):
    rng = np.random.default_rng(s * chunk)
    b, h, k = 2, 3, 8
    r, kk, v = (rng.standard_normal((b, s, h, k)).astype(np.float32)
                for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, k)))).astype(np.float32)
    u = rng.standard_normal((h, k)).astype(np.float32)
    st = rng.standard_normal((b, h, k, k)).astype(np.float32)
    o_r, st_r = ref_rwkv6.wkv_scan(*map(jnp.asarray, (r, kk, v, w, u, st)),
                                   chunk)
    o, st2 = rwkv6.wkv_scan(*map(torch.from_numpy, (r, kk, v, w, u, st)),
                            chunk)
    P.assert_close(o, np.asarray(o_r), P.RTOL, P.ATOL, "wkv out")
    P.assert_close(st2, np.asarray(st_r), P.RTOL, P.ATOL, "wkv state")


@pytest.mark.parametrize("which", ["forward", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_outputs_and_cache_match_reference(arch, which):
    P.check_fp32(P.case(arch), which)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_matches_reference(arch):
    P.check_bf16(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_error_within_reference_conditioning(arch):
    P.check_within_conditioning(arch)


def test_hybrid_cache_layout_equals_reference():
    c = P.case("zamba2-7b")
    cache = c.model.init_cache(P.B, P.MAX_LEN, device="cpu")
    ref = c.ref["prefill_cache"]
    assert sorted(cache) == sorted(ref)
    for key in ref:
        assert tuple(cache[key].shape) == ref[key].shape, key
    # the shared attention block is one set of weights, a KV cache per
    # super-block
    assert "layers" not in c.params["shared_attn"]["attn"]
    assert cache["k"].shape[0] == c.cfg.num_layers // c.cfg.attn_every


# -- the reference's own checks (tests/test_models.py) on the port ------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    c = P.case(arch)
    err = P.consistency_error(c.model, c.params, P.port_batch(c.inputs))
    assert err < 1e-3, f"{arch}: decode/prefill mismatch {err}"


@pytest.mark.parametrize("remat", ["none", "full", "dots_saveable"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_gradients_flow(arch, remat):
    """The reference's check through autograd, and every remat policy's
    gradients equal to no remat's."""
    c = P.case(arch)
    b = P.port_batch(c.inputs)
    grads = P.gradients(c.model, c.params, b)
    leaves = params.tree_leaves(grads)
    assert all(bool(torch.isfinite(g).all()) for g in leaves)
    nonzero = sum(bool((g != 0).any()) for g in leaves)
    assert nonzero > len(leaves) * 0.5, "most params should receive gradient"
    if remat != "none":
        m = get_model(c.cfg.replace(remat=remat))
        for g, h in zip(leaves, params.tree_leaves(
                P.gradients(m, c.params, b))):
            torch.testing.assert_close(h, g, rtol=1e-5, atol=1e-7)
