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

from repro_torch.common.params import tree_leaves, tree_map
from repro_torch.core import pool
from repro_torch.kernels import (_build, dwconv_block, fc_softmax, ldpc, mha,
                                 ops, rx_fused, te_gemm)
from repro_torch.phy import coding, link, ofdm, scenarios

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


_BF16_RTOL = 2.0 ** -7  # one rounding step of bf16's 8-bit significand


def _close(got, want, rtol):
    """fp32: rtol 1e-4 (sums in another order than cuBLAS's), bf16: one
    rounding step; atol 1e-5 of the largest |want| either way."""
    want = want.to(torch.float32)
    atol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got.to(torch.float32), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("m,k,n,epilogue,bias,dtype", [
    (28672, 54, 32, "relu", True, torch.float32),     # DeepRx conv_in
    (28672, 288, 32, "none", True, torch.float32),    # DeepRx block conv
    (28672, 32, 2, "none", True, torch.float32),      # DeepRx conv_out
    (512, 64, 192, "none", False, torch.float32),     # CE-ViT wqkv
    (512, 128, 64, "none", True, torch.float32),      # CE-ViT w2
    (512, 64, 128, "silu", True, torch.float32),
    (512, 64, 64, "softmax", True, torch.float32),
    (300, 40, 200, "softmax", False, torch.float32),  # two passes
    (777, 100, 33, "relu", True, torch.float32),      # ragged everywhere
    (28672, 288, 32, "relu", True, torch.bfloat16),
    (512, 64, 64, "softmax", True, torch.bfloat16),
    # every other DeepRx and CE-ViT shape, and the kernel's other paths
    (28672, 288, 32, "relu", True, torch.float32),    # DeepRx block conv1
    (28672, 32, 4, "none", True, torch.float32),      # DeepRx conv_out
    (512, 16, 64, "none", False, torch.float32),      # CE-ViT embed
    (512, 64, 64, "none", False, torch.float32),      # CE-ViT wo
    (512, 64, 128, "none", True, torch.float32),      # CE-ViT w1
    (512, 64, 8, "none", False, torch.float32),       # CE-ViT head
    (4096, 288, 64, "relu", True, torch.float32),     # W held in 2 chunks
    (512, 512, 512, "none", True, torch.float32),     # Fig. 10's FC GEMM
    (28672, 54, 32, "relu", True, torch.bfloat16),    # cp.async rows
    (300, 45, 40, "silu", True, torch.bfloat16),      # odd K: plain loads
])
def test_te_gemm_kernel_matches_twin(dev, m, k, n, epilogue, bias, dtype):
    gen = ofdm.make_generator(m + k + n, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(dtype)
    b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype) \
        if bias else None
    n0 = _build.launches["te_gemm"]
    got = te_gemm.te_gemm(x, w, b, epilogue=epilogue)
    assert _build.launches["te_gemm"] == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    want = te_gemm.te_gemm_torch(x, w, b, epilogue=epilogue)
    _close(got, want, 1e-4 if dtype == torch.float32 else _BF16_RTOL)


@pytest.mark.parametrize("bh,sq,sk,d,causal,dtype", [
    (32, 64, 64, 16, False, torch.float32),   # CE-ViT
    (16, 256, 256, 64, False, torch.float32),
    (16, 256, 256, 64, True, torch.float32),
    (8, 200, 200, 128, True, torch.float32),  # ragged query and key tiles
    (4, 70, 130, 32, False, torch.float32),
    (16, 256, 256, 64, False, torch.bfloat16),
    (32, 64, 64, 48, False, torch.float32),
    (8, 100, 100, 80, True, torch.float32),
    (4, 128, 128, 256, False, torch.float32),  # two output slabs of D
    (4, 128, 128, 128, True, torch.float32),   # Fig. 10's MHA block
    (4, 128, 128, 128, True, torch.bfloat16),
    (2, 64, 64, 300, False, torch.float32),    # D > 256: three slabs
    (2, 64, 64, 300, True, torch.bfloat16),    # rows padded to 304
    (2, 96, 80, 512, True, torch.float32),
    (2, 96, 80, 512, False, torch.bfloat16),
    (3, 70, 130, 40, True, torch.bfloat16),    # ragged Sq != Sk
    (3, 130, 70, 24, False, torch.float32),
])
def test_mha_kernel_matches_twin(dev, bh, sq, sk, d, causal, dtype):
    gen = ofdm.make_generator(bh + sq + d, dev)
    q = torch.randn(bh, sq, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(bh, sk, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    n0 = _build.launches["mha"]
    got = mha.mha(q, k, v, causal=causal)
    assert _build.launches["mha"] == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (bh, sq, d)
    _close(got, mha.mha_torch(q, k, v, causal=causal),
           1e-4 if dtype == torch.float32 else _BF16_RTOL)


@pytest.mark.parametrize("m,k,n,bias,dtype", [
    (512, 64, 300, True, torch.float32),
    (512, 64, 600, True, torch.float32),
    (256, 128, 1000, False, torch.float32),
    (512, 64, 600, True, torch.bfloat16),
])
def test_te_gemm_wide_softmax_matches_twin(dev, m, k, n, bias, dtype):
    """A softmax row wider than one column tile: per-tile logits and
    (max, sum) pairs, then the normalising pass."""
    gen = ofdm.make_generator(m + k + n, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(dtype)
    b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype) \
        if bias else None
    n0 = _build.launches["te_gemm"]
    got = te_gemm.te_gemm(x, w, b, epilogue="softmax")
    assert _build.launches["te_gemm"] == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    _close(got, te_gemm.te_gemm_torch(x, w, b, epilogue="softmax"),
           1e-4 if dtype == torch.float32 else _BF16_RTOL)


def test_kernel_wrappers_refuse_operands_requiring_grad(dev):
    """The wrappers without a backward refuse an operand that requires
    grad while grad mode is on; te_gemm and mha train (below)."""
    gen = ofdm.make_generator(11, dev)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    g = lambda t: t.clone().requires_grad_()
    x, w = r(64, 16), r(16, 8)
    q = r(2, 64, 16)
    scn = scenarios.get_scenario("siso-qam16-r12-snr15")
    slot = scn.make_batch(ofdm.make_generator(4, dev), 2)
    y = torch.fft.fft(slot["y_time"], dim=2).contiguous()
    op = torch.from_numpy(rx_fused.make_ls_interp_operator(
        scn.grid.n_subcarriers, 1, scn.grid.pilot_stride,
        ofdm.pilot_sequence_np(scn.grid))).to(dev)
    h = slot["h"][:, 0].contiguous()
    code = coding.make_code("r12")
    calls = [
        lambda: te_gemm.te_gemm_quant(g(x), w),
        lambda: mha.mha_quant(g(q), q, q),
        lambda: fc_softmax.fc_softmax(x, g(w)),
        lambda: dwconv_block.dwconv_block(
            r(1, 6, 6, 16), 0.2 * r(3, 3, 16), g(r(16, 32)),
            torch.ones(32, device=dev), torch.zeros(32, device=dev)),
        lambda: rx_fused.ls_che(y, scn.grid.pilot_symbols,
                                scn.grid.pilot_stride, g(op)),
        lambda: rx_fused.mmse_detect_demap(y, g(h), slot["noise_var"],
                                           scn.modem),
        lambda: rx_fused.sic_detect_demap(y, g(h), slot["noise_var"],
                                          scn.modem),
        lambda: ldpc.ldpc_decode(g(r(4, code.n_mother)), code),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    with torch.no_grad():  # serving's mode: no graph, no error
        _close(te_gemm.te_gemm(x, g(w)), x @ w, 1e-4)


@pytest.mark.parametrize("epilogue,bias,dtype", [
    ("none", False, torch.float32), ("none", True, torch.float32),
    ("relu", True, torch.float32), ("silu", True, torch.float32),
    ("softmax", True, torch.float32), ("softmax", False, torch.float32),
    ("softmax", True, torch.bfloat16), ("silu", True, torch.bfloat16),
])
def test_te_gemm_gradients_match_twin(dev, epilogue, bias, dtype):
    """Under grad the kernel runs inside TeGemmFunction: its output is the
    kernel's (one launch), its gradients those of autograd through the
    twin (CE-ViT's w1 shape; a softmax row of 300 columns, two passes)."""
    n = 300 if epilogue == "softmax" else 256
    gen = ofdm.make_generator(n + len(epilogue), dev)
    x = torch.randn(1024, 128, generator=gen, device=dev).to(dtype)
    w = (torch.randn(128, n, generator=gen, device=dev) / 128 ** 0.5).to(
        dtype)
    b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype) \
        if bias else None
    ins = [t.requires_grad_() for t in (x, w, b) if t is not None]
    gout = torch.randn(1024, n, generator=gen, device=dev).to(dtype)
    n0 = _build.launches["te_gemm"]
    out = te_gemm.te_gemm(x, w, b, epilogue=epilogue)
    assert _build.launches["te_gemm"] == n0 + 1
    assert type(out.grad_fn).__name__ == "TeGemmFunctionBackward"
    twin = te_gemm.te_gemm_torch(x, w, b, epilogue=epilogue)
    rtol = 1e-4 if dtype == torch.float32 else _BF16_RTOL
    _close(out.detach(), twin.detach(), rtol)
    for got, want in zip(torch.autograd.grad(out, ins, gout),
                         torch.autograd.grad(twin, ins, gout)):
        assert got.dtype == want.dtype
        _close(got, want, rtol)


@pytest.mark.parametrize("bh,s,d,causal,dtype", [
    (128, 32, 32, False, torch.float32),   # CE-ViT's full-width attention
    (16, 100, 48, True, torch.float32),
    (8, 64, 64, False, torch.bfloat16),
])
def test_mha_gradients_match_twin(dev, bh, s, d, causal, dtype):
    gen = ofdm.make_generator(bh + s + d, dev)
    q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev).to(
        dtype).requires_grad_() for _ in range(3))
    gout = torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)
    n0 = _build.launches["mha"]
    out = mha.mha(q, k, v, causal=causal)
    assert _build.launches["mha"] == n0 + 1
    assert type(out.grad_fn).__name__ == "MhaFunctionBackward"
    twin = mha.mha_torch(q, k, v, causal=causal)
    rtol = 1e-4 if dtype == torch.float32 else _BF16_RTOL
    _close(out.detach(), twin.detach(), rtol)
    for got, want in zip(torch.autograd.grad(out, (q, k, v), gout),
                         torch.autograd.grad(twin, (q, k, v), gout)):
        _close(got, want, rtol)


def test_cevit_training_step_matches_twins(dev, monkeypatch):
    """One training step's loss and gradients through the kernels (10
    te_gemm and 2 mha launches) against autograd through the twins on the
    card, the same batch and weights: loss rtol 1e-4, each leaf within
    1e-3 of its largest |grad|."""
    from repro_torch.common.params import tree_leaves
    from repro_torch.phy import models
    from repro_torch.train import neural_receiver as nr

    gcfg = ofdm.GridConfig(n_subcarriers=64, fft_size=64, pilot_stride=4)
    mcfg = models.CEViTConfig(d_model=32, heads=2, layers=2, d_ff=64)
    gen = ofdm.make_generator(0, dev)
    params = models.init_cevit(gen, mcfg)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    feats, h_true, _ = nr.make_batch(
        ofdm.make_slot(gen, gcfg, 32, 0.0), gcfg,
        nr.pilot_subcarriers(gcfg, dev), 1.0)

    def step():
        loss = nr.loss_fn(params, mcfg, feats, h_true)
        return loss, torch.autograd.grad(loss, leaves)

    _build.reset_launches()
    loss, grads = step()
    assert _build.launches["te_gemm"] == 10 and _build.launches["mha"] == 2
    monkeypatch.setattr(models, "te_gemm", te_gemm.te_gemm_torch)
    monkeypatch.setattr(models, "mha", mha.mha_torch)
    loss_t, grads_t = step()
    assert _build.launches["te_gemm"] == 10 and _build.launches["mha"] == 2
    assert float(loss.detach()) == pytest.approx(float(loss_t.detach()),
                                                 rel=1e-4)
    for got, want in zip(grads, grads_t):
        top = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-3 * top


@pytest.mark.parametrize("name,batch", [("siso-qam16-r12-snr15", 8),
                                        ("mimo2x2-qam16-r12-snr17", 8),
                                        ("mimo4x4-qam16-mu-snr18", 8),
                                        ("mimo4x4-qam16-mu-snr18", 20)])
def test_ls_che_grid_split_matches_twin(dev, name, batch):
    """Column slabs of 16 subcarriers x one tx, rows in groups of 64
    (the MU grid at batch 20 has 80 rows: two groups)."""
    scn = scenarios.get_scenario(name)
    g = scn.grid
    y = torch.fft.fft(coding.make_coded_slot(ofdm.make_generator(3, dev),
                                             scn, batch)["y_time"],
                      dim=2).contiguous()
    op = torch.from_numpy(rx_fused.make_ls_interp_operator(
        g.n_subcarriers, g.n_tx, g.pilot_stride,
        ofdm.pilot_sequence_np(g))).to(dev)
    args = (y, g.pilot_symbols, g.pilot_stride, op)
    n0 = _build.launches["ls_che"]
    got = rx_fused.ls_che(*args)
    assert _build.launches["ls_che"] == n0 + 1
    torch.testing.assert_close(got, rx_fused.ls_che_torch(*args), rtol=1e-5,
                               atol=1e-6)


def test_ls_che_late_pilot_matches_twin(dev):
    """Pilot symbols at any index and in any number (a 40-symbol slot,
    pilots at 35 and 3 given out of order, then all 40; a 72-symbol slot
    with 70): the wrapper hands the kernel a mask of n_sym bits."""
    gen = ofdm.make_generator(35, dev)
    y = torch.complex(torch.randn(2, 40, 256, 2, generator=gen, device=dev),
                      torch.randn(2, 40, 256, 2, generator=gen, device=dev))
    seq = torch.exp(1j * torch.linspace(0.0, 6.0, 256)).numpy()
    op = torch.from_numpy(rx_fused.make_ls_interp_operator(
        256, 2, 4, seq)).to(dev)
    for psym in ((35, 3), tuple(range(39, -1, -1))):  # every symbol a pilot
        args = (y, psym, 4, op)
        n0 = _build.launches["ls_che"]
        got = rx_fused.ls_che(*args)
        assert _build.launches["ls_che"] == n0 + 1
        torch.testing.assert_close(got, rx_fused.ls_che_torch(*args),
                                   rtol=1e-5, atol=1e-6)
    # symbols past 63: mask words past the first come from the device
    y72 = torch.complex(torch.randn(1, 72, 256, 2, generator=gen, device=dev),
                        torch.randn(1, 72, 256, 2, generator=gen, device=dev))
    args = (y72, tuple(range(1, 71)), 4, op)
    torch.testing.assert_close(rx_fused.ls_che(*args),
                               rx_fused.ls_che_torch(*args), rtol=1e-5,
                               atol=1e-6)


def test_neural_wrappers_reject_bad_inputs_on_card(dev):
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError, match=r"is not \(M, K\)"):
        te_gemm.te_gemm(x, torch.zeros(9, 300, device=dev),
                        epilogue="softmax")
    with pytest.raises(TypeError):
        te_gemm.te_gemm(x.double(), torch.zeros(8, 3, device=dev,
                                                dtype=torch.float64))
    with pytest.raises(ValueError, match="bias"):
        te_gemm.te_gemm(x, torch.zeros(8, 3, device=dev),
                        torch.zeros(4, device=dev))
    with pytest.raises(TypeError):
        mha.mha(*(torch.zeros(2, 8, 300, device=dev,
                              dtype=torch.float16) for _ in range(3)))


@pytest.mark.parametrize("kind", ["deeprx", "cevit"])
def test_neural_pipeline_on_card_matches_twins(dev, kind):
    scn = scenarios.get_scenario("siso-qam16-r12-snr15")
    rx = link.build_pipeline(kind, scn, device=dev, fused_rx=True)
    slot = coding.make_coded_slot(ofdm.make_generator(3, dev), scn, 2)
    _build.reset_launches()
    got = rx.run(slot)
    assert _build.launches["te_gemm"] > 0
    assert (_build.launches["mha"] > 0) == (kind == "cevit")
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    twin = link.build_pipeline(
        kind, scn, device="cpu", fused_rx=True,
        params=tree_map(cpu, rx.params))
    want = twin.run({k: cpu(v) for k, v in slot.items()})
    llr, llr_t = got["llr"].cpu(), want["llr"]
    assert float(((llr > 0) == (llr_t > 0)).float().mean()) >= 0.999
    torch.testing.assert_close(llr, llr_t, rtol=1e-3,
                               atol=1e-5 * float(llr_t.abs().max()))
    assert torch.equal(got["crc_ok"].cpu(), want["crc_ok"])


# ---------------------------------------------------------------------------
# SIC detect+demap and the int8 decoder
# ---------------------------------------------------------------------------

def _sic_case(name, dev, batch):
    """(y, h, noise_var, modem) of ``batch`` slots of a registered grid."""
    scn = scenarios.get_scenario(name)
    slot = scn.make_batch(ofdm.make_generator(6, dev), batch)
    y = torch.fft.fft(slot["y_time"], dim=2).contiguous()
    return y, slot["h"][:, 0].contiguous(), slot["noise_var"], scn.modem


def _hard(x_hat, modem):
    """Each stream's nearest level index per axis (SIC's decisions)."""
    lv = torch.tensor(modem.levels, device=x_hat.device)
    parts = torch.stack([x_hat.real, x_hat.imag], -1) * math.sqrt(modem.norm)
    return torch.argmin((parts[..., None] - lv) ** 2, dim=-1)


def _assert_sic_matches_twin(out, out_t, modem):
    """Built with -fmad=false, the kernel rounds where the twin does: its
    cancellation decisions agree and x_hat, nv_eff and the LLRs are equal
    bit for bit."""
    (x, nve, llr), (x_t, nve_t, llr_t) = out, out_t
    assert torch.equal(_hard(x, modem), _hard(x_t, modem))
    assert torch.equal(x, x_t)
    assert torch.equal(nve, nve_t)
    assert torch.equal(llr, llr_t)


@pytest.mark.parametrize("name", ["mimo4x4-qam16-mu-snr18",
                                  "mimo2x2-qam16-r12-snr17",
                                  "mimo4x8-qam64-snr24"])
def test_sic_kernel_matches_twin(dev, name):
    y, h, nv, modem = _sic_case(name, dev, 8)
    n0 = _build.launches["sic_detect_demap"]
    out = rx_fused.sic_detect_demap(y, h, nv, modem)
    assert _build.launches["sic_detect_demap"] == n0 + 1
    _assert_sic_matches_twin(out, rx_fused.sic_detect_demap_torch(
        y, h, nv, modem), modem)


def test_sic_kernel_ragged_batch(dev):
    # 100 subcarriers: each batch row's last tile holds 4 of 16
    gen = ofdm.make_generator(8, dev)
    cg = lambda *s: torch.complex(torch.randn(*s, generator=gen, device=dev),
                                  torch.randn(*s, generator=gen, device=dev))
    y, h = cg(3, 14, 100, 4), cg(3, 100, 4, 4)
    nv = torch.tensor(0.05, device=dev)
    modem = ofdm.make_modem("qam16")
    _assert_sic_matches_twin(rx_fused.sic_detect_demap(y, h, nv, modem),
                             rx_fused.sic_detect_demap_torch(y, h, nv, modem),
                             modem)


@pytest.mark.parametrize("b,n_sc,n_rx,n_tx,modem_name", [
    (2, 64, 2, 1, "qpsk"), (2, 64, 4, 2, "qam16"), (2, 64, 3, 3, "qam64"),
    (2, 64, 8, 6, "qam16"), (3, 100, 3, 3, "qam256"),  # ragged tiles
    (3, 100, 1, 1, "qam16"), (3, 100, 2, 2, "qpsk"),
    (3, 100, 8, 4, "qam64"), (3, 100, 4, 4, "qam16"),
    (1, 17, 4, 4, "qam16"),  # a tile of one subcarrier past a full one
    (2, 256, 4, 4, "qam16"),  # the MU grid at a served batch of 2
    (2, 64, 6, 6, "qam16"),  # runtime-sized, in shared memory
    (2, 64, 8, 8, "qam16"),  # SIC stages past 6 streams, in shared memory
    (1, 16, 20, 20, "qpsk")])  # state past shared memory: the workspace
def test_demap_kernels_any_shape_bit_exact(dev, b, n_sc, n_rx, n_tx,
                                           modem_name):
    """Joint and SIC at any (n_rx, n_tx): the compiled instances and the
    runtime-sized route (its state in shared memory, or in the wrapper's
    workspace where a block's would not fit) hold the twins bit for bit
    (the library is built with -fmad=false), at batches whose subcarriers
    end in a ragged tile."""
    gen = ofdm.make_generator(b * 100 + n_rx * 10 + n_tx, dev)
    cg = lambda *s: torch.complex(torch.randn(*s, generator=gen, device=dev),
                                  torch.randn(*s, generator=gen, device=dev))
    y, h = cg(b, 14, n_sc, n_rx), cg(b, n_sc, n_rx, n_tx)
    nv = torch.tensor(0.05, device=dev)
    modem = ofdm.make_modem(modem_name)
    for kernel, twin, counter in (
            (rx_fused.mmse_detect_demap, rx_fused.mmse_detect_demap_torch,
             "mmse_detect_demap"),
            (rx_fused.sic_detect_demap, rx_fused.sic_detect_demap_torch,
             "sic_detect_demap")):
        n0 = _build.launches[counter]
        got = kernel(y, h, nv, modem)
        assert _build.launches[counter] == n0 + 1
        want = twin(y, h, nv, modem)
        for g_, w_ in zip(got, want):
            assert g_.shape == w_.shape
            assert torch.equal(g_, w_), counter


def _code_llrs(rate, n_cw, snr_db, dev, seed=7):
    code = coding.make_code(rate)
    gen = ofdm.make_generator(seed, dev)
    bits = torch.randint(0, 2, (n_cw, code.k), generator=gen, device=dev)
    tx = coding.rate_match(code, coding.encode(code, bits)).float()
    s2 = 10.0 ** (-snr_db / 10.0)
    y = (2 * tx - 1) + math.sqrt(s2) * torch.randn(tx.shape, generator=gen,
                                                   device=dev)
    return code, coding.derate_match(code, 2.0 * y / s2).contiguous()


# a code with layers of 17-18 edges: past the segment kernels' 16
_WIDE = {"k_b": 16, "col_degree": 8}


@pytest.mark.parametrize("rate,z,kw,snr_db,precision", [
    ("r12", 16, {}, 2.0, None), ("r12", 32, {}, 2.0, None),
    ("r34", 16, {}, 4.0, None),
    # 85 KB of state for four codewords of the earlier design
    ("r12", 64, {}, 2.0, None),
    # 5G's largest lifting size: rows past one block (the row kernels,
    # check messages in the global workspace)
    ("r12", 384, {}, 3.0, None), ("r12", 512, {}, 3.0, None),
    ("r34", 32, _WIDE, 6.0, None),
    ("r12", 16, {}, 2.0, "int8"), ("r34", 8, {}, 4.0, "int8"),
    ("r12", 32, {}, 2.0, "int8"), ("r12", 64, {}, 2.0, "int8"),
    ("r12", 384, {}, 3.0, "int8"), ("r12", 512, {}, 3.0, "int8"),
    ("r34", 32, _WIDE, 6.0, "int8"),
])
def test_ldpc_kernels_any_lifting_size(dev, rate, z, kw, snr_db, precision):
    """Both decoders at any z and any layer width (a block per codeword;
    past the segment kernels' codes, the row kernels with the messages
    in a workspace): posteriors and iteration counts equal to the
    twin's."""
    code = coding.make_code(rate, z=z, **kw)
    if kw:
        assert max(map(len, code.layers())) > 16
    gen = ofdm.make_generator(z, dev)
    bits = torch.randint(0, 2, (64, code.k), generator=gen, device=dev)
    tx = coding.rate_match(code, coding.encode(code, bits)).float()
    s2 = 10.0 ** (-snr_db / 10.0)
    y = (2 * tx - 1) + math.sqrt(s2) * torch.randn(tx.shape, generator=gen,
                                                   device=dev)
    llr = coding.derate_match(code, 2.0 * y / s2).contiguous()
    post, iters = ldpc.ldpc_decode(llr, code, precision=precision)
    post_t, iters_t = ldpc.ldpc_decode_torch(llr, code, precision=precision)
    assert torch.equal(iters, iters_t)
    assert torch.equal(post, post_t)
    assert len(torch.unique(iters)) > 1


@pytest.mark.parametrize("rate,snr_db,gain,n_cw", [
    ("r12", 3.0, 1.0, 216), ("r12", -6.0, 1.0, 216), ("r34", 6.0, 1.0, 216),
    ("r34", -6.0, 1.0, 216), ("r12", 3.0, 8.0, 216),  # saturating
    ("r34", 6.0, 1.0, 5),  # a few codewords
])
def test_int8_ldpc_kernel_matches_twin_exactly(dev, rate, snr_db, gain,
                                               n_cw):
    code, llr = _code_llrs(rate, n_cw, snr_db, dev)
    llr = llr * gain
    before = dict(_build.launches)
    post, iters = ldpc.ldpc_decode(llr, code, precision="int8")
    assert _build.launches["ldpc_decode_q"] == \
        before.get("ldpc_decode_q", 0) + 1
    assert _build.launches["ldpc_decode"] == before.get("ldpc_decode", 0)
    post_t, iters_t = ldpc.ldpc_decode_torch(llr, code, precision="int8")
    assert torch.equal(iters, iters_t)
    assert torch.equal(post, post_t)


@pytest.mark.parametrize("name,kw,kernels", [
    ("mimo4x4-qam16-mu-snr18", dict(fused=True, sic=True),
     ("ls_che", "sic_detect_demap", "ldpc_decode")),
    ("siso-qam16-r12-snr15", dict(fused=True, precision="int8"),
     ("ls_che", "mmse_detect_demap", "ldpc_decode_q")),
])
def test_sic_and_int8_pipelines_on_card_match_twins(dev, name, kw, kernels):
    scn = scenarios.get_scenario(name)
    rx = link.build_classical(scn, device=dev, **kw)
    slot = coding.make_coded_slot(ofdm.make_generator(3, dev), scn, 2)
    _build.reset_launches()
    got = rx.run(slot)
    assert {k for k, n in _build.launches.items() if n > 0} == set(kernels)
    cpu = lambda t: t.cpu() if isinstance(t, torch.Tensor) else t
    want = link.build_classical(scn, device="cpu", **kw).run(
        {k: cpu(v) for k, v in slot.items()})
    for k in ("crc_ok", "info_bits_hat", "decode_iters"):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert int(((got["llr"].cpu() > 0) != (want["llr"] > 0)).sum()) <= 2


# ---------------------------------------------------------------------------
# the paper's compute blocks and the quantized ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,epilogue,bias,precision,out_dtype", [
    (256, 256, 256, "none", False, "int8", torch.float32),
    (256, 256, 256, "relu", True, "int8", torch.float32),
    (256, 256, 256, "softmax", False, "int8", torch.float32),
    (256, 256, 256, "none", False, "fp8", torch.float32),
    (256, 256, 256, "softmax", True, "fp8", torch.float32),
    (28672, 288, 32, "none", True, "int8", torch.float32),  # DeepRx conv
    (28672, 288, 32, "relu", True, "fp8", torch.float32),
    (777, 100, 33, "silu", True, "int8", torch.float32),     # ragged
    (512, 64, 128, "relu", True, "fp8", torch.bfloat16),
    (1000, 288, 32, "none", False, "int8", torch.float32),  # M % 64 != 0
    (256, 256, 256, "softmax", True, "int8", torch.float32),
    (512, 64, 300, "softmax", True, "int8", torch.float32),   # two passes
    (512, 64, 300, "softmax", False, "fp8", torch.bfloat16),
])
def test_te_gemm_quant_kernel_matches_twin(dev, m, k, n, epilogue, bias,
                                           precision, out_dtype):
    gen = ofdm.make_generator(m + k + n, dev)
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
    b = 0.1 * torch.randn(n, generator=gen, device=dev) if bias else None
    codes = te_gemm.quantize_gemm_operands(x, w, precision)
    n0 = _build.launches["te_gemm_quant"]
    got = te_gemm.te_gemm_quantized(*codes, b, epilogue=epilogue,
                                    out_dtype=out_dtype)
    assert _build.launches["te_gemm_quant"] == n0 + 1
    assert got.dtype == out_dtype and tuple(got.shape) == (m, n)
    want = te_gemm.te_gemm_quantized_torch(*codes, b, epilogue=epilogue,
                                           out_dtype=out_dtype)
    if precision == "int8" and epilogue in ("none", "relu") and \
            out_dtype == torch.float32:
        assert torch.equal(got, want)  # exact product, the twin's order
    else:
        _close(got, want, 1e-4 if out_dtype == torch.float32
               else _BF16_RTOL)


@pytest.mark.parametrize("bh,sq,sk,d,causal,precision,out_dtype", [
    (4, 256, 256, 64, True, "int8", torch.float32),
    (4, 256, 256, 64, True, "fp8", torch.float32),
    (32, 64, 64, 16, False, "int8", torch.float32),  # CE-ViT
    (8, 200, 200, 128, True, "fp8", torch.float32),  # ragged tiles
    (4, 70, 130, 32, False, "int8", torch.float32),
    (16, 256, 256, 64, False, "int8", torch.bfloat16),
    (4, 128, 128, 48, True, "int8", torch.float32),  # D zero-padded to 64
    (8, 64, 64, 80, False, "fp8", torch.float32),    # D zero-padded to 128
    (4, 128, 128, 384, True, "int8", torch.float32),  # three slabs of 128
    (2, 70, 90, 300, False, "fp8", torch.bfloat16),
    (3, 70, 130, 64, False, "int8", torch.float32),   # ragged Sq, Sk
    (3, 130, 70, 16, True, "fp8", torch.bfloat16),    # causal, Sq > Sk
    (2, 100, 150, 48, True, "fp8", torch.float32),    # causal, Sq < Sk
    (2, 90, 200, 384, False, "fp8", torch.float32),
    (4, 64, 64, 300, True, "int8", torch.float32),
    (2, 130, 66, 80, True, "int8", torch.bfloat16),
    (1, 64, 512, 16, False, "int8", torch.float32),   # a cluster of 8
])
def test_mha_quant_kernel_matches_twin(dev, bh, sq, sk, d, causal,
                                       precision, out_dtype):
    gen = ofdm.make_generator(bh + sq + d, dev)
    q = torch.randn(bh, sq, d, generator=gen, device=dev)
    k, v = (torch.randn(bh, sk, d, generator=gen, device=dev)
            for _ in range(2))
    codes = mha.quantize_mha_operands(q, k, v, precision)
    n0 = _build.launches["mha_quant"]
    got = mha.mha_quantized(*codes, causal=causal, out_dtype=out_dtype)
    assert _build.launches["mha_quant"] == n0 + 1
    assert got.dtype == out_dtype and tuple(got.shape) == (bh, sq, d)
    _close(got, mha.mha_quantized_torch(*codes, causal=causal,
                                        out_dtype=out_dtype),
           1e-4 if out_dtype == torch.float32 else _BF16_RTOL)


@pytest.mark.parametrize("m,k,n,bias,dtype", [
    (512, 512, 512, True, torch.float32),   # the paper's FC block
    (256, 384, 512, True, torch.float32),
    (37, 45, 333, True, torch.float32),     # ragged
    (512, 512, 100, False, torch.float32),
    (512, 512, 512, True, torch.bfloat16),
    (512, 512, 64, True, torch.float32),    # a cluster of one block
    (37, 45, 333, True, torch.bfloat16),    # K, N not 16-byte rows
    (512, 128, 600, True, torch.float32),   # wider than a cluster
    (64, 64, 600, True, torch.bfloat16),
])
def test_fc_softmax_kernel_matches_twin(dev, m, k, n, bias, dtype):
    gen = ofdm.make_generator(m + k + n, dev)
    x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(dtype)
    b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype) \
        if bias else None
    # a row wider than a cluster holds runs on te_gemm's two passes
    which = "fc_softmax" if n <= fc_softmax.MAX_N else "te_gemm"
    n0 = _build.launches[which]
    got = fc_softmax.fc_softmax(x, w, b)
    assert _build.launches[which] == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (m, n)
    _close(got, fc_softmax.fc_softmax_torch(x, w, b),
           1e-4 if dtype == torch.float32 else _BF16_RTOL)


@pytest.mark.parametrize("b,h,w,c,f,dtype", [
    (1, 32, 16, 512, 512, torch.float32),   # the paper's block
    (2, 16, 8, 128, 128, torch.float32),
    (3, 5, 7, 70, 100, torch.float32),      # ragged C, F and pixels
    (1, 32, 16, 512, 512, torch.bfloat16),
    (1, 16, 16, 256, 768, torch.float32),   # slabs of 128, a cluster of 6
    (1, 8, 8, 256, 1536, torch.float32),    # past 1024: two passes
    (2, 5, 7, 70, 4096, torch.float32),     # two passes, ragged
    (1, 8, 8, 64, 1100, torch.bfloat16),
    (1, 4, 4, 16, 8200, torch.float32),     # past a cluster of 8: two passes
    (1, 8, 8, 64, 12288, torch.bfloat16),
    (2, 9, 33, 13, 7, torch.bfloat16),      # C and F padded by the wrapper
    (1, 3, 100, 24, 40, torch.float32),     # tiles of 1 x 64 pixels
])
def test_dwconv_block_kernel_matches_twin(dev, b, h, w, c, f, dtype):
    gen = ofdm.make_generator(b + h + c + f, dev)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    args = (r(b, h + 2, w + 2, c).to(dtype), 0.2 * r(3, 3, c),
            r(c, f) / c ** 0.5, 1.0 + 0.1 * r(f), 0.1 * r(f))
    n0 = _build.launches["dwconv_block"]
    got = dwconv_block.dwconv_block(*args)
    assert _build.launches["dwconv_block"] == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, h, w, f)
    assert bool((got >= 0).all())
    _close(got, dwconv_block.dwconv_block_torch(*args),
           1e-4 if dtype == torch.float32 else _BF16_RTOL)


def test_block_plans_on_card_agree(dev):
    gen = ofdm.make_generator(5, dev)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    _build.reset_launches()
    x, w, b = r(512, 512), r(512, 512) / 512 ** 0.5, 0.1 * r(512)
    torch.testing.assert_close(pool.fc_softmax_sequential(x, w, b),
                               pool.fc_softmax_concurrent(x, w, b),
                               rtol=2e-4, atol=1e-5)
    dw = (r(1, 34, 18, 512), 0.2 * r(3, 3, 512), r(512, 512) / 512 ** 0.5,
          torch.ones(512, device=dev), torch.zeros(512, device=dev))
    torch.testing.assert_close(pool.dwconv_sequential(*dw),
                               pool.dwconv_concurrent(*dw),
                               rtol=5e-4, atol=5e-4)
    q, k, v = r(4, 128, 128), r(4, 128, 128), r(4, 128, 128)
    torch.testing.assert_close(pool.mha_sequential(q, k, v),
                               pool.mha_concurrent(q, k, v),
                               rtol=2e-5, atol=2e-5)
    assert ops.te_gemm_quant(x, w, b).dtype == torch.float32
    assert ops.mha_quant(q[:, :, :64], k[:, :, :64], v[:, :, :64],
                         precision="fp8").shape == (4, 128, 64)
    assert {k for k, n in _build.launches.items() if n > 0} == {
        "te_gemm", "fc_softmax", "dwconv_block", "mha", "te_gemm_quant",
        "mha_quant"}


def test_block_wrappers_reject_bad_inputs_on_card(dev):
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(TypeError):
        fc_softmax.fc_softmax(x.double(), torch.zeros(8, 513, device=dev,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match=r"is not \(M, K\)"):
        fc_softmax.fc_softmax(x, torch.zeros(9, 513, device=dev))
    with pytest.raises(ValueError, match="bias"):
        te_gemm.te_gemm_quant(x, torch.ones(8, 300, device=dev),
                              torch.zeros(3, device=dev),
                              epilogue="softmax")
    with pytest.raises(ValueError, match="do not fit"):
        dwconv_block.dwconv_block(
            torch.zeros(1, 4, 4, 8, device=dev),
            torch.zeros(3, 3, 8, device=dev),
            torch.zeros(8, 9000, device=dev), torch.zeros(9001, device=dev),
            torch.zeros(9000, device=dev))
    q = torch.zeros(2, 8, 300, device=dev)
    with pytest.raises(TypeError):
        mha.mha_quantized(q, q, q, *(torch.ones(2, 1, device=dev),) * 3)


# ---------------------------------------------------------------------------
# detect + demap past 4 bits per axis
# ---------------------------------------------------------------------------

def _qam1024():
    """1024-QAM built the way qam256 is: binary-reflected Gray over 32
    amplitudes, levels[gray(k)] = 2k - 31, norm 2 (32^2 - 1) / 3."""
    levels = [0.0] * 32
    for k in range(32):
        levels[k ^ (k >> 1)] = 2.0 * k - 31.0
    return ofdm.Modem("qam1024", 10, tuple(levels), 682.0)


@pytest.mark.parametrize("b,n_sc,n_rx,n_tx", [
    (2, 64, 1, 1), (2, 64, 2, 2), (3, 100, 3, 3)])
def test_demap_kernels_qam1024_bit_exact(dev, b, n_sc, n_rx, n_tx):
    """A 5-bit-per-axis modem runs the runtime-sized instance at every
    antenna shape, registered or not, and holds the twins bit for bit."""
    gen = ofdm.make_generator(1024 + n_rx, dev)
    modem = _qam1024()
    bits = torch.randint(0, 2, (b, 14, n_sc, n_tx, 10), generator=gen,
                         device=dev, dtype=torch.int32)
    h = torch.complex(torch.randn(b, n_sc, n_rx, n_tx, generator=gen,
                                  device=dev),
                      torch.randn(b, n_sc, n_rx, n_tx, generator=gen,
                                  device=dev)) / math.sqrt(2.0)
    nv = torch.tensor(n_tx * 10.0 ** (-3.4), device=dev)
    y = torch.einsum("bsrt,bmst->bmsr", h, modem.mod(bits))
    y = (y + torch.complex(torch.randn(y.shape, generator=gen, device=dev),
                           torch.randn(y.shape, generator=gen, device=dev))
         * torch.sqrt(nv / 2.0)).contiguous()
    for kernel, twin, counter in (
            (rx_fused.mmse_detect_demap, rx_fused.mmse_detect_demap_torch,
             "mmse_detect_demap"),
            (rx_fused.sic_detect_demap, rx_fused.sic_detect_demap_torch,
             "sic_detect_demap")):
        n0 = _build.launches[counter]
        got = kernel(y, h, nv, modem)
        assert _build.launches[counter] == n0 + 1
        want = twin(y, h, nv, modem)
        assert got[2].shape == (b, 14, n_sc, n_tx, 10)
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_), counter


# ---------------------------------------------------------------------------
# the executable registry: graph replay against the eager chain
# ---------------------------------------------------------------------------

_SERVED = [  # each receiver chip_smoke.py serves, and its kernels
    ("siso-qam16-r12-snr15", "classical", dict(fused=True),
     {"ls_che", "mmse_detect_demap", "ldpc_decode"}),
    ("mimo4x4-qam16-mu-snr18", "classical", dict(fused=True, sic=True),
     {"ls_che", "sic_detect_demap", "ldpc_decode"}),
    ("siso-qam16-r12-snr15", "classical", dict(fused=True, precision="int8"),
     {"ls_che", "mmse_detect_demap", "ldpc_decode_q"}),
    ("siso-qam16-r12-snr15", "cevit", dict(fused_rx=True),
     {"te_gemm", "mha", "mmse_detect_demap", "ldpc_decode"}),
    ("siso-qam16-r12-snr15", "deeprx", {}, {"te_gemm", "ldpc_decode"}),
]
_SYMBOLS = {  # each counter's kernel, by its device symbol
    "ls_che": "ls_che_kernel", "mmse_detect_demap": "detect_demap_kernel",
    "sic_detect_demap": "sic_demap_kernel",
    "ldpc_decode": "ldpc_minsum_kernel",
    "ldpc_decode_q": "ldpc_minsum_q_kernel", "te_gemm": "te_gemm_kernel",
    "mha": "mha_kernel"}


def _served_batch(scn, dev, seed, rv, batch=2):
    """``batch`` users' HARQ slots stacked as the scheduler stacks them,
    a nonzero combining prior on a retransmission."""
    from repro_torch.serve.runtime import TorchSlotFactory, stack_slots

    factory = TorchSlotFactory(dev)
    slots = []
    for u in range(batch):
        slot = factory(seed + u, scn, 1, rv=rv)
        gen = ofdm.make_generator(seed + u, dev)
        slot["prior_llr"] = rv * torch.randn(
            (1, coding.codewords_per_slot(scn), scn.code.n_mother),
            generator=gen, device=dev)
        slots.append(slot)
    return stack_slots(slots)


@pytest.mark.parametrize("name,kind,kw,kernels", _SERVED)
def test_registry_replay_equals_eager_run(dev, name, kind, kw, kernels):
    """A graph-replayed batch equals ``pipeline.run`` of the same batch bit
    for bit, a second replay on other inputs equals their eager run, k
    replays count k times the capture's launches, and a CUPTI trace of k
    replays holds each of the pipeline's kernels, as often as counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.exec_registry import ExecRegistry, template_batch

    scn = scenarios.get_scenario(name)
    rx = link.build_pipeline(kind, scn, device=dev, **kw)
    reg = ExecRegistry()
    step = reg.acquire_pipeline_step(
        rx, template_batch(scn, 2, harq=True, device=dev), batch=2)
    assert step.graph is not None
    assert set(step.launch_delta) == kernels
    for seed, rv in ((11, 0), (23, 1)):
        batch = _served_batch(scn, dev, seed, rv)
        got = {k: v.clone() for k, v in step(batch).items()
               if isinstance(v, torch.Tensor)}
        want = rx.run(batch)
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), (k, seed)
    _build.reset_launches()
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {
        k: 3 * n for k, n in step.launch_delta.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    for k, n in step.launch_delta.items():
        assert sum(_SYMBOLS[k] in name for name in names) == 3 * n, k
    assert reg.stats.executables_compiled == 1


# ---------------------------------------------------------------------------
# multi-cell steps: a noise variance per lane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rx,n_tx,modem_name", [
    (1, 1, "qam16"), (2, 2, "qam16"), (4, 4, "qam16"),
    (3, 3, "qam64")])  # the last: the runtime-sized instance
def test_demap_kernels_per_lane_noise_bit_exact(dev, n_rx, n_tx, modem_name):
    """B = 6 rows as L = 3 lanes of 2, each lane with its own noise
    variance: joint and SIC equal their twins bit for bit, and each lane's
    rows equal a one-value launch on that lane's slice."""
    gen = ofdm.make_generator(300 + 10 * n_rx + n_tx, dev)
    cg = lambda *s: torch.complex(torch.randn(*s, generator=gen, device=dev),
                                  torch.randn(*s, generator=gen, device=dev))
    y, h = cg(6, 14, 64, n_rx).contiguous(), cg(6, 64, n_rx, n_tx)
    nv = torch.tensor([0.02, 0.1, 0.5], device=dev) * n_tx
    modem = ofdm.make_modem(modem_name)
    for kernel, twin in ((rx_fused.mmse_detect_demap,
                          rx_fused.mmse_detect_demap_torch),
                         (rx_fused.sic_detect_demap,
                          rx_fused.sic_detect_demap_torch)):
        got = kernel(y, h, nv, modem)
        for g_, w_ in zip(got, twin(y, h, nv, modem)):
            assert torch.equal(g_, w_), kernel.__name__
        for lane in range(3):
            rows = slice(2 * lane, 2 * lane + 2)
            one = kernel(y[rows].contiguous(), h[rows].contiguous(),
                         nv[lane], modem)
            for g_, w_ in zip(got, one):
                assert torch.equal(g_[rows], w_), (kernel.__name__, lane)
        # a lane's nv_eff depends on its own noise: the lanes differ
        assert not torch.equal(got[1][0], got[1][2])


def test_demap_kernels_one_value_launch_unchanged(dev):
    """One value as a 0-d tensor or a (1,) tensor gives the same bits, and
    a noise count that divides no lane share is refused."""
    y, h, nv, modem = _sic_case("mimo4x4-qam16-mu-snr18", dev, 4)
    for kernel in (rx_fused.mmse_detect_demap, rx_fused.sic_detect_demap):
        a = kernel(y, h, nv, modem)
        b_ = kernel(y, h, nv.reshape(1), modem)
        for g_, w_ in zip(a, b_):
            assert torch.equal(g_, w_)
        with pytest.raises(ValueError, match="noise"):
            kernel(y, h, torch.ones(3, device=dev), modem)


def test_demap_kernels_refuse_strided_noise_view(dev):
    """A strided (3,) noise view (a column of a wider tensor) is refused,
    never read at the wrong stride; its contiguous copy gives the twin's
    bits lane by lane."""
    gen = ofdm.make_generator(341, dev)
    cg = lambda *s: torch.complex(torch.randn(*s, generator=gen, device=dev),
                                  torch.randn(*s, generator=gen, device=dev))
    y, h = cg(6, 14, 64, 2), cg(6, 64, 2, 2)
    wide = torch.tensor([[0.04, 9.0], [0.2, 9.0], [1.0, 9.0]], device=dev)
    nv = wide[:, 0]
    assert not nv.is_contiguous()
    modem = ofdm.make_modem("qam16")
    for kernel, twin in ((rx_fused.mmse_detect_demap,
                          rx_fused.mmse_detect_demap_torch),
                         (rx_fused.sic_detect_demap,
                          rx_fused.sic_detect_demap_torch)):
        with pytest.raises(ValueError, match="not contiguous"):
            kernel(y, h, nv, modem)
        got = kernel(y, h, nv.contiguous(), modem)
        for g_, w_ in zip(got, twin(y, h, nv, modem)):
            assert torch.equal(g_, w_), kernel.__name__


@pytest.mark.parametrize("name,kw", [
    ("siso-qam16-r12-snr15", dict(fused=True)),
    ("mimo4x4-qam16-mu-snr18", dict(fused=True, sic=True))])
def test_lane_step_replay_equals_eager_and_single_steps(dev, name, kw):
    """A captured three-lane step (lanes of distinct noise variance) equals
    its eager run bit for bit, and each lane equals the captured
    single-cell step on its slots: CRC flags, payloads, iteration counts
    and LLRs bit for bit, h_hat at rtol 1e-4."""
    from repro_torch.launch.mesh import make_cell_mesh
    from repro_torch.serve.cell_mesh import stage_lanes
    from repro_torch.serve.exec_registry import ExecRegistry, lane_step
    from repro_torch.serve.runtime import TorchSlotFactory, stack_slots

    scn = scenarios.get_scenario(name)
    rx = link.build_pipeline("classical", scn, device=dev, **kw)
    factory = TorchSlotFactory(dev)
    lanes = []
    for lane in range(3):
        slots = []
        for u in range(2):
            s = factory(50 + 10 * lane + u,
                        scn.replace(snr_db=scn.snr_db + 2.0 * lane), 1, rv=0)
            s["prior_llr"] = torch.zeros(  # a host array, as a loop's
                (1, coding.codewords_per_slot(scn), scn.code.n_mother)
            ).numpy()
            slots.append(s)
        lanes.append((slots, 0))
    (shard,) = stage_lanes(lanes, make_cell_mesh(3, dev))
    staged = shard.staged
    assert len(set(staged["noise_var"].tolist())) == 3
    reg = ExecRegistry()
    step = reg.acquire_pipeline_step(rx, staged, batch=2, lanes=3)
    assert step.graph is not None
    # the reference's rule: a lane step on the card donates its inputs
    assert [k.donate for k in reg.keys()] == [True]
    got = {k: v.clone() for k, v in step(staged).items()
           if isinstance(v, torch.Tensor)}
    eager = lane_step(rx, 3, 2)(staged)
    torch.cuda.synchronize()
    for k, v in eager.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
    for lane, (slots, _) in enumerate(lanes):
        batch = stack_slots(slots)
        one = reg.acquire_pipeline_step(rx, batch, batch=2)
        want = {k: v.clone() for k, v in one(batch).items()
                if isinstance(v, torch.Tensor)}
        for k in ("crc_ok", "info_bits_hat", "decode_iters", "llr"):
            assert torch.equal(got[k][lane], want[k]), (lane, k)
        torch.testing.assert_close(got["h_hat"][lane], want["h_hat"],
                                   rtol=1e-4, atol=1e-6)


def test_grid_shards_equal_one_device_lane_step(dev):
    """A bucket of two lanes of distinct noise variance staged on a (2, 1)
    grid that repeats cuda:0 (one shard, one captured graph an entry,
    both replays launched before either is read) equals the one-device
    mesh's lane step on the same lanes: CRC flags, payloads, iteration
    counts, LLRs and combined LLRs bit for bit."""
    import numpy as np

    from repro_torch.launch.mesh import make_cell_mesh
    from repro_torch.serve.cell_mesh import (
        _acquire_steps, _launch, gather_lanes, stage_lanes,
    )
    from repro_torch.serve.exec_registry import ExecRegistry, ExecStats
    from repro_torch.serve.runtime import TorchSlotFactory

    card = torch.device("cuda", 0)
    scn = scenarios.get_scenario("siso-qam16-r12-snr15")
    rx = link.build_pipeline("classical", scn, device=card, fused=True)
    factory = TorchSlotFactory(card)
    lanes = []
    for lane in range(2):
        slots = []
        for u in range(2):
            s = factory(70 + 10 * lane + u,
                        scn.replace(snr_db=scn.snr_db + 3.0 * lane), 1, rv=0)
            s["prior_llr"] = torch.zeros(
                (1, coding.codewords_per_slot(scn), scn.code.n_mother)
            ).numpy()
            slots.append(s)
        lanes.append((slots, 0))
    grid = make_cell_mesh(2, devices=[card, card])
    assert grid.shape == (2, 1) and grid.distinct_devices() == [card]
    shards = stage_lanes(lanes, grid)
    assert [(sh.entry, sh.lanes) for sh in shards] == \
        [((0, 0), slice(0, 1)), ((1, 0), slice(1, 2))]
    reg = ExecRegistry()
    steps = _acquire_steps(reg, {card: rx}, shards, grid, ExecStats())
    assert len(reg) == 2 and steps[0] is not steps[1]
    assert all(st.graph is not None for st in steps)
    outs = _launch(steps, shards)
    torch.cuda.synchronize()
    (one,) = stage_lanes(lanes, make_cell_mesh(2, devices=[card]))
    step = reg.acquire_pipeline_step(rx, one.staged, batch=2, lanes=2)
    want = step(one.staged)
    torch.cuda.synchronize()
    for k in ("crc_ok", "info_bits_hat", "decode_iters", "llr", "cw_llr"):
        got = gather_lanes(shards, outs, k, 2)
        assert np.array_equal(got, want[k].cpu().numpy()), k


# ---------------------------------------------------------------------------
# supervised serving: snapshots of card-resident HARQ state, the
# zero-fault identity and the degradation step at the full grid
# ---------------------------------------------------------------------------

def test_cell_loop_snapshot_keeps_card_payloads(dev, tmp_path):
    """A HARQ payload on the card survives a checkpoint round trip as the
    slot builder made it (dtype and device), and a retransmission of the
    restored loop re-encodes the same slot as the original's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.serve.runtime import CellLoop, cell_rng
    from repro_torch.serve.supervisor import (
        restore_cell_loop, snapshot_cell_loop,
    )

    rungs = scenarios.get_ladder("siso-coded").scenarios()
    src = CellLoop(rungs, rng=cell_rng(0), n_users=2, batch_size=2,
                   device=dev)
    src.inject_backlog(2)
    for u in src.users:
        src.make_slot(u, u.backlog[0], 0)  # opens the HARQ process
    infos = [u.backlog[0].harq.info for u in src.users]
    assert all(i.is_cuda for i in infos)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {src.name: snapshot_cell_loop(src)})
    dst = CellLoop(rungs, rng=cell_rng(5), n_users=2, batch_size=2,
                   device=dev)
    restore_cell_loop(dst, {k.split("/", 1)[1]: v
                            for k, v in mgr.load_flat(1).items()})
    for u, want in zip(dst.users, infos):
        got = u.backlog[0].harq.info
        assert got.device == want.device and got.dtype == want.dtype
        assert torch.equal(got, want)
    for us, ud in zip(src.users, dst.users):
        a = src.make_slot(us, us.backlog[0], 0)
        b = dst.make_slot(ud, ud.backlog[0], 0)
        for k in ("info_bits", "bits", "y_time"):
            assert torch.equal(a[k], b[k]), k


def _two_fused_cells():
    from repro_torch.serve import closed_cell

    return [closed_cell(f"c{i}", "siso-coded", n_users=4, arrival_rate=0.8,
                        snr_db=8.0 + i, fused=True) for i in range(2)]


_SUP_KW = dict(batch_size=4, max_retx=2, seed=3)


def test_zero_fault_supervised_mesh_equals_unsupervised(dev):
    import dataclasses

    from repro_torch.serve import (
        ExecRegistry, FaultPlan, MeshSlotScheduler, Supervisor,
    )

    wall = {"wall_s", "slots_per_sec", "goodput_bits_per_sec",
            "compile_time_s", "executables_compiled", "cache_hits",
            "first_tick_s", "steady_tick_s"}

    def strip(rep):
        d = {k: v for k, v in dataclasses.asdict(rep).items()
             if k not in wall}
        d["cells"] = {n: {k: v for k, v in c.items() if k not in wall}
                      for n, c in d["cells"].items()}
        return d

    runs = [cls(_two_fused_cells(), registry=ExecRegistry(), device=dev,
                **kw, **_SUP_KW).run(4)
            for cls, kw in ((MeshSlotScheduler, {}),
                            (Supervisor, {"fault_plan": FaultPlan.none()}))]
    assert strip(runs[0]) == strip(runs[1])
    assert runs[1].n_slots > 0 and runs[1].degraded_batches == 0
    assert runs[1].step_retries == runs[1].quarantined_batches == 0


def test_corrupted_lane_degrades_to_finite_llrs(dev):
    """A NaN burst in one lane's staged prior at the full ``siso-coded``
    grid: the lane is rerun on the fp32 unfused reference step (a CUDA
    graph of the plain stages and the fp32 decoder), whose combined LLRs
    are finite, and the run goes on with every HARQ buffer finite."""
    import numpy as np

    from repro_torch.serve import (
        ExecRegistry, FaultEvent, FaultPlan, Supervisor,
    )

    sup = Supervisor(_two_fused_cells(), registry=ExecRegistry(),
                     device=dev, fault_plan=FaultPlan(
                         [FaultEvent("nan_llr", tick=1, seq=0, cell=0)]),
                     **_SUP_KW)
    rep = sup.run(3)
    assert rep.faults_injected == 1 and rep.degraded_batches == 1
    assert rep.quarantined_batches == 0
    ((key, (ref,)),) = sup._ref_execs.items()
    assert ref.graph is not None and ref.replays == 1
    assert set(ref.launch_delta) == {"ldpc_decode"}
    assert torch.isfinite(ref.out["cw_llr"]).all()
    for loop in sup.loops:
        for u in loop.users:
            for j in u.backlog:
                if j.harq is not None:
                    assert np.isfinite(j.harq.prior).all()


def test_unfused_group_degrades_through_its_own_lane_step(dev):
    """An unfused fp32 group's degradation step is its own lane step: the
    registry's key is the same for both, so a NaN lane replays the primary
    graph once more instead of capturing a second one."""
    from repro_torch.serve import (
        ExecRegistry, FaultEvent, FaultPlan, Supervisor, closed_cell,
    )

    cells = [closed_cell(f"u{i}", "siso-coded", n_users=4, arrival_rate=0.8,
                         snr_db=8.0 + i) for i in range(2)]
    reg = ExecRegistry()
    sup = Supervisor(cells, registry=reg, device=dev, fault_plan=FaultPlan(
        [FaultEvent("nan_llr", tick=1, seq=0, cell=0)]), **_SUP_KW)
    rep = sup.run(3)
    assert rep.faults_injected == 1 and rep.degraded_batches == 1
    ((key, (ref,)),) = sup._ref_execs.items()
    assert any(ref is st for (st,) in sup.groups[key[0]]._execs.values())
    assert len(reg) == len(sup.groups[0]._execs)
    assert ref.graph is not None and torch.isfinite(ref.out["cw_llr"]).all()


# ---------------------------------------------------------------------------
# the kernels' launch choices (repro_torch.kernels.tune and the pickers)
# ---------------------------------------------------------------------------

def _exact(got, want):
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


def _tune_operands(op, dev):
    """One tuned op at a reduced main-path shape: ``call(choice)``, the
    twin's result, ``hold(got, want)`` (raises on a mismatch: every launch
    choice of detect, SIC, both decoders and the int8 GEMM bit for bit,
    the fp32 / bf16 GEMMs and mha at the fp32 / bf16 gates, ls_che rtol
    1e-5), the candidates, the launch counter and the cache key (op,
    shape, extra) the wrapper's picker reads."""
    from repro_torch.kernels import quant

    gen = ofdm.make_generator(31, dev)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    cg = lambda *s: torch.complex(rnd(*s), rnd(*s))
    if op in ("te_gemm", "te_gemm_bf16", "te_gemm_softmax"):
        dtype = torch.bfloat16 if op == "te_gemm_bf16" else torch.float32
        m, k, n, epi = ((512, 64, 64, "softmax") if op == "te_gemm_softmax"
                        else (4096, 288, 32, "none"))
        x, w = rnd(m, k).to(dtype), (rnd(k, n) / math.sqrt(k)).to(dtype)
        rtol = _BF16_RTOL if dtype == torch.bfloat16 else 1e-4
        return dict(
            call=lambda c=None: te_gemm.te_gemm(x, w, epilogue=epi,
                                                choice=c),
            want=te_gemm.te_gemm_torch(x, w, epilogue=epi),
            hold=lambda g_, w_: _close(g_, w_, rtol),
            # a slab narrower than the softmax row splits it in two passes
            # (3 blocks an SM: the heuristic's at this shape)
            cands=([(b, 3) for b in te_gemm.SLABS] if epi == "softmax"
                   else te_gemm.block_shape_candidates(m, n, k, dtype)),
            counter="te_gemm",
            key=("te_gemm", (m, n, k), quant.dtype_name(dtype)))
    if op in ("te_gemm_int8", "te_gemm_fp8"):
        prec = op.rsplit("_", 1)[1]
        x, w = rnd(1024, 288), rnd(288, 32) / math.sqrt(288)
        dtype = quant.storage_dtype(prec)
        return dict(
            call=lambda c=None: te_gemm.te_gemm_quant(x, w, precision=prec,
                                                      choice=c),
            want=te_gemm.te_gemm_quant_torch(x, w, precision=prec),
            hold=(lambda g_, w_: _exact([g_], [w_])) if prec == "int8"
            else (lambda g_, w_: _close(g_, w_, 1e-4)),
            cands=te_gemm.block_shape_candidates(1024, 32, 288, dtype),
            counter="te_gemm_quant",
            key=("te_gemm", (1024, 32, 288), quant.dtype_name(dtype)))
    if op == "mha":
        q, k, v = rnd(16, 256, 64), rnd(16, 256, 64), rnd(16, 256, 64)
        return dict(
            call=lambda c=None: mha.mha(q, k, v, causal=True, choice=c),
            want=mha.mha_torch(q, k, v, causal=True),
            hold=lambda g_, w_: _close(g_, w_, 1e-4),
            cands=mha.cluster_candidates(16, 256, 256, 64, True),
            counter="mha", key=("mha", (16, 256, 256, 64), ""))
    if op in ("detect", "detect_8x4", "sic", "sic_8x6"):
        n_rx, n_tx, name = {"detect": (1, 1, "qam16"),
                            "detect_8x4": (8, 4, "qam64"),
                            "sic": (4, 4, "qam16"),
                            "sic_8x6": (8, 6, "qam16")}[op]
        y, h = cg(2, 14, 256, n_rx), cg(2, 256, n_rx, n_tx)
        nv, modem = torch.tensor(0.05, device=dev), ofdm.make_modem(name)
        sic = op.startswith("sic")
        kernel, twin = ((rx_fused.sic_detect_demap,
                         rx_fused.sic_detect_demap_torch) if sic else
                        (rx_fused.mmse_detect_demap,
                         rx_fused.mmse_detect_demap_torch))
        return dict(
            call=lambda c=None: kernel(y, h, nv, modem, choice=c),
            want=twin(y, h, nv, modem), hold=_exact,
            cands=rx_fused.subcarrier_tile_candidates(
                sic, n_rx, n_tx, modem.bits_per_symbol // 2),
            counter="sic_detect_demap" if sic else "mmse_detect_demap",
            key=("rx_sic_demap" if sic else "rx_detect_demap",
                 (14, 256, n_rx, n_tx, len(modem.levels)), ""))
    if op in ("ldpc", "ldpc_int8"):
        prec = "int8" if op == "ldpc_int8" else None
        code, llr = _code_llrs("r12", 64, 2.0, dev)
        return dict(
            call=lambda c=None: ldpc.ldpc_decode(llr, code, precision=prec,
                                                 choice=c),
            want=ldpc.ldpc_decode_torch(llr, code, precision=prec),
            hold=_exact, cands=ldpc.segment_candidates(code),
            counter="ldpc_decode_q" if prec else "ldpc_decode",
            key=("ldpc_decode", (code.k_b, code.m_b, code.z, 12), ""))
    scn = scenarios.get_scenario({"ls_che": "siso-qam16-r12-snr15",
                                  "ls_che_2x2": "mimo2x2-qam16-r12-snr17"}[op])
    g = scn.grid
    slot = scn.make_batch(ofdm.make_generator(4, dev), 8)
    y = torch.fft.fft(slot["y_time"], dim=2).contiguous()
    opr = torch.from_numpy(rx_fused.make_ls_interp_operator(
        g.n_subcarriers, g.n_tx, g.pilot_stride,
        ofdm.pilot_sequence_np(g))).to(dev)
    args = (y, g.pilot_symbols, g.pilot_stride, opr)
    return dict(
        call=lambda c=None: rx_fused.ls_che(*args, choice=c),
        want=rx_fused.ls_che_torch(*args),
        hold=lambda g_, w_: torch.testing.assert_close(g_, w_, rtol=1e-5,
                                                       atol=1e-6),
        cands=rx_fused.threads_per_output_candidates(8 * g.n_rx),
        counter="ls_che",
        key=("rx_ls_che", (g.n_subcarriers, g.n_rx, g.n_tx, opr.shape[1]),
             ""))


_TUNED = ["te_gemm", "te_gemm_bf16", "te_gemm_softmax", "te_gemm_int8",
          "te_gemm_fp8", "mha", "detect", "detect_8x4", "sic", "sic_8x6",
          "ldpc", "ldpc_int8", "ls_che", "ls_che_2x2"]


@pytest.mark.parametrize("op", _TUNED)
def test_every_launch_choice_matches_twin(dev, op):
    t = _tune_operands(op, dev)
    assert len(t["cands"]) >= 2
    for c in t["cands"]:
        got = t["call"](c)
        torch.cuda.synchronize()
        assert _build.launch_choices[t["counter"]] == c
        t["hold"](got, t["want"])


@pytest.mark.parametrize("op", _TUNED)
def test_stored_winner_is_what_the_wrapper_launches(dev, op, tmp_path):
    from repro_torch.kernels import tune

    t = _tune_operands(op, dev)
    name, shape, extra = t["key"]
    tune.set_cache_path(str(tmp_path / "tune.json"))
    try:
        t["call"]()
        heuristic = _build.launch_choices[t["counter"]]
        assert heuristic in t["cands"]
        other = next(c for c in t["cands"] if c != heuristic)
        for c in (other, heuristic):
            tune.get_cache().store(tune.cache_key(name, shape, extra,
                                                  backend="cuda"), c, 1.0)
            got = t["call"]()
            torch.cuda.synchronize()
            assert _build.launch_choices[t["counter"]] == c, (op, c)
            t["hold"](got, t["want"])
        # the tuner itself, on the card: a winner among the candidates,
        # persisted under cuda and launched by the wrapper
        timings = {}
        winner = tune.autotune(name, shape, t["cands"], t["call"], iters=2,
                               extra=extra, backend="cuda", timings=timings)
        assert set(timings) == set(t["cands"]) and winner in t["cands"]
        t["call"]()
        assert _build.launch_choices[t["counter"]] == winner
    finally:
        tune.set_cache_path(None)


def test_impossible_explicit_choice_raises_on_card(dev):
    """The kernels refuse a launch choice they have no instance for
    (cudaErrorInvalidValue), and the wrapper raises: never a silent
    fallback to another choice."""
    for op, bads in (("te_gemm", [(12, 2), (16, 0), (16, 5)]),
                     ("te_gemm_int8", [(48,)]),
                     ("mha", [(3,), (16,)]),
                     ("detect", [(64,), (12,)]),
                     ("sic", [(4,)]),
                     ("ldpc", [(4,), (32,)]),  # r12's widest layer: 5
                     ("ls_che", [(3,)])):
        call = _tune_operands(op, dev)["call"]
        for bad in bads:
            with pytest.raises(RuntimeError, match="cudaError_t"):
                call(bad)
    # a tile the route does not compile, a cluster past the key tiles, two
    # threads an output past 16 rows, a slab narrower than a quantized
    # softmax row
    gen = ofdm.make_generator(5, dev)
    cg = lambda *s: torch.complex(torch.randn(*s, generator=gen, device=dev),
                                  torch.randn(*s, generator=gen, device=dev))
    with pytest.raises(RuntimeError, match="cudaError_t"):
        rx_fused.mmse_detect_demap(cg(1, 14, 64, 4), cg(1, 64, 4, 4),
                                   torch.tensor(0.1, device=dev),
                                   ofdm.make_modem("qam16"), choice=(8,))
    q = torch.randn(2, 64, 16, device=dev)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        mha.mha(q, q, q, choice=(2,))
    with pytest.raises(RuntimeError, match="cudaError_t"):
        rx_fused.ls_che(cg(8, 14, 64, 4), (2, 11), 2,
                        torch.zeros(1, 32, 64, dtype=torch.complex64,
                                    device=dev), choice=(2,))
    x = torch.randn(64, 32, device=dev)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        te_gemm.te_gemm_quant(x, torch.randn(32, 200, device=dev),
                              epilogue="softmax", choice=(128,))


# -- the LM model zoo (plain torch) on the card against the CPU --------------

# |card - cpu| <= 1e-4 |cpu| + 5e-5 x max |cpu|: chip_smoke.py phase 8's
# card-against-CPU tolerance (the card's exp / rsqrt differ by an ulp)
_LM_ARCHS = ("llama3-8b", "moonshot-v1-16b-a3b", "zamba2-7b")


def _lm_close(got, want, what):
    g, w = got.float().cpu(), want.float()
    scale = float(w.abs().max()) or 1.0
    err = (g - w).abs()
    assert bool((err <= 1e-4 * w.abs() + 5e-5 * scale).all()), \
        (what, float(err.max()), scale)


@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_smoke_model_on_card_matches_cpu(dev, arch):
    """A dense, a MoE and a recurrent smoke config: forward, prefill and
    two decode steps (logits and every cache leaf) on the card against
    the CPU on the same weights and tokens, no kernel of ours launched,
    and each decode step free of host syncs."""
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.models import get_model

    m = get_model(get_smoke_config(arch))
    gen = torch.Generator().manual_seed(0)
    p_cpu = m.init(gen)
    batch = m.make_inputs(gen, ShapeConfig("lm", 17, 2, "prefill"))
    toks = torch.randint(0, m.cfg.vocab_size, (2, 2, 1), generator=gen)
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)

    def run(params, device):
        b = {k: v.to(device) for k, v in batch.items()}
        out = [m.forward(params, b)[0]]
        logits, cache = m.prefill(params, b, m.init_cache(2, 32,
                                                          device=device))
        out += [logits] + [cache[k].clone() for k in sorted(cache)]
        for t in toks:
            t = t.to(device)
            if device != "cpu":
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = m.decode_step(params, t, cache)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            out += [logits] + [cache[k].clone() for k in sorted(cache)]
        return out

    _build.reset_launches()
    with torch.no_grad():
        want, got = run(p_cpu, "cpu"), run(p_dev, dev)
    assert not +_build.launches
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        _lm_close(g, w, (arch, i))


# -- LM serving (the captured decode step) and training on the card ----------

_LM_FAMILIES = ("qwen1.5-0.5b", "pixtral-12b", "moonshot-v1-16b-a3b",
                "zamba2-7b", "rwkv6-1.6b", "whisper-tiny")


def _eager_greedy(m, params, prompts, max_new, max_len, dev):
    """The reference engine's batch, eagerly: left-padded prompts, zero
    stub embeddings, prefill, then ``max_new`` decode steps; (max_new, B)
    tokens."""
    cfg = m.cfg
    b = prompts.shape[0]
    batch = {"tokens": prompts.to(dev)}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.zeros(
            (b, cfg.enc_ctx, cfg.d_model), dtype=cfg.dtype(), device=dev)
    elif cfg.family == "vlm":
        batch["image_embeds"] = torch.zeros(
            (b, cfg.num_image_tokens, 1024), dtype=cfg.dtype(), device=dev)
    logits, cache = m.prefill(params, batch, m.init_cache(b, max_len,
                                                          device=dev))
    tok = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    out = []
    for _ in range(max_new):
        out.append(tok[:, 0].clone())
        logits, cache = m.decode_step(params, tok, cache)
        tok = torch.argmax(logits[:, -1, :], -1)[:, None].to(torch.int32)
    return torch.stack(out).cpu()


@pytest.mark.parametrize("arch", _LM_FAMILIES)
def test_lm_captured_decode_matches_eager_loop(dev, arch):
    """One smoke config a family: ``ServeEngine`` on the card (decode as
    one CUDA graph, captured once) gives the eager greedy loop's tokens
    for two batches, one padded; one replay a decode step."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    m = get_model(get_smoke_config(arch))
    params = tree_map(lambda t: t.to(dev),
                      m.init(torch.Generator().manual_seed(0)))
    max_len = 48 + (m.cfg.num_image_tokens if m.cfg.family == "vlm" else 0)
    rng = np.random.default_rng(1)
    reqs = [Request(rng.integers(0, m.cfg.vocab_size, size=(
        int(rng.integers(3, 12)),)).astype(np.int32), 6) for _ in range(6)]
    eng = ServeEngine(m, params, batch_size=4, max_len=max_len, device=dev)
    _build.reset_launches()
    with torch.no_grad():
        eng.generate(reqs)
        for i in (0, 4):
            part = reqs[i:i + 4]
            plen = max(len(r.prompt) for r in part)
            prompts = torch.zeros((4, plen), dtype=torch.int32)
            for j, r in enumerate(part):
                prompts[j, plen - len(r.prompt):] = torch.from_numpy(r.prompt)
            want = _eager_greedy(m, params, prompts, 6, max_len, dev)
            for j, r in enumerate(part):
                assert r.out_tokens == want[:, j].tolist(), (arch, i + j)
    assert not +_build.launches
    assert eng.decoder.graph is not None
    assert eng.captures == 1 and eng.replays == eng.decoder.replays == 12


def test_lm_train_step_on_card_matches_cpu(dev):
    """One smoke train step (4 microbatches, fp32) on the card against the
    same step on the CPU, same state and batch: loss and metrics at rtol
    1e-5 (the gradient norm 1e-4), parameters at rtol 2e-4 / atol 2e-5."""
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.models import get_model
    from repro_torch.train import init_state, make_train_step

    m = get_model(get_smoke_config("smollm-360m"))
    state = init_state(m, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in TokenStream(
        m.cfg.vocab_size, 8, 32).batch_at(0).items()}
    # the default warmup keeps step 1's lr at 3e-6: a gradient near 0
    # whose sign differs moves its parameter by at most 2 lr
    step = make_train_step(m, TrainConfig(microbatches=4))
    want, wm = step(state, batch)
    on_dev = lambda t: tree_map(lambda x: x.to(dev), t)
    _build.reset_launches()
    got, gm = step(on_dev(state), on_dev(batch))
    assert not +_build.launches
    for k in wm:
        rel = 1e-4 if k == "grad_norm" else 1e-5
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=rel), k
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=2e-5)


@pytest.fixture
def nccl_mesh(dev):
    """A one-rank NCCL group (an in-memory store, no socket) and the
    ``(1, 1)`` host mesh on it; the group is torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


def test_sharded_trainer_on_one_rank_mesh_matches_unsharded(dev, nccl_mesh):
    """smollm-360m's smoke config, one state carried into both: 3 steps
    of the sharded ``Trainer`` (state placed by the rules, the step under
    the activation mesh) equal the unsharded ``Trainer``'s losses and
    parameters (fp32, rtol 1e-6); no hand-written kernel launches."""
    from repro_torch.configs import TrainConfig, get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import get_model
    from repro_torch.train import Trainer, init_state

    m = get_model(get_smoke_config("smollm-360m"))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1)
    stream = TokenStream(m.cfg.vocab_size, 8, 32, seed=0)
    state = init_state(m, torch.Generator(device=dev).manual_seed(0))
    quiet = lambda *a, **k: None
    pshard = shd.param_shardings(m, nccl_mesh)
    ssh = {"params": pshard, "opt": shd.opt_state_shardings(pshard, nccl_mesh)}
    _build.reset_launches()
    want, _, wh = Trainer(m, tc, stream, device=dev).run(
        tree_map(torch.clone, state), 0, 3, log_fn=quiet)
    tr = Trainer(m, tc, stream, mesh=nccl_mesh, state_shardings=ssh,
                 device=dev)
    got, _, gh = tr.run(shd.distribute(state, ssh), 0, 3, log_fn=quiet)
    assert not +_build.launches
    for g, w in zip(gh, wh):
        assert float(g["loss"]) == pytest.approx(float(w["loss"]), rel=1e-6)
    for g, w in zip(tree_leaves(shd.full_tensor(got)), tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["llama3-8b", "pixtral-12b",
                                  "moonshot-v1-16b-a3b", "zamba2-7b",
                                  "rwkv6-1.6b", "whisper-tiny"])
def test_sharded_engine_on_one_rank_mesh_matches_unsharded(dev, nccl_mesh,
                                                           arch):
    """``ServeEngine`` with ``cache_shardings`` on the one-rank mesh: the
    decode step still one CUDA graph, tokens equal the unsharded
    engine's (one smoke config a family)."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    m = get_model(get_smoke_config(arch))
    params = m.init(torch.Generator(device=dev).manual_seed(0))
    max_len = 48 + (m.cfg.num_image_tokens if m.cfg.family == "vlm" else 0)
    rng = np.random.default_rng(0)
    batch = [Request(rng.integers(0, m.cfg.vocab_size, 5 + i).astype(
        np.int32), 6) for i in range(3)]
    plain = ServeEngine(m, params, 2, max_len, device=dev).generate(
        [Request(r.prompt, 6) for r in batch])
    cache = m.init_cache(2, max_len, device="meta")
    eng = ServeEngine(m, params, 2, max_len, device=dev,
                      cache_shardings=shd.cache_shardings(m.cfg, cache,
                                                          nccl_mesh))
    got = eng.generate([Request(r.prompt, 6) for r in batch])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in plain]
    assert eng.decoder.graph is not None and eng.captures == 1
    assert type(eng.decoder.static["pos"]).__name__ == "DTensor"
