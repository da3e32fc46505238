"""Port vs reference: training CE-ViT (``repro_torch.train.neural_receiver``,
the port of ``examples/train_neural_receiver.py``) and the gradients of
the two kernels it runs.

* **Backward of each kernel wrapper.**  ``te_gemm`` (every epilogue, with
  and without bias, fp32 and bf16) and ``mha`` (causal and full) under
  grad run in ``TeGemmFunction`` / ``MhaFunction``; their explicit
  backward is held to autograd through the plain twins: rtol 1e-5 (atol
  1e-6 of the largest |grad|) at fp32, one bf16 rounding step at bf16.
* **One step.**  The loss and every gradient leaf against
  ``jax.value_and_grad`` of the reference loss (``cevit_apply`` on its
  jnp path) on the reference's weights (``cevit_params_from_numpy``) and
  a JAX-drawn batch: loss rtol 1e-5, leaves rtol 1e-4 / atol 1e-6 of the
  leaf's largest |grad|.
* **Five steps.**  ``train`` against the reference's clipped momentum
  step, written here as the example writes it, on the same batches:
  losses rtol 1e-4.  The trained weights carried back
  (``params_to_numpy``) give the reference's ``cevit_apply`` the port's
  loss.
* **Learning.**  The port's own 250-step run beats LS, as the
  reference's ``tests/test_phy.py::test_cevit_learns_to_beat_ls`` does.

All at the reference test's size: 64 subcarriers, d_model 32, 2 heads,
2 layers, d_ff 64, patch 4, batch 32, 0 dB.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.phy import classical as ref_classical
from repro.phy import models as ref_models
from repro.phy import ofdm as ref_ofdm
from repro_torch.common.params import params_to_numpy, tree_leaves
from repro_torch.kernels import mha, te_gemm
from repro_torch.optim import adamw
from repro_torch.phy import models, ofdm
from repro_torch.train import neural_receiver as nr
from _port_share import port_share  # noqa: F401

GRID = dict(n_subcarriers=64, fft_size=64, pilot_stride=4)
CFG = dict(d_model=32, heads=2, layers=2, d_ff=64, patch=4)
RG, PG = ref_ofdm.GridConfig(**GRID), ofdm.GridConfig(**GRID)
RM, PM = ref_models.CEViTConfig(**CFG), models.CEViTConfig(**CFG)
BATCH = 32
_BF16_RTOL = 2.0 ** -7
_ref_slot = jax.jit(ref_ofdm.make_slot, static_argnums=(1, 2, 3))


@pytest.fixture
def one_thread():
    """Run torch on one intra-op thread: the training loops are thousands
    of small ops, which several test workers each spreading over every
    core slow by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the kernels' backward
# ---------------------------------------------------------------------------

def _assert_grads_close(got, want, dtype):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        top = float(b.abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * top)
        else:
            torch.testing.assert_close(a, b, rtol=_BF16_RTOL,
                                       atol=_BF16_RTOL * top)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("has_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("epilogue", te_gemm.EPILOGUES)
def test_te_gemm_backward_matches_autograd_of_twin(epilogue, has_bias,
                                                    dtype):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(37, 24, generator=gen).to(dtype).requires_grad_()
    w = (torch.randn(24, 70, generator=gen) / 5).to(dtype).requires_grad_()
    b = ((0.1 * torch.randn(70, generator=gen)).to(dtype).requires_grad_()
         if has_bias else None)
    g = torch.randn(37, 70, generator=gen).to(dtype)
    ins = [t for t in (x, w, b) if t is not None]
    out = te_gemm.te_gemm(x, w, b, epilogue=epilogue)
    assert type(out.grad_fn).__name__ == "TeGemmFunctionBackward"
    want = torch.autograd.grad(
        te_gemm.te_gemm_torch(x, w, b, epilogue=epilogue), ins, g)
    _assert_grads_close(torch.autograd.grad(out, ins, g), want, dtype)
    # only the operands that require grad get one
    out = te_gemm.te_gemm(x.detach(), w, b, epilogue=epilogue)
    (gw,) = torch.autograd.grad(out, [w], g)
    _assert_grads_close([gw], want[1:2], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_mha_backward_matches_autograd_of_twin(causal, dtype):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(6, 9, 16, generator=gen).to(dtype).requires_grad_()
    k, v = (torch.randn(6, 13, 16, generator=gen).to(dtype).requires_grad_()
            for _ in range(2))
    g = torch.randn(6, 9, 16, generator=gen).to(dtype)
    out = mha.mha(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "MhaFunctionBackward"
    want = torch.autograd.grad(mha.mha_torch(q, k, v, causal=causal),
                               (q, k, v), g)
    _assert_grads_close(torch.autograd.grad(out, (q, k, v), g), want, dtype)


def test_wrappers_take_the_plain_route_without_grad():
    x, w = torch.randn(8, 4), torch.randn(4, 3, requires_grad=True)
    with torch.no_grad():
        assert te_gemm.te_gemm(x, w).grad_fn is None
    assert te_gemm.te_gemm(x, w.detach()).grad_fn is None
    q = torch.randn(2, 5, 8)
    assert mha.mha(q, q, q).grad_fn is None


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(0)
    tree = {"b": [rng.standard_normal((3, 4)).astype(np.float32)],
            "a": rng.standard_normal(5).astype(np.float32)}
    for max_norm in (1.0, 100.0):
        want, wnorm = ref_adamw.clip_by_global_norm(tree, max_norm)
        got, norm = adamw.clip_by_global_norm(
            {"b": [torch.from_numpy(tree["b"][0])],
             "a": torch.from_numpy(tree["a"])}, max_norm)
        assert float(norm) == pytest.approx(float(wnorm), rel=1e-6)
        np.testing.assert_allclose(got["a"].numpy(), want["a"], rtol=1e-6)
        np.testing.assert_allclose(got["b"][0].numpy(), want["b"][0],
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# training against the reference
# ---------------------------------------------------------------------------

def _ref_loss(p, slot):
    """The example's loss on the reference's jnp path (noise variance 1.0
    in the features, as at 0 dB)."""
    pilot_sc = jnp.any(ref_ofdm.pilot_mask(RG), axis=0)
    h_ls = ref_classical.ls_channel_estimate(
        slot["y"], slot["pilots"], slot["pilot_mask"], RG.pilot_stride)
    feats = ref_models.cevit_features(h_ls, pilot_sc, 1.0)
    h_hat = ref_models.cevit_apply(p, RM, feats)
    return jnp.mean(jnp.abs(h_hat - slot["h"]) ** 2)


@jax.jit
def _ref_step(p, mom, slot):
    """The example's step: clip to norm 1.0, momentum 0.9, lr 0.01."""
    loss, g = jax.value_and_grad(_ref_loss)(p, slot)
    g, _ = ref_adamw.clip_by_global_norm(g, 1.0)
    mom = jax.tree.map(lambda m, gr: 0.9 * m + gr, mom, g)
    p = jax.tree.map(lambda w, m: w - 0.01 * m, p, mom)
    return p, mom, loss


def _ref_tree():
    return jax.tree.map(np.asarray,
                        ref_models.init_cevit(jax.random.PRNGKey(0), RM))


def _slots(n, seed=1):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return [{k: np.asarray(v) for k, v in _ref_slot(key, RG, BATCH,
                                                    0.0).items()}
            for key in keys]


def _port_loss(params, slot):
    feats, h_true, _ = nr.make_batch(
        ofdm.slot_from_numpy(slot, "cpu"), PG,
        nr.pilot_subcarriers(PG, "cpu"), 1.0)
    return nr.loss_fn(params, PM, feats, h_true)


def test_one_step_loss_and_gradients_match_reference(one_thread):
    tree = _ref_tree()
    (slot,) = _slots(1)
    want_loss, want_g = jax.jit(jax.value_and_grad(_ref_loss))(tree, slot)
    params = models.cevit_params_from_numpy(tree, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = _port_loss(params, slot)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(grads)
    for got, want in zip(grads, want_leaves):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def five_steps():
    """Five steps of each package on the same batches from the same
    weights: (reference losses, port losses, the port's trained params,
    a sixth batch)."""
    tree = _ref_tree()
    slots = _slots(6)
    p, mom, ref_losses = tree, jax.tree.map(jnp.zeros_like, tree), []
    for slot in slots[:5]:
        p, mom, loss = _ref_step(p, mom, slot)
        ref_losses.append(float(loss))
    params = models.cevit_params_from_numpy(tree, "cpu")
    losses = nr.train(params, PM, 5,
                      lambda i: ofdm.slot_from_numpy(slots[i], "cpu"),
                      gcfg=PG, nv=1.0)
    return np.asarray(ref_losses), losses.numpy(), params, slots[5]


def test_five_steps_match_reference(one_thread, five_steps):
    ref_losses, losses, params, _ = five_steps
    assert losses.shape == (5,)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert all(not p.requires_grad for p in tree_leaves(params))


def test_trained_weights_carry_back_to_reference(five_steps):
    _, _, params, slot = five_steps
    tree = params_to_numpy(params)
    assert all(isinstance(x, np.ndarray) for x in jax.tree.leaves(tree))
    with torch.no_grad():
        loss = float(_port_loss(params, slot))
    want = float(jax.jit(_ref_loss)(tree, slot))
    assert loss == pytest.approx(want, rel=1e-5)
    back = models.cevit_params_from_numpy(tree, "cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)


def test_port_training_beats_ls(one_thread):
    """The reference test's criterion on the port's own draws: 250 steps,
    then a held-out batch where CE-ViT's MSE is below LS's."""
    gen = ofdm.make_generator(0, "cpu")
    params = models.init_cevit(gen, PM)
    losses = nr.train(params, PM, 250,
                      lambda i: ofdm.make_slot(gen, PG, BATCH, 0.0),
                      gcfg=PG, nv=1.0)
    assert bool(torch.isfinite(losses).all())
    held_out = ofdm.make_slot(ofdm.make_generator(999, "cpu"), PG, BATCH,
                              0.0)
    mse = nr.evaluate(params, PM, held_out, gcfg=PG, nv=1.0)
    assert mse["cevit"] < mse["ls"], mse
    assert float(losses[-10:].mean()) < float(losses[:10].mean())


def test_trainer_main_defaults_to_cuda_and_runs_on_cpu(one_thread, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            nr.main(["--steps", "1"])
    assert nr.main(["--steps", "2", "--batch", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "trained 2 steps" in out and "CE-ViT (learned)" in out
